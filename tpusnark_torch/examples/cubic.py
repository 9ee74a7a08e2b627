"""Cubic circuit: prove knowledge of x with x**3 + x + 5 == y.

The gnark hello-world (gnark/examples/cubic/cubic.go), Groth16 over BN254,
on the card unless the caller names the CPU (the counterpart of
examples/cubic.py). Run: python3 -m tpusnark_torch.examples.cubic
"""

from __future__ import annotations

from ..backend import groth16
from ..fields.spec import BN254_FR
from ..frontend.builder import Builder

P = BN254_FR.modulus
ASSIGNMENT = {"x": 3, "y": 35}


def define(api, x=None, y=None):
    """Circuit body, usable with a Builder."""
    x = x if x is not None else api.secret("x")
    y = y if y is not None else api.public("y")
    x3 = api.mul(x, x, x)
    api.assert_is_equal(api.add(x3, x, 5), y)


def compile_circuit():
    b = Builder(P)
    define(b)
    return b.compile()


def main(device="cuda", rng=None):
    """Setup, prove and verify on `device`; rng: callable -> int in [1, r)
    for seeded keys and proof (secrets-based without one). Returns (cs, pk,
    vk, proof, public inputs)."""
    cs = compile_circuit()
    pk, vk = groth16.setup(cs, rng=rng, device=device)
    proof = groth16.prove(cs, pk, ASSIGNMENT, rng=rng, device=device)
    pubs = [ASSIGNMENT["y"]]
    assert groth16.verify(proof, vk, pubs)
    print("cubic: groth16 proof verified")
    return cs, pk, vk, proof, pubs


if __name__ == "__main__":
    main()
