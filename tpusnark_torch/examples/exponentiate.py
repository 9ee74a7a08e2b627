"""Exponentiation circuit: y == x**e with e a small secret exponent proven
bit by bit (gnark/examples/exponentiate/exponentiate.go), Groth16 over
BN254 on the card unless the caller names the CPU (the counterpart of
examples/exponentiate.py). Run: python3 -m tpusnark_torch.examples.exponentiate
"""

from __future__ import annotations

from ..backend import groth16
from ..fields.spec import BN254_FR
from ..frontend.builder import Builder

P = BN254_FR.modulus
BITSIZE = 8
ASSIGNMENT = {"x": 2, "e": 12, "y": 4096}


def define(api):
    x = api.public("x")
    e = api.secret("e")
    y = api.public("y")
    bits = api.to_binary(e, BITSIZE)
    output = 1
    for i in range(BITSIZE - 1, -1, -1):
        if i != BITSIZE - 1:
            output = api.mul(output, output)
        multiply = api.mul(output, x)
        output = api.select(bits[i], multiply, output)
    api.assert_is_equal(y, output)


def compile_circuit():
    b = Builder(P)
    define(b)
    return b.compile()


def main(device="cuda", rng=None):
    """Setup, prove and verify on `device` (rng as in cubic.main); returns
    (cs, pk, vk, proof, public inputs)."""
    cs = compile_circuit()
    pk, vk = groth16.setup(cs, rng=rng, device=device)
    proof = groth16.prove(cs, pk, ASSIGNMENT, rng=rng, device=device)
    pubs = [ASSIGNMENT["x"], ASSIGNMENT["y"]]
    assert groth16.verify(proof, vk, pubs)
    print("exponentiate: groth16 proof verified")
    return cs, pk, vk, proof, pubs


if __name__ == "__main__":
    main()
