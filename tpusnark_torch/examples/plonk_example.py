"""PLONK example: the cubic circuit over the Plonkish constraint system
(gnark/examples/plonk/main.go:30-40), over BN254 on the card unless the
caller names the CPU (the counterpart of examples/plonk_example.py).
Run: python3 -m tpusnark_torch.examples.plonk_example
"""

from __future__ import annotations

from ..backend import plonk
from ..fields.spec import BN254_FR
from ..frontend.plonk_builder import PlonkBuilder

P = BN254_FR.modulus
ASSIGNMENT = {"x": 3, "y": 35}


def compile_circuit():
    b = PlonkBuilder(P)
    x = b.secret("x")
    y = b.public("y")
    x3 = b.mul(x, x, x)
    b.assert_is_equal(b.add(x3, x, 5), y)
    return b.compile()


def main(device="cuda", tau=None, rng=None):
    """Setup (an unsafe SRS from `tau`, random without one), prove and
    verify on `device`; rng: callable -> int for the prover's blinding.
    Returns (cs, pk, vk, proof, public inputs)."""
    cs = compile_circuit()
    pk, vk = plonk.setup(cs, tau=tau, device=device)
    proof = plonk.prove(cs, pk, ASSIGNMENT, rng=rng)
    pubs = [ASSIGNMENT["y"]]
    assert plonk.verify(proof, vk, pubs)
    print("plonk: proof verified")
    return cs, pk, vk, proof, pubs


if __name__ == "__main__":
    main()
