"""MiMC preimage circuit: prove knowledge of m with MiMC(m) == h
(gnark/examples/mimc/mimc.go), Groth16 over BN254 on the card unless the
caller names the CPU (the counterpart of examples/mimc.py).
Run: python3 -m tpusnark_torch.examples.mimc
"""

from __future__ import annotations

from ..backend import groth16
from ..fields.spec import BN254_FR
from ..frontend.builder import Builder
from ..hashes.mimc import MiMCGadget, mimc_hash

P = BN254_FR.modulus
PRE_IMAGE = 0xDEADF00D


def define(api):
    pre = api.secret("pre_image")
    h = api.public("hash")
    g = MiMCGadget(api)
    g.write(pre)
    api.assert_is_equal(g.sum(), h)


def compile_circuit():
    b = Builder(P)
    define(b)
    return b.compile()


def main(device="cuda", rng=None):
    """Setup, prove and verify on `device` (rng as in cubic.main); returns
    (cs, pk, vk, proof, public inputs)."""
    cs = compile_circuit()
    assign = {"pre_image": PRE_IMAGE, "hash": mimc_hash([PRE_IMAGE])}
    pk, vk = groth16.setup(cs, rng=rng, device=device)
    proof = groth16.prove(cs, pk, assign, rng=rng, device=device)
    pubs = [assign["hash"]]
    assert groth16.verify(proof, vk, pubs)
    print("mimc: groth16 proof verified")
    return cs, pk, vk, proof, pubs


if __name__ == "__main__":
    main()
