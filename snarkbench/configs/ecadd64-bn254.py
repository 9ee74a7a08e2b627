"""The ECADD configuration's circuit and inputs: `calls` EIP-196 ECADD calls
over emulated BN254 Fp inside BN254's r, each as gnark's
std/evmprecompiles/06-bnadd.go builds it: R = AddUnified(P, Q), with no
on-curve check (the source leaves it to the zkEVM) and the identity as
(0, 0).

Call k takes P and Q as 4 + 4 secret 64-bit limbs (``px<k>_<i>``,
``py<k>_<i>``, ``qx<k>_<i>``, ``qy<k>_<i>``) and binds R's limbs to the
public ``rx<k>_<i>``, ``ry<k>_<i>``. ``define`` runs over the port's builder
and gadgets for the program and over the reference's frozen copies for the
check; ``inputs`` makes the batches from a seeded rng with the reference's
curve arithmetic."""

from __future__ import annotations

from snarkbench.reference.bn254 import G1, G1_GEN, P, R, g1_mul_jacobian

PROGRAM_GADGETS = "tpusnark_torch.gadgets.evmprecompiles"
REFERENCE_GADGETS = "snarkbench.reference.frontend.evm"
_INPUTS = ("px", "py", "qx", "qy")


def define(b, g, cfg) -> None:
    C = g.bn_g1(b, cfg["limb_bits"])
    F, k = C.F, C.F.pr.n_limbs
    for call in range(cfg["calls"]):
        ins = {c: [b.secret(f"{c}{call}_{i}") for i in range(k)] for c in _INPUTS}
        S, _ = g.ecadd(b, C, C.from_limbs(ins["px"], ins["py"]), C.from_limbs(ins["qx"], ins["qy"]))
        for name, v in (("rx", S.x), ("ry", S.y)):
            F.assert_is_equal(v, F.from_limbs([b.public(f"{name}{call}_{i}") for i in range(k)]))


def _limbs(v: int, bits: int) -> list[int]:
    return [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(-(-P.bit_length() // bits))]


def inputs(cfg, rng):
    """Batches without end, no two alike: every input and public value by
    name. Call c of batch k adds P_c + kG and Q_c + kG, from starts P_c, Q_c
    drawn as random multiples of G; call 1 doubles (Q = P) and call 2
    annihilates (Q = -P, R = (0, 0)). A batch after the first costs
    3 * `calls` affine additions."""
    starts = [[g1_mul_jacobian(G1_GEN, rng.randrange(1, R)) for _ in "pq"] for _ in range(cfg["calls"])]
    while True:
        out = {}
        for call, (p, q) in enumerate(starts):
            q = p if call == 1 else G1.neg(p) if call == 2 else q
            s = G1.add(p, q)
            for name, v in zip((*_INPUTS, "rx", "ry"), (*p, *q, *(s or (0, 0)))):
                out.update({f"{name}{call}_{i}": limb for i, limb in enumerate(_limbs(v, cfg["limb_bits"]))})
        yield out
        for pq in starts:
            pq[:] = [G1.add(pt, G1_GEN) for pt in pq]
