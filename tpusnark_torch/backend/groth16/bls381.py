"""Groth16 over BLS12-381: verifier + gnark/bellman wire decoding.

Multi-curve instantiation of the Groth16 pairing check (reference curve
switch: gnark/backend/groth16/groth16.go:113 dispatching to
backend/groth16/bls12-381/verify.go; vk layout marshal.go "follows bellman
format": [α]1 [β]1 [β]2 [γ]2 [δ]1 [δ]2 u32|[Kvk]1, then
PublicAndCommitmentCommitted and the pedersen commitment key).

The decoder side doubles as the consumer of the reference's REAL interop
fixtures (gnark/backend/groth16/bellman_test.go:19): bellman-
produced BLS12-381 vk/proof/input vectors that gnark's own verifier accepts
— the only gnark-compatible golden bytes available offline.

The port's copy of tpusnark/backend/groth16/bls381.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ...curves import bls12381 as C
from ...curves.marshal_bls import g1_decode, g2_decode


@dataclass
class VerifyingKeyBLS:
    alpha_g1: tuple
    beta_g1: tuple | None
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple | None
    delta_g2: tuple
    k: list


@dataclass
class ProofBLS:
    ar: tuple
    bs: tuple
    krs: tuple


def vk_from_bytes(data: bytes) -> VerifyingKeyBLS:
    off = 0

    def dg1():
        nonlocal off
        pt, n = g1_decode(data[off:])
        off += n
        return pt

    def dg2():
        nonlocal off
        pt, n = g2_decode(data[off:])
        off += n
        return pt

    alpha = dg1()
    beta1 = dg1()
    beta2 = dg2()
    gamma2 = dg2()
    delta1 = dg1()
    delta2 = dg2()
    (nk,) = struct.unpack_from(">I", data, off)
    off += 4
    k = [dg1() for _ in range(nk)]
    return VerifyingKeyBLS(
        alpha_g1=alpha,
        beta_g1=beta1,
        beta_g2=beta2,
        gamma_g2=gamma2,
        delta_g1=delta1,
        delta_g2=delta2,
        k=k,
    )


def proof_from_bytes(data: bytes) -> ProofBLS:
    off = 0
    ar, n = g1_decode(data[off:])
    off += n
    bs, n = g2_decode(data[off:])
    off += n
    krs, n = g1_decode(data[off:])
    return ProofBLS(ar=ar, bs=bs, krs=krs)


def inputs_from_bytes(data: bytes) -> list[int]:
    assert len(data) % 32 == 0
    return [
        int.from_bytes(data[i : i + 32], "big") % C.R
        for i in range(0, len(data), 32)
    ]


def verify(proof: ProofBLS, vk: VerifyingKeyBLS, public_inputs: list[int]) -> bool:
    """e(Ar, Bs) == e(alpha, beta) * e(kSum, gamma) * e(Krs, delta), checked
    as a single pairing product (one shared final exponentiation), like the
    reference's twin Miller loops (verify.go:69-135)."""
    if len(public_inputs) + 1 != len(vk.k):
        return False
    ksum = vk.k[0]
    for w, pt in zip(public_inputs, vk.k[1:]):
        ksum = C.G1.add(ksum, C.G1.mul(pt, w))
    prod = C.multi_pairing(
        [
            (C.G1.neg(proof.ar), proof.bs),
            (vk.alpha_g1, vk.beta_g2),
            (ksum, vk.gamma_g2),
            (proof.krs, vk.delta_g2),
        ]
    )
    return prod.is_one()
