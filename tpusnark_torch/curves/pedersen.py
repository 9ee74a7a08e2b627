"""Pedersen vector commitments with proof of knowledge (BSB22).

Reference surface: gnark-crypto's `pedersen` package as used by Groth16
(gnark/backend/groth16/bn254/prove.go:95,134 pedersen.BatchProve;
verify.go:102-108 FoldCommitments + CommitmentKey.Verify; setup.go's
pedersen.Setup over the commitment-basis K points).

Scheme: setup samples sigma and publishes, per commitment, the basis and
sigma*basis (proving side), plus (g2, -sigma*g2) (verifying side).
  Commit(v)        C   = sum v_j * basis_j
  ProveKnowledge(v) pok = sum v_j * (sigma*basis_j)   (= sigma*C if honest)
  Verify(C, pok)    e(C, sigma*g2) == e(pok, g2)
Batches fold with powers of a hash-derived challenge over the serialized
commitment values, mirroring the prove/verify symmetry in the reference.

Host-side reference implementation (python ints): commitment bases are tiny
compared to the proof MSMs; device offload can reuse the Pippenger engine
later without changing this interface.

The port's copy of tpusnark/curves/pedersen.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.hash_to_field import COMMITMENT_DST, hash_to_field
from . import ref
from .ref import G1, G2


@dataclass
class PedersenProvingKey:
    basis: list  # G1 affine tuples
    basis_exp_sigma: list  # sigma * basis


@dataclass
class PedersenVerifyingKey:
    g2: tuple
    g2_sigma_neg: tuple  # -sigma * g2

    def verify(self, commitment, pok) -> bool:
        """e(C, sigma*g2) * e(pok, -g2) == 1  <=>  pok == sigma*C."""
        if commitment is None or pok is None:
            # sigma != 0, so sigma*C = O iff C = O
            return commitment is None and pok is None
        return ref.pairing_check(
            [
                (commitment, G2.neg(self.g2_sigma_neg)),
                (G1.neg(pok), self.g2),
            ]
        )


def pedersen_setup(bases: list[list], rand) -> tuple[list[PedersenProvingKey], PedersenVerifyingKey]:
    """bases: one G1 basis list per commitment; rand: () -> int in [1, r)."""
    sigma = rand()
    pks = [
        PedersenProvingKey(
            basis=list(b),
            basis_exp_sigma=[None if pt is None else G1.mul(pt, sigma) for pt in b],
        )
        for b in bases
    ]
    g2 = G2.generator()
    vk = PedersenVerifyingKey(g2=g2, g2_sigma_neg=G2.neg(G2.mul(g2, sigma)))
    return pks, vk


def pedersen_commit(pk: PedersenProvingKey, values: list[int]):
    acc = None
    for pt, v in zip(pk.basis, values):
        if pt is None or v % ref.R == 0:
            continue
        acc = G1.add(acc, G1.mul(pt, v))
    return acc


def _fold_challenge(commitment_seeds: bytes, n: int) -> list[int]:
    """Powers 1, r, r^2, ... of the fold challenge (prove/verify symmetric)."""
    if n == 1:
        return [1]
    (r,) = hash_to_field(commitment_seeds, COMMITMENT_DST + b"-fold", ref.R)
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * r % ref.R
    return out


def pedersen_batch_prove(
    pks: list[PedersenProvingKey], values: list[list[int]], commitment_seeds: bytes
):
    """Single folded PoK over all commitments (pedersen.BatchProve)."""
    rs = _fold_challenge(commitment_seeds, len(pks))
    acc = None
    for pk, vals, w in zip(pks, values, rs):
        for pt, v in zip(pk.basis_exp_sigma, vals):
            s = v * w % ref.R
            if pt is None or s == 0:
                continue
            acc = G1.add(acc, G1.mul(pt, s))
    return acc


def pedersen_fold_commitments(commitments: list, commitment_seeds: bytes):
    """Fold commitments with the same challenge powers (FoldCommitments)."""
    rs = _fold_challenge(commitment_seeds, len(commitments))
    acc = None
    for c, w in zip(commitments, rs):
        if c is None:
            continue
        acc = G1.add(acc, G1.mul(c, w))
    return acc
