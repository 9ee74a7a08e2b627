"""Groth16 verifier on the host (the port's copy of
tpusnark/backend/groth16/verify.py; pairings are not performance-critical).

Checks the Groth16 equation
    e(Ar, Bs) = e(alpha, beta) * e(kSum, gamma) * e(Krs, delta)
as a single product of Miller loops with one shared final exponentiation,
like the reference verifier (gnark/backend/groth16/bn254/verify.go:43-141),
with the BSB22 commitment sections over BN254.
"""

from __future__ import annotations

from ...curves import ref
from ...curves.marshal import g1_raw
from ...curves.pedersen import pedersen_fold_commitments
from ...curves.ref import G1, G2, pairing_check
from ...utils.hash_to_field import COMMITMENT_DST, hash_to_field
from .keys import Proof, VerifyingKey


class InvalidProofError(Exception):
    pass


def verify(
    proof: Proof, vk: VerifyingKey, public_inputs: list[int], curve: str = "bn254"
) -> bool:
    """public_inputs: values of the public wires EXCLUDING the constant-one
    wire (gnark convention: witness.Public()).

    curve: any CurveConfig name — the pairing check dispatches to that
    curve's host module (reference curve switch groth16.go:113). BSB22
    commitment sections are BN254-only (mirrors setup's assertion)."""
    if curve != "bn254":
        return _verify_any(proof, vk, public_inputs, curve)
    p = ref.R
    pubs = [1] + [int(x) % p for x in public_inputs]
    n_com = len(vk.public_and_commitment_committed)
    if len(pubs) + n_com != len(vk.k):
        raise InvalidProofError(
            f"wrong number of public inputs: got {len(pubs) - 1}, "
            f"want {len(vk.k) - 1 - n_com}"
        )
    for pt in (proof.ar, proof.krs):
        if not G1.on_curve(pt):
            raise InvalidProofError("proof point not on curve")
    # Full subgroup check on Bs, even for in-memory proof objects: BN254 G2
    # cofactor != 1, and the reference checks inside Verify itself
    # (gnark/backend/groth16/bn254/verify.go:61), not only at decode.
    if not G2.in_subgroup(proof.bs):
        raise InvalidProofError("proof point not in G2 subgroup")

    # BSB22 (gnark verify.go:76-108): recompute each commitment's challenge
    # from the proof's commitment point and the committed public values,
    # extend the public witness with it, then verify the folded Pedersen PoK.
    if n_com:
        if len(proof.commitments) != n_com or proof.commitment_pok is None:
            raise InvalidProofError("proof missing BSB22 commitment sections")
        for i, idxs in enumerate(vk.public_and_commitment_committed):
            C = proof.commitments[i]
            if C is not None and not G1.on_curve(C):
                raise InvalidProofError("commitment point not on curve")
            msg = g1_raw(C) + b"".join(
                int(pubs[j]).to_bytes(32, "big") for j in idxs
            )
            pubs.append(hash_to_field(msg, COMMITMENT_DST, p)[0])
        seeds = b"".join(int(v).to_bytes(32, "big") for v in pubs[-n_com:])
        folded = pedersen_fold_commitments(proof.commitments, seeds)
        if not vk.commitment_key.verify(folded, proof.commitment_pok):
            raise InvalidProofError("BSB22 commitment PoK verification failed")

    ksum = None
    for w, pt in zip(pubs, vk.k):
        if pt is None or w == 0:
            continue
        ksum = G1.add(ksum, G1.mul(pt, w))
    # commitments fold into the public-input sum (reference verify.go:117-119)
    for C in proof.commitments:
        ksum = G1.add(ksum, C)

    # e(-Ar,Bs) * e(alpha,beta) * e(kSum,gamma) * e(Krs,delta) == 1
    return pairing_check(
        [
            (G1.neg(proof.ar), proof.bs),
            (vk.alpha_g1, vk.beta_g2),
            (ksum, vk.gamma_g2),
            (proof.krs, vk.delta_g2),
        ]
    )


def _verify_any(proof, vk, public_inputs, curve: str) -> bool:
    """Curve-generic Groth16 pairing check over the host module of `curve`
    (handles both Fp2 G2 (BLS12) and Fp G2 (BW6-761) coordinates)."""
    from ...curves.config import get_curve

    host = get_curve(curve).host
    G1h, G2h = host.G1, host.G2
    p = host.R
    pubs = [1] + [int(x) % p for x in public_inputs]
    if len(pubs) != len(vk.k):
        raise InvalidProofError(
            f"wrong number of public inputs: got {len(pubs) - 1}, "
            f"want {len(vk.k) - 1}"
        )
    # Full on-curve + r-order subgroup discipline on every proof point
    # (reference rejects out-of-subgroup points at unmarshal; BLS12-377 G1
    # has cofactor (x-1)^2/3 > 1, so on-curve alone is NOT enough for
    # ar/krs there).
    for pt in (proof.ar, proof.krs):
        if not G1h.is_on_curve(pt):
            raise InvalidProofError("proof point not on curve")
        if not G1h.in_subgroup(pt):
            raise InvalidProofError("proof point not in G1 subgroup")
    if not G2h.is_on_curve(proof.bs):
        raise InvalidProofError("proof point not on curve")
    if not G2h.in_subgroup(proof.bs):
        raise InvalidProofError("proof point not in G2 subgroup")
    ksum = None
    for w, pt in zip(pubs, vk.k):
        if pt is None or w == 0:
            continue
        ksum = G1h.add(ksum, G1h.mul(pt, w))
    return host.multi_pairing(
        [
            (G1h.neg(proof.ar), proof.bs),
            (vk.alpha_g1, vk.beta_g2),
            (ksum, vk.gamma_g2),
            (proof.krs, vk.delta_g2),
        ]
    ).is_one()
