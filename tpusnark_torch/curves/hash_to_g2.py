"""Hash-to-G2 for BN254 (host side).

Used by the MPC trusted-setup ceremony to derive the proof-of-knowledge base
point R = HashToG2(sG1 || sxG1 || challenge, dst) whose discrete log must be
unknown to every participant (reference genR,
gnark/backend/groth16/bn254/mpcsetup/utils.go:159-170, which calls
gnark-crypto's curve.HashToG2).

Construction: RFC 9380 expand_message_xmd -> hash_to_field over Fp2 with a
per-attempt counter, try-and-increment onto the twist y^2 = x^3 + b', sign
selected by one hash bit, then cofactor clearing by [h2] with
h2 = p - 1 + t (BN sextic twist order / r). This is a valid random-oracle
point derivation; the byte mapping differs from gnark-crypto's SVDW
encoding, so ceremony transcripts are self-consistent rather than
gnark-interoperable (documented divergence).

The port's copy of tpusnark/curves/hash_to_g2.py: same code.
"""

from __future__ import annotations

from .ref import G2, P, Fp2
from .marshal import _g2_b, _sqrt_fp2
from ..utils.hash_to_field import expand_message_xmd

# #E'(Fp2) / r for BN254: p - 1 + t with t = 6x^2 + 1, x = 4965661367192848881
G2_COFACTOR = 21888242871839275222246405745257275088844257914179612981679871602714643921549


def _clear_cofactor(pt):
    """[h2]P without the mod-r scalar reduction of G2.mul (h2 > r)."""
    res, base, k = None, pt, G2_COFACTOR
    while k:
        if k & 1:
            res = G2.add(res, base)
        base = G2.double(base)
        k >>= 1
    return res


def hash_to_g2(msg: bytes, dst: bytes):
    """Deterministic map bytes -> G2 subgroup point (never the identity)."""
    b2 = _g2_b()
    for ctr in range(256):
        block = expand_message_xmd(msg + bytes([ctr]), dst, 97)
        x = Fp2(
            int.from_bytes(block[0:48], "big") % P,
            int.from_bytes(block[48:96], "big") % P,
        )
        rhs = x.square() * x + b2
        y = _sqrt_fp2(rhs)
        if y is None:
            continue
        if block[96] & 1:
            y = -y
        q = _clear_cofactor((x, y))
        if q is not None:
            return q
    raise RuntimeError("hash_to_g2: no point found in 256 attempts")
