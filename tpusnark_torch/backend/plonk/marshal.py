"""PLONK proof serialization in gnark's wire layout.

Reference: gnark/backend/plonk/bn254/marshal.go:36-65 (Proof
WriteTo/ReadFrom): LRO[0..2], Z, H[0..2], BatchedProof.H as compressed G1
points, BatchedProof.ClaimedValues as an fr vector (uint32 BE count + 32-byte
big-endian elements), ZShiftedOpening.H + ClaimedValue, then the
Bsb22Commitments as a length-prefixed compressed-point list (gnark-crypto
encoder conventions for []G1Affine / fr.Vector).

The port's copy of tpusnark/backend/plonk/marshal.py: same code."""

from __future__ import annotations

import struct

from ...curves.marshal import g1_compress, g1_decode
from .keys import PlonkProof


def _fr_vec(vals) -> bytes:
    out = struct.pack(">I", len(vals))
    for v in vals:
        out += int(v).to_bytes(32, "big")
    return out


def proof_to_bytes(proof: PlonkProof) -> bytes:
    out = b""
    for pt in (
        proof.l_com,
        proof.r_com,
        proof.o_com,
        proof.z_com,
        proof.h1_com,
        proof.h2_com,
        proof.h3_com,
        proof.batched_h,
    ):
        out += g1_compress(pt)
    out += _fr_vec(proof.claimed_values)
    out += g1_compress(proof.z_shifted_h)
    out += int(proof.z_shifted_value).to_bytes(32, "big")
    out += struct.pack(">I", len(proof.bsb22_commitments))
    for pt in proof.bsb22_commitments:
        out += g1_compress(pt)
    return out


def proof_from_bytes(data: bytes) -> PlonkProof:
    o = 0

    def pt():
        nonlocal o
        p, _ = g1_decode(data[o : o + 32])
        o += 32
        return p

    lro = [pt() for _ in range(3)]
    z = pt()
    h = [pt() for _ in range(3)]
    batched_h = pt()
    (ncv,) = struct.unpack(">I", data[o : o + 4])
    o += 4
    claimed = []
    for _ in range(ncv):
        claimed.append(int.from_bytes(data[o : o + 32], "big"))
        o += 32
    z_shifted_h = pt()
    zu = int.from_bytes(data[o : o + 32], "big")
    o += 32
    (nbsb,) = struct.unpack(">I", data[o : o + 4])
    o += 4
    bsb = [pt() for _ in range(nbsb)]
    assert o == len(data), "trailing bytes in PLONK proof"
    return PlonkProof(
        l_com=lro[0],
        r_com=lro[1],
        o_com=lro[2],
        z_com=z,
        h1_com=h[0],
        h2_com=h[1],
        h3_com=h[2],
        bsb22_commitments=bsb,
        batched_h=batched_h,
        claimed_values=claimed,
        z_shifted_h=z_shifted_h,
        z_shifted_value=zu,
    )
