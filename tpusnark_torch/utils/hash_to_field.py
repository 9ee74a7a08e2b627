"""RFC 9380 hash-to-field (expand_message_xmd, SHA-256).

This is the construction gnark uses for the BSB22 commitment challenge:
`hash_to_field.New([]byte(constraint.CommitmentDst))` at
gnark/backend/groth16/bn254/prove.go:68-69 resolves to
gnark-crypto's fr.Hash — RFC 9380 §5.3 hash_to_field with L = 48 bytes per
element over expand_message_xmd(SHA-256). Implementing the real RFC keeps
Groth16 commitment challenges byte-compatible with gnark.

The port's copy of tpusnark/utils/hash_to_field.py: same code.
"""

from __future__ import annotations

import hashlib

_B_IN_BYTES = 32  # sha256 output size
_S_IN_BYTES = 64  # sha256 input block size
_L = 48  # ceil((254 + 128) / 8) for BN254/BLS12-381 fr


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    ell = -(-len_in_bytes // _B_IN_BYTES)
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd: length overflow")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _S_IN_BYTES
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        x = bytes(a ^ b for a, b in zip(b0, out[-1]))
        out.append(hashlib.sha256(x + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


def hash_to_field(msg: bytes, dst: bytes, modulus: int, count: int = 1) -> list[int]:
    """RFC 9380 §5.2 hash_to_field: count field elements, L = 48 bytes each."""
    raw = expand_message_xmd(msg, dst, count * _L)
    return [
        int.from_bytes(raw[i * _L : (i + 1) * _L], "big") % modulus
        for i in range(count)
    ]


COMMITMENT_DST = b"bsb22-commitment"  # constraint.CommitmentDst in gnark
