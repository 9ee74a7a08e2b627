"""gnark-crypto-compatible BN254 point serialization.

Wire format (gnark-crypto ecc/bn254 marshal, consumed by the reference's
proof/key WriteTo at gnark/backend/groth16/bn254/marshal.go):

  * big-endian coordinates; the modulus is < 2^254 so the top 2 bits of the
    first byte carry flags:
      0b00 uncompressed | 0b10 compressed, smallest y
      0b11 compressed, largest y | 0b01 compressed infinity
  * G1 compressed = 32 bytes (X); uncompressed = 64 bytes (X || Y)
  * G2 coordinates are Fp2 = A0 + A1*u, serialized A1 || A0;
    compressed = 64 bytes, uncompressed = 128 bytes
  * "lexicographically largest" = A1 > (p-1)/2, or A0 > (p-1)/2 if A1 == 0

The port's copy of tpusnark/curves/marshal.py: same code, imports inside
tpusnark_torch. BSB22 hashes commitments with ``g1_raw``.
"""

from __future__ import annotations

from .ref import P, R, Fp2, G1, G2


def _g2_subgroup_check(pt) -> bool:
    """r-torsion membership. BN254 G2 has a large cofactor, so an on-curve
    point from untrusted bytes may live outside the subgroup and break the
    pairing soundness assumptions — gnark-crypto's SetBytes subgroup-checks
    by default and skips it only for trusted key material (io.UnsafeReaderFrom,
    gnark/io/io.go:35-40). Host-side decode, so the plain [r]P == O
    check is fine (~1ms). NOTE: must NOT be G2.mul(pt, R) — mul reduces the
    scalar mod r, so that would be mul by zero and vacuously pass."""
    return G2.in_subgroup(pt)

M_MASK = 0b11 << 6
M_UNCOMPRESSED = 0b00 << 6
M_COMPRESSED_SMALLEST = 0b10 << 6
M_COMPRESSED_LARGEST = 0b11 << 6
M_COMPRESSED_INFINITY = 0b01 << 6

_HALF = (P - 1) // 2


def _lex_largest_fp(y: int) -> bool:
    return y > _HALF


def _lex_largest_fp2(y: Fp2) -> bool:
    if y.c1 != 0:
        return y.c1 > _HALF
    return y.c0 > _HALF


def _sqrt_fp(a: int) -> int | None:
    """p == 3 mod 4: sqrt = a^((p+1)/4)."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def _sqrt_fp2(a: Fp2) -> Fp2 | None:
    """Complex method over Fp[u]/(u^2+1)."""
    if a.c1 == 0:
        r = _sqrt_fp(a.c0)
        if r is not None:
            return Fp2(r, 0)
        r = _sqrt_fp((-a.c0) % P)
        return Fp2(0, r) if r is not None else None
    norm = (a.c0 * a.c0 + a.c1 * a.c1) % P
    lam = _sqrt_fp(norm)
    if lam is None:
        return None
    inv2 = pow(2, -1, P)
    delta = (a.c0 + lam) * inv2 % P
    x0 = _sqrt_fp(delta)
    if x0 is None:
        delta = (a.c0 - lam) * inv2 % P
        x0 = _sqrt_fp(delta)
        if x0 is None:
            return None
    x1 = a.c1 * pow(2 * x0 % P, -1, P) % P
    out = Fp2(x0, x1)
    return out if (out * out) == a else None


# ----------------------------------------------------------------------- G1
def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([M_COMPRESSED_INFINITY]) + b"\x00" * 31
    x, y = pt
    buf = bytearray(int(x).to_bytes(32, "big"))
    flag = M_COMPRESSED_LARGEST if _lex_largest_fp(y) else M_COMPRESSED_SMALLEST
    buf[0] |= flag
    return bytes(buf)


def g1_raw(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def g1_decode(data: bytes, check: bool = True):
    flag = data[0] & M_MASK
    if flag == M_UNCOMPRESSED:
        if len(data) < 64:
            raise ValueError("short G1 uncompressed encoding")
        x = int.from_bytes(data[:32], "big")
        y = int.from_bytes(data[32:64], "big")
        if x == 0 and y == 0:
            return None, 64
        pt = (x, y)
        if check and not G1.on_curve(pt):
            raise ValueError("G1 point not on curve")
        return pt, 64
    if flag == M_COMPRESSED_INFINITY:
        return None, 32
    buf = bytearray(data[:32])
    buf[0] &= ~M_MASK & 0xFF
    x = int.from_bytes(bytes(buf), "big")
    y2 = (pow(x, 3, P) + 3) % P
    y = _sqrt_fp(y2)
    if y is None:
        raise ValueError("invalid G1 x-coordinate")
    if _lex_largest_fp(y) != (flag == M_COMPRESSED_LARGEST):
        y = (-y) % P
    return (x, y), 32


# ----------------------------------------------------------------------- G2
def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([M_COMPRESSED_INFINITY]) + b"\x00" * 63
    x, y = pt
    buf = bytearray(x.c1.to_bytes(32, "big") + x.c0.to_bytes(32, "big"))
    flag = M_COMPRESSED_LARGEST if _lex_largest_fp2(y) else M_COMPRESSED_SMALLEST
    buf[0] |= flag
    return bytes(buf)


def g2_raw(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    x, y = pt
    return (
        x.c1.to_bytes(32, "big")
        + x.c0.to_bytes(32, "big")
        + y.c1.to_bytes(32, "big")
        + y.c0.to_bytes(32, "big")
    )


def _g2_b() -> Fp2:
    from .ref import B2

    return B2


def g2_decode(data: bytes, check: bool = True):
    flag = data[0] & M_MASK
    if flag == M_UNCOMPRESSED:
        if len(data) < 128:
            raise ValueError("short G2 uncompressed encoding")
        x = Fp2(int.from_bytes(data[32:64], "big"), int.from_bytes(data[:32], "big"))
        y = Fp2(int.from_bytes(data[96:128], "big"), int.from_bytes(data[64:96], "big"))
        if x.is_zero() and y.is_zero():
            return None, 128
        pt = (x, y)
        if check and not G2.on_curve(pt):
            raise ValueError("G2 point not on curve")
        if check and not _g2_subgroup_check(pt):
            raise ValueError("G2 point not in the r-torsion subgroup")
        return pt, 128
    if flag == M_COMPRESSED_INFINITY:
        return None, 64
    buf = bytearray(data[:64])
    buf[0] &= ~M_MASK & 0xFF
    x = Fp2(int.from_bytes(bytes(buf[32:64]), "big"), int.from_bytes(bytes(buf[:32]), "big"))
    y2 = x * x * x + _g2_b()
    y = _sqrt_fp2(y2)
    if y is None:
        raise ValueError("invalid G2 x-coordinate")
    if _lex_largest_fp2(y) != (flag == M_COMPRESSED_LARGEST):
        y = Fp2((-y.c0) % P, (-y.c1) % P)
    pt = (x, y)
    if check and not _g2_subgroup_check(pt):
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt, 64
