"""BLS12-381 point serialization (zcash format, as used by gnark-crypto).

gnark-crypto adopts the zcash/bellman wire format for BLS12-381 (unlike its
own generic format used for BN254 in `marshal.py`): 48-byte Fp, flags in the
three top bits of byte 0 — 0x80 compressed, 0x40 infinity, 0x20 the
lexicographically-largest y. G2 serializes x.c1 || x.c0 (c1 first). This is
the decoder side of the reference's bellman interop fixtures
(gnark/backend/groth16/bellman_test.go:19, format reference
https://github.com/zkcrypto/bellman groth16/mod.rs).

The port's copy of tpusnark/curves/marshal_bls.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .bls12381 import G1, G2, P, Fp2

FP_BYTES = 48
_MASK = 0xE0
_COMPRESSED = 0x80
_INFINITY = 0x40
_LARGEST = 0x20


def _fp_sqrt(a: int) -> int | None:
    """sqrt mod P (P % 4 == 3)."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def _fp2_sqrt(a: Fp2) -> Fp2 | None:
    """sqrt in Fp2 = Fp[u]/(u^2+1), complex method."""
    if a.is_zero():
        return Fp2.zero()
    if a.c1 == 0:
        r = _fp_sqrt(a.c0)
        if r is not None:
            return Fp2(r, 0)
        # a.c0 is a non-residue: sqrt = u * sqrt(-a.c0)
        r = _fp_sqrt(-a.c0 % P)
        return None if r is None else Fp2(0, r)
    n = _fp_sqrt((a.c0 * a.c0 + a.c1 * a.c1) % P)  # norm is a residue
    if n is None:
        return None
    inv2 = pow(2, -1, P)
    x0 = _fp_sqrt((a.c0 + n) * inv2 % P)
    if x0 is None:
        x0 = _fp_sqrt((a.c0 - n) * inv2 % P)
        if x0 is None:
            return None
    x1 = a.c1 * pow(2 * x0 % P, -1, P) % P
    cand = Fp2(x0, x1)
    return cand if cand.square() == a else None


def _fp_largest(y: int) -> bool:
    return y > P - y


def _fp2_largest(y: Fp2) -> bool:
    ny0, ny1 = (-y.c0) % P, (-y.c1) % P
    return (y.c1, y.c0) > (ny1, ny0)


# ----------------------------------------------------------------------- G1
def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(FP_BYTES - 1)
    x, y = pt
    flags = _COMPRESSED | (_LARGEST if _fp_largest(y) else 0)
    b = bytearray(x.to_bytes(FP_BYTES, "big"))
    b[0] |= flags
    return bytes(b)


def g1_raw(pt) -> bytes:
    if pt is None:
        b = bytearray(2 * FP_BYTES)
        b[0] = _INFINITY
        return bytes(b)
    x, y = pt
    return x.to_bytes(FP_BYTES, "big") + y.to_bytes(FP_BYTES, "big")


def g1_decode(data: bytes, check: bool = True):
    """-> (point, bytes_consumed)."""
    flags = data[0] & _MASK
    if flags & _COMPRESSED:
        buf = bytearray(data[:FP_BYTES])
        buf[0] &= ~_MASK & 0xFF
        if flags & _INFINITY:
            return None, FP_BYTES
        x = int.from_bytes(bytes(buf), "big")
        y = _fp_sqrt((x * x * x + G1.B) % P)
        if y is None:
            raise ValueError("G1: x not on curve")
        if _fp_largest(y) != bool(flags & _LARGEST):
            y = P - y
        pt = (x, y)
        n = FP_BYTES
    else:
        buf = bytearray(data[: 2 * FP_BYTES])
        inf = flags & _INFINITY or not any(buf)
        if inf:
            return None, 2 * FP_BYTES
        buf[0] &= ~_MASK & 0xFF
        x = int.from_bytes(bytes(buf[:FP_BYTES]), "big")
        y = int.from_bytes(bytes(buf[FP_BYTES:]), "big")
        pt = (x, y)
        n = 2 * FP_BYTES
    if check and not (G1.is_on_curve(pt) and G1.in_subgroup(pt)):
        raise ValueError("G1 point fails curve/subgroup check")
    return pt, n


# ----------------------------------------------------------------------- G2
def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(2 * FP_BYTES - 1)
    x, y = pt
    flags = _COMPRESSED | (_LARGEST if _fp2_largest(y) else 0)
    b = bytearray(x.c1.to_bytes(FP_BYTES, "big") + x.c0.to_bytes(FP_BYTES, "big"))
    b[0] |= flags
    return bytes(b)


def g2_raw(pt) -> bytes:
    if pt is None:
        b = bytearray(4 * FP_BYTES)
        b[0] = _INFINITY
        return bytes(b)
    x, y = pt
    return (
        x.c1.to_bytes(FP_BYTES, "big")
        + x.c0.to_bytes(FP_BYTES, "big")
        + y.c1.to_bytes(FP_BYTES, "big")
        + y.c0.to_bytes(FP_BYTES, "big")
    )


def g2_decode(data: bytes, check: bool = True):
    flags = data[0] & _MASK
    if flags & _COMPRESSED:
        if flags & _INFINITY:
            return None, 2 * FP_BYTES
        buf = bytearray(data[: 2 * FP_BYTES])
        buf[0] &= ~_MASK & 0xFF
        xc1 = int.from_bytes(bytes(buf[:FP_BYTES]), "big")
        xc0 = int.from_bytes(bytes(buf[FP_BYTES:]), "big")
        x = Fp2(xc0, xc1)
        y = _fp2_sqrt(x.square() * x + G2.B)
        if y is None:
            raise ValueError("G2: x not on curve")
        if _fp2_largest(y) != bool(flags & _LARGEST):
            y = -y
        pt = (x, y)
        n = 2 * FP_BYTES
    else:
        buf = bytearray(data[: 4 * FP_BYTES])
        inf = flags & _INFINITY or not any(buf)
        if inf:
            return None, 4 * FP_BYTES
        buf[0] &= ~_MASK & 0xFF
        vals = [
            int.from_bytes(bytes(buf[i * FP_BYTES : (i + 1) * FP_BYTES]), "big")
            for i in range(4)
        ]
        pt = (Fp2(vals[1], vals[0]), Fp2(vals[3], vals[2]))
        n = 4 * FP_BYTES
    if check and not (G2.is_on_curve(pt) and G2.in_subgroup(pt)):
        raise ValueError("G2 point fails curve/subgroup check")
    return pt, n
