"""Pure-Python BW6-633 reference implementation: fields, curves, pairing.

The outer curve of the reference's BLS24-315 2-chain: its scalar field r
equals BLS24-315's base field p (gnark/constraint/bw6-633,
backend/groth16/bw6-633 — generated packages; curve list
backend/backend.go:28-33). Embedding degree 6: both G1 and G2 live over
the 633-bit prime field Fp, exactly like BW6-761 (`bw6761.py`), so this
module mirrors that structure with constants derived for this curve.

Parameters (scripts/derive_curves.py; the reference carries no in-repo
copy of this p, so it is re-derived from the published construction and
self-verified): r = BLS24-315 p; p = the unique 633-bit Cocks-Pinch k=6
prime over r with D = -3 (lift cofactors (ht, hy) = (-7, -2) family);
trace t = ((p+1) mod r) - 7r (Hasse-interval scan, r | p+1-t);
E: y^2 = x^3 - 7 over Fp; sextic twist E': y^2 = x^3 - 7*zeta with
zeta = -6 (M-type), order p + 1 - (t - 3f)/2 where 4p = t^2 + 3 f^2.
Fp6 = Fp[w]/(w^6 - zeta); untwist (x, y) -> (x/w^2, y/w^3). Generators
are cofactor-cleared first curve points — self-consistent, not matched
to external serializations.

The port's copy of tpusnark/curves/bw6633.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import math as _math

from ._subgroup import ladder_mul_raw as _ladder_mul_raw
from .tower import make_ext, prime_field

P = 0x126633CC0F35F63FC1A174F01D72AB5A8FCD8C75D79D2C74E59769AD9BBDA2F8152A6C0FADEA490B8DA9F5E83F57C497E0E8850EDBDA407D7B5CE7AB839C2253D369BD31147F73CD74916EA4570000D
R = 0x4C23A02B586D650D3F7498BE97C5EAFDEC1D01AA27A1AE0421EE5DA52BDE5026FE802FF40300001  # = BLS24-315 p

TRACE = ((P + 1) % R) + (-7) * R
N1 = P + 1 - TRACE  # #E(Fp)
H1 = N1 // R
_F = _math.isqrt((4 * P - TRACE * TRACE) // 3)
assert _F * _F * 3 == 4 * P - TRACE * TRACE
N2 = P + 1 - (TRACE + 3 * _F) // 2  # #E'(Fp) (verified twist order)
H2 = N2 // R
assert N1 % R == 0 and N2 % R == 0

B1 = -7  # E: y^2 = x^3 - 7
ZETA = -6  # w^6 = -6; twist scale (M-type: b' = b * zeta = 42)
B2 = (B1 * ZETA) % P

G1_GEN = (
    0xB510B6323DBF11AC6907201A011A4DC664D4B9E7C9E3A91391791AAD8E0E65391FAB02C686BF0299689D129A12E02EB6FA1DFBA3133C6BAF6EB145A3C1817E6DE17F73793148759AF48DA3CC2B9CC5,
    0x85B80520D96CC3246A7C90EE06140740C98BA49CDC5BC184E8A4BF8193D724B05A44477A74B2FCFFFDB5D9B0BC8C95657711CEAD0097239CD6C54B8767EF54A839D2E4ED3A10F3D981D0558D7E28C1,
)
G2_GEN = (
    0x53FFDFBF66B41439DEC75DEF9CBC031D8096A769BA5ECA96590AA24509766FDC5B4E86247906994E3F174AD86566E319947DCDC5FE4EABAED3E60C5A5AA5A0FEEE61551CE9BB7774D95617A564F236,
    0x913F005C33A7D68A38C8AA5AA3C8FC05ED14295E7E48738091F8D4674EA26C3C5EF55D9A56EE15D5A63C8B4A643CB10D83641109B901E9688906A7F36D02A87627E9C7DC85B41A3B93310448F59E9D,
)


def finv(a: int) -> int:
    return pow(a, -1, P)


_Fp = prime_field(P)
Fp6 = make_ext(_Fp, 6, ZETA, "Fp6_bw6633")


def _make_group(b: int, name: str):
    class _G:
        B = b

        @staticmethod
        def generator():
            return G1_GEN if name == "g1" else G2_GEN

        @staticmethod
        def add(p1, p2):
            if p1 is None:
                return p2
            if p2 is None:
                return p1
            x1, y1 = p1
            x2, y2 = p2
            if x1 == x2:
                if (y1 - y2) % P == 0:
                    return _G.double(p1)
                return None
            m = (y2 - y1) * finv((x2 - x1) % P) % P
            x3 = (m * m - x1 - x2) % P
            return (x3, (m * (x1 - x3) - y1) % P)

        @staticmethod
        def double(p1):
            if p1 is None:
                return None
            x1, y1 = p1
            if y1 == 0:
                return None
            m = 3 * x1 * x1 * finv(2 * y1 % P) % P
            x3 = (m * m - 2 * x1) % P
            return (x3, (m * (x1 - x3) - y1) % P)

        @staticmethod
        def neg(p1):
            return None if p1 is None else (p1[0], (-p1[1]) % P)

        @staticmethod
        def mul(p1, k: int):
            k %= R
            acc = None
            while k:
                if k & 1:
                    acc = _G.add(acc, p1)
                p1 = _G.double(p1)
                k >>= 1
            return acc

        @staticmethod
        def is_on_curve(p1) -> bool:
            if p1 is None:
                return True
            x, y = p1
            return (y * y - x * x * x - b) % P == 0

        @staticmethod
        def in_subgroup(p1) -> bool:
            return _ladder_mul_raw(_G, p1, R) is None

    _G.__name__ = name.upper()
    return _G


G1 = _make_group(B1 % P, "g1")
G2 = _make_group(B2, "g2")

# ------------------------------------------------------------------ pairing
_w = Fp6.gen()
_W2_INV = (_w * _w).inv()
_W3_INV = (_w * _w * _w).inv()


def _untwist(q):
    """E'(Fp) -> E(Fp6): M-type, (x, y) -> (x/w^2, y/w^3)."""
    x, y = q
    return (Fp6.from_int(x) * _W2_INV, Fp6.from_int(y) * _W3_INV)


def _line(t, q, pxy):
    x1, y1 = t
    x2, y2 = q
    xp, yp = pxy
    if x1 == x2 and y1 == y2:
        m = x1 * x1 * 3 * (y1 + y1).inv()
    elif x1 == x2:
        return xp - x1  # vertical
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    return m * (xp - x1) - (yp - y1)


def _ec6_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            m = x1 * x1 * 3 * (y1 + y1).inv()
        else:
            return None
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def miller_loop(p, q) -> "Fp6":
    """f_{T, Q}(P) with T = t - 1 (ate loop), P in G1, Q in G2 affine.

    T < 0 here: run the loop on |T| and return f^-1 (verticals die in the
    final exponentiation)."""
    pxy = (Fp6.from_int(p[0]), Fp6.from_int(p[1]))
    q6 = _untwist(q)
    t = q6
    f = Fp6.one()
    T = TRACE - 1
    for bit in bin(abs(T))[3:]:
        f = f.square() * _line(t, t, pxy)
        t = _ec6_add(t, t)
        if bit == "1":
            f = f * _line(t, q6, pxy)
            t = _ec6_add(t, q6)
    return f.inv() if T < 0 else f


_FINAL_EXP = (P**6 - 1) // R


def final_exp(f) -> "Fp6":
    return f.pow(_FINAL_EXP)


def pairing(p, q) -> "Fp6":
    if p is None or q is None:
        return Fp6.one()
    return final_exp(miller_loop(p, q))


def multi_pairing(pairs) -> "Fp6":
    f = Fp6.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(p, q)
    return final_exp(f)


def gt_one():
    return Fp6.one()
