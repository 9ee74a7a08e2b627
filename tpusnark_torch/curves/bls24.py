"""Parametrized BLS24 host oracle: fields, curves, pairing (315 & 317).

Covers the reference's BLS24-315 / BLS24-317 curve packages
(gnark/constraint/bls24-315, backend/groth16/bls24-315 etc. —
generated per-curve by internal/generator/backend/main.go:45-65) with ONE
factory over the generic extension tower (`tower.py`), the same no-codegen
stance as the rest of tpusnark.

BLS24 structure: embedding degree 24, G1 over Fp, G2 over Fp4, GT in Fp24.
Tower (uniform for both curves):
  Fp2  = Fp[u]/(u^2 - A2)          (A2 a small non-square)
  Fp4  = Fp2[v]/(v^2 - Z2)         (Z2 a small Fp2 non-square/-cube)
  Fp24 = Fp2[w]/(w^12 - Z2)        (v = w^6, u = w^12... no: u in Fp2 base)
G2 lives on a sextic twist of E over Fp4 with xi = v; untwisting maps its
points into E(Fp24). The ate Miller loop parameter is the seed x (the BLS
trace is t = x + 1); negative seeds take f^-1 pre-final-exp. Final
exponentiation is the generic f^((p^24-1)/r) — host pairings are oracles,
not perf-relevant (the device never computes pairings).

Parameters are derived from the seed from first principles
(scripts/derive_curves.py): p/r match the reference's emparams
(BLS24-315: emparams.go:262-283; BLS24-317 has no in-repo copy of p/r, so
the derivation is self-verified: r = x^8 - x^4 + 1, p = (x-1)^2 r/3 + x,
both prime, with the standard seed 0xd9018000). Generators are
cofactor-cleared first curve points — self-consistent, NOT the arkworks
constants (any order-r point serves this module's self-contained use).

The port's copy of tpusnark/curves/bls24.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from types import SimpleNamespace

from ._subgroup import ladder_mul_raw
from .tower import make_ext, prime_field


def _int_group(P: int, R: int, b: int, gen, name: str):
    """Affine short-Weierstrass group over Fp with int coords (None = inf)."""

    class _G:
        B = b

        @staticmethod
        def generator():
            return gen

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
            m = (y2 - y1) * pow((x2 - x1) % P, -1, P) % P
            x3 = (m * m - x1 - x2) % P
            return (x3, (m * (x1 - x3) - y1) % P)

        @staticmethod
        def double(p1):
            if p1 is None:
                return None
            x1, y1 = p1
            if y1 == 0:
                return None
            m = 3 * x1 * x1 * pow(2 * y1 % P, -1, P) % P
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
            return ladder_mul_raw(_G, p1, R) is None

    _G.__name__ = name
    return _G


def _field_group(K, b_elem, R: int, gen, name: str):
    """Affine group with coordinates in an extension field class K."""

    class _G:
        B = b_elem
        FIELD = K

        @staticmethod
        def generator():
            return gen

        @staticmethod
        def add(p1, p2):
            if p1 is None:
                return p2
            if p2 is None:
                return p1
            x1, y1 = p1
            x2, y2 = p2
            if x1 == x2:
                if y1 == y2:
                    return _G.double(p1)
                return None
            m = (y2 - y1) * (x2 - x1).inv()
            x3 = m * m - x1 - x2
            return (x3, m * (x1 - x3) - y1)

        @staticmethod
        def double(p1):
            if p1 is None:
                return None
            x1, y1 = p1
            if y1.is_zero():
                return None
            m = x1 * x1 * 3 * (y1 + y1).inv()
            x3 = m * m - x1 - x1
            return (x3, m * (x1 - x3) - y1)

        @staticmethod
        def neg(p1):
            return None if p1 is None else (p1[0], -p1[1])

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
            return (y * y - (x * x * x + b_elem)).is_zero()

        @staticmethod
        def in_subgroup(p1) -> bool:
            return ladder_mul_raw(_G, p1, R) is None

    _G.__name__ = name
    return _G


def make_bls24(
    x_seed: int,
    a2: int,
    z2: tuple[int, int],
    b1: int,
    twist_d: bool,
    g1_gen: tuple[int, int],
    g2_gen,
    name: str,
):
    """Build the host namespace for one BLS24 curve.

    g2_gen: ((c00,c01),(c10,c11)) int nests per coordinate (x, y) —
    Fp4 = c0 + c1 v with ci = ci0 + ci1 u."""
    x = x_seed
    R = x**8 - x**4 + 1
    P = ((x - 1) ** 2 * R) // 3 + x
    Fp = prime_field(P)
    Fp2 = make_ext(Fp, 2, a2, "Fp2_" + name)
    Fp4 = make_ext(Fp2, 2, Fp2(z2), "Fp4_" + name)
    Fp24 = make_ext(Fp2, 12, Fp2(z2), "Fp24_" + name)

    def fp4(nest):
        return Fp4((Fp2(nest[0]), Fp2(nest[1])))

    v = Fp4((Fp2((0, 0)), Fp2((1, 0))))
    b1e = Fp4.from_int(b1)
    b2 = b1e * v.inv() if twist_d else b1e * v  # twist curve constant
    G1 = _int_group(P, R, b1, g1_gen, "G1")
    g2 = (fp4(g2_gen[0]), fp4(g2_gen[1]))
    G2 = _field_group(Fp4, b2, R, g2, "G2")

    # ---- pairing ---------------------------------------------------------
    w = Fp24.gen()
    w2, w3 = w * w, w * w * w
    if twist_d:
        # E': y^2 = x^3 + b/v; untwist (x, y) -> (x w^2, y w^3)
        ux, uy = w2, w3
    else:
        ux, uy = w2.inv(), w3.inv()

    def lift4(e):
        """Fp4 (c0 + c1 v) -> Fp24 (coeffs at w^0, w^6)."""
        c = [Fp2((0, 0))] * 12
        c[0], c[6] = e.c[0], e.c[1]
        return Fp24(tuple(c))

    def _untwist(q):
        xq, yq = q
        return (lift4(xq) * ux, lift4(yq) * uy)

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

    def _ec_add(p1, p2):
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

    X_ABS = abs(x)

    def miller_loop(p, q):
        """f_{|x|, Q}(P); x < 0 returns f^-1 (verticals die in final exp)."""
        pxy = (Fp24.from_int(p[0]), Fp24.from_int(p[1]))
        q24 = _untwist(q)
        t = q24
        f = Fp24.one()
        for bit in bin(X_ABS)[3:]:
            f = f.square() * _line(t, t, pxy)
            t = _ec_add(t, t)
            if bit == "1":
                f = f * _line(t, q24, pxy)
                t = _ec_add(t, q24)
        return f.inv() if x < 0 else f

    FINAL_EXP = (P**24 - 1) // R

    def final_exp(f):
        return f.pow(FINAL_EXP)

    def pairing(p, q):
        if p is None or q is None:
            return Fp24.one()
        return final_exp(miller_loop(p, q))

    def multi_pairing(pairs):
        f = Fp24.one()
        for p, q in pairs:
            if p is None or q is None:
                continue
            f = f * miller_loop(p, q)
        return final_exp(f)

    b3t = b2 * 3
    # 3*b' as nested python ints ((c00,c01),(c10,c11)) for the device ops
    B3_NEST = tuple(tuple(fp_.v for fp_ in f2.c) for f2 in b3t.c)

    return SimpleNamespace(
        name=name,
        P=P,
        R=R,
        X_SEED=x,
        A2=a2,
        Z2=z2,
        B1=b1,
        B2=b2,
        B3_NEST=B3_NEST,
        TWIST_D=twist_d,
        Fp2=Fp2,
        Fp4=Fp4,
        Fp24=Fp24,
        fp4=fp4,
        G1=G1,
        G2=G2,
        G1_GEN=g1_gen,
        G2_GEN=g2,
        miller_loop=miller_loop,
        final_exp=final_exp,
        pairing=pairing,
        multi_pairing=multi_pairing,
        gt_one=Fp24.one,
    )
