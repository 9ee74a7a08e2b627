"""In-circuit NATIVE-field short-Weierstrass ops for the 2-chain.

BLS12-377 G1 (y^2 = x^3 + 1 over Fp = the BW6-761 circuit field) and
G2-on-the-twist (y^2 = x^3 + 1/u over Fp2) as plain circuit arithmetic:
~10 constraints per point add versus the ~10^3 of the emulated path.
Reference: gnark/std/algebra/native/sw_bls12377/g1.go, g2.go.

Soundness discipline mirrors gadgets/sw_emulated.py round-5 form: the
unified (Brier-Joye) addition computes its slope against a dummy
denominator 1 through a constrained division whenever y1 + y2 == 0, and
flags the lane as identity.

The port's copy of tpusnark/gadgets/sw_native.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..curves import bls12377 as host
from .native_tower import NFp2

P = host.P


class NativeG1:
    """In-circuit BLS12-377 G1 (affine + zero flag) over the native field."""

    def __init__(self, api, b: int = 1):
        self.api = api
        self.b = b

    def constant(self, pt):
        """Host affine point (or None) -> ((x, y), zero_flag) constants."""
        if pt is None:
            return ((0, 0), 1)
        return ((pt[0] % P, pt[1] % P), 0)

    def assert_on_curve(self, xy):
        api = self.api
        x, y = xy
        api.assert_is_equal(
            api.mul(y, y), api.add(api.mul(x, api.mul(x, x)), self.b)
        )

    def _div_nonzero(self, num, den):
        """num/den with den != 0 guaranteed by the caller (hint + one
        product constraint pins the quotient uniquely)."""
        return self.api.div_unchecked(num, den)

    def add_unified(self, p, q):
        """Flagged complete add: p, q are ((x, y), z) with z a boolean
        zero-flag. Brier-Joye unified slope lam = (x1^2 + x1 x2 + x2^2) /
        (y1 + y2); y1 + y2 == 0 lanes return the flagged identity via a
        dummy-denominator constrained division (cf. reference AddUnified,
        sw_emulated/point.go:210-236 — identical soundness shape)."""
        api = self.api
        (x1, y1), pz = p
        (x2, y2), qz = q
        ysum = api.add(y1, y2)
        bad = api.is_zero(ysum)
        num = api.add(
            api.add(api.mul(x1, x1), api.mul(x1, x2)), api.mul(x2, x2)
        )
        num = api.select(bad, 0, num)
        den = api.select(bad, 1, ysum)
        lam = self._div_nonzero(num, den)
        xr = api.sub(api.sub(api.mul(lam, lam), x1), x2)
        yr = api.sub(api.mul(lam, api.sub(x1, xr)), y1)
        # identity plumbing
        both_live = api.and_(api.sub(1, pz), api.sub(1, qz))
        rz = api.or_(api.and_(pz, qz), api.and_(both_live, bad))
        xo = api.select(pz, x2, api.select(qz, x1, xr))
        yo = api.select(pz, y2, api.select(qz, y1, yr))
        xo = api.select(rz, 0, xo)
        yo = api.select(rz, 0, yo)
        return ((xo, yo), rz)

    def scalar_mul_const_base(self, bits, base):
        """sum-of-selected-multiples for a HOST-CONSTANT base point:
        acc = AUX + sum bits_i * (2^i * base), with the doublings
        precomputed on the host (free) and every add the unified complete
        add (safe for any bit pattern); AUX is subtracted at the end."""
        aux = host.G1.mul(host.G1.generator(), 0x9E377C0FFEE1234567)
        acc = self.constant(aux)
        cur = base
        for b in bits:
            dbl = host.G1.add(cur, cur)
            cpt = self.constant(cur)
            added = self.add_unified(acc, cpt)
            acc = (
                (
                    self.api.select(b, added[0][0], acc[0][0]),
                    self.api.select(b, added[0][1], acc[0][1]),
                ),
                self.api.select(b, added[1], acc[1]),
            )
            cur = dbl
        neg_aux = (aux[0], (-aux[1]) % P)
        return self.add_unified(acc, self.constant(neg_aux))


class NativeG2:
    """In-circuit BLS12-377 G2 on the twist (coords NFp2 pairs); only the
    ops the Miller loop needs (affine double/add with hint inversions)."""

    def __init__(self, api):
        self.api = api
        self.f2 = NFp2(api)

    def constant(self, pt):
        x, y = pt
        return (self.f2.const(x), self.f2.const(y))

    def assert_on_curve(self, pt):
        f2 = self.f2
        x, y = pt
        lhs = f2.square(y)
        rhs = f2.add(f2.mul(f2.square(x), x), f2.const(host.B2))
        f2.assert_eq(lhs, rhs)

    def double(self, t):
        """(t, lam): affine doubling with slope returned for line building.
        Assumes y != 0 (true for prime-order G2 points)."""
        f2 = self.f2
        x1, y1 = t
        three_x2 = f2.mul_fp(f2.square(x1), 3)
        lam = f2.div(three_x2, f2.add(y1, y1))
        x3 = f2.sub(f2.sub(f2.square(lam), x1), x1)
        y3 = f2.sub(f2.mul(lam, f2.sub(x1, x3)), y1)
        return (x3, y3), lam

    def add(self, t, q):
        """(t + q, lam); assumes x_t != x_q (holds through a Miller loop on
        points of prime order with the standard seed)."""
        f2 = self.f2
        x1, y1 = t
        x2, y2 = q
        lam = f2.div(f2.sub(y2, y1), f2.sub(x2, x1))
        x3 = f2.sub(f2.sub(f2.square(lam), x1), x2)
        y3 = f2.sub(f2.mul(lam, f2.sub(x1, x3)), y1)
        return (x3, y3), lam
