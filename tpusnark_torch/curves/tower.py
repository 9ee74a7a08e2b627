"""Generic extension-field tower for host (python-int) curve oracles.

The reference relies on gnark-crypto's hand-written per-tower packages
(Fp2/Fp4/Fp6/Fp12/Fp24 with dedicated Karatsuba/Frobenius code, used from
e.g. gnark/backend/groth16/bls24-315/verify.go). Host pairings in
tpusnark are NOT performance-relevant (the device never computes pairings;
verify is a host step), so one generic binomial-extension class serves every
curve: K = B[w]/(w^deg - zeta) over any base B that itself exposes the same
tiny protocol. This is what lets BLS24-315/317 (G2 over Fp4, GT in Fp24)
reuse all of the BW6 machinery instead of adding ~800 LoC of bespoke tower
code per curve.

Protocol for a field class F:
  F.zero(), F.one(), F.from_int(i), +, -, *, F.inv(), F.is_zero(), ==, hash
Plain python ints mod p are wrapped by `prime_field(p)`.

The port's copy of tpusnark/curves/tower.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def prime_field(p: int):
    """Fp as a class over python ints (value in .c[0] for uniformity)."""

    class Fp:
        __slots__ = ("v",)
        P = p
        DEG_ABS = 1  # absolute degree over the prime field

        def __init__(self, v: int):
            self.v = v % p

        @staticmethod
        def zero():
            return Fp(0)

        @staticmethod
        def one():
            return Fp(1)

        @staticmethod
        def from_int(i: int):
            return Fp(i)

        def __eq__(self, o):
            return self.v == o.v

        def __hash__(self):
            return hash(self.v)

        def __add__(self, o):
            return Fp(self.v + o.v)

        def __sub__(self, o):
            return Fp(self.v - o.v)

        def __neg__(self):
            return Fp(-self.v)

        def __mul__(self, o):
            if isinstance(o, int):
                return Fp(self.v * o)
            return Fp(self.v * o.v)

        __rmul__ = __mul__

        def inv(self):
            return Fp(pow(self.v, -1, p))

        def pow(self, e: int):
            if e < 0:
                return Fp(pow(pow(self.v, -1, p), -e, p))
            return Fp(pow(self.v, e, p))

        def square(self):
            return Fp(self.v * self.v)

        def is_zero(self):
            return self.v == 0

        def is_one(self):
            return self.v == 1

        def __repr__(self):
            return f"Fp({hex(self.v)})"

    return Fp


def make_ext(base, deg: int, zeta, name: str = "Ext"):
    """K = base[w]/(w^deg - zeta); zeta is a base element (or int).

    Coefficients little-endian. Multiplication is schoolbook + binomial
    reduction; inversion is extended Euclid over base[X] (host oracle —
    clarity over speed)."""
    if isinstance(zeta, int):
        zeta = base.from_int(zeta)

    class Ext:
        __slots__ = ("c",)
        BASE = base
        DEG = deg
        ZETA = zeta
        DEG_ABS = deg * getattr(base, "DEG_ABS", 1)

        def __init__(self, c):
            c = tuple(
                x if not isinstance(x, int) else base.from_int(x) for x in c
            )
            assert len(c) == deg
            self.c = c

        @staticmethod
        def zero():
            return Ext((base.zero(),) * deg)

        @staticmethod
        def one():
            return Ext((base.one(),) + (base.zero(),) * (deg - 1))

        @staticmethod
        def from_int(i: int):
            return Ext((base.from_int(i),) + (base.zero(),) * (deg - 1))

        @staticmethod
        def from_base(x):
            return Ext((x,) + (base.zero(),) * (deg - 1))

        @staticmethod
        def gen():
            """The class of w."""
            c = [base.zero()] * deg
            c[1 % deg] = base.one()
            return Ext(tuple(c))

        def __eq__(self, o):
            return self.c == o.c

        def __hash__(self):
            return hash(self.c)

        def __add__(self, o):
            return Ext(tuple(a + b for a, b in zip(self.c, o.c)))

        def __sub__(self, o):
            return Ext(tuple(a - b for a, b in zip(self.c, o.c)))

        def __neg__(self):
            return Ext(tuple(-a for a in self.c))

        def __mul__(self, o):
            if isinstance(o, int):
                return Ext(tuple(a * o for a in self.c))
            if isinstance(o, base):
                return Ext(tuple(a * o for a in self.c))
            out = [base.zero()] * (2 * deg - 1)
            for i, a in enumerate(self.c):
                if a.is_zero():
                    continue
                for j, b in enumerate(o.c):
                    out[i + j] = out[i + j] + a * b
            for k in range(2 * deg - 2, deg - 1, -1):
                out[k - deg] = out[k - deg] + zeta * out[k]
            return Ext(tuple(out[:deg]))

        __rmul__ = __mul__

        def square(self):
            return self * self

        def is_zero(self):
            return all(a.is_zero() for a in self.c)

        def is_one(self):
            return self == Ext.one()

        def inv(self):
            """Extended Euclid in base[X] against X^deg - zeta."""
            # poly rep: list of base coeffs, little-endian, trimmed
            def trim(f):
                while f and f[-1].is_zero():
                    f.pop()
                return f

            def pmul(f, g):
                out = [base.zero()] * (len(f) + len(g) - 1) if f and g else []
                for i, a in enumerate(f):
                    for j, b in enumerate(g):
                        out[i + j] = out[i + j] + a * b
                return trim(out)

            def psub(f, g):
                out = list(f) + [base.zero()] * (len(g) - len(f))
                for j, b in enumerate(g):
                    out[j] = out[j] - b
                return trim(out)

            def pdivmod(f, g):
                q = [base.zero()] * max(0, len(f) - len(g) + 1)
                r = list(f)
                ginv = g[-1].inv()
                while len(r) >= len(g) and r:
                    k = len(r) - len(g)
                    coef = r[-1] * ginv
                    q[k] = q[k] + coef
                    for j, b in enumerate(g):
                        r[k + j] = r[k + j] - coef * b
                    trim(r)
                return trim(q), r

            mod = [base.zero()] * (deg + 1)
            mod[0] = -zeta
            mod[deg] = base.one()
            # extended Euclid: r0 = mod, r1 = self; s_i * self == r_i (mod mod)
            r0, r1 = mod, trim(list(self.c))
            assert r1, "inverse of zero"
            s0, s1 = [], [base.one()]
            while len(r1) > 1:
                q, r = pdivmod(r0, r1)
                r0, r1 = r1, r
                s0, s1 = s1, psub(s0, pmul(q, s1))
                assert r1, "not invertible (zero divisor)"
            d = r1[0].inv()
            out = [x * d for x in s1]
            out += [base.zero()] * (deg - len(out))
            return Ext(tuple(out[:deg]))

        def pow(self, e: int):
            if e < 0:
                return self.inv().pow(-e)
            res, b = Ext.one(), self
            while e:
                if e & 1:
                    res = res * b
                b = b.square()
                e >>= 1
            return res

        def __repr__(self):
            return f"{name}({self.c})"

    Ext.__name__ = name
    return Ext


def ext_sqrt(K, a, q: int, rng=None):
    """Tonelli-Shanks square root in an extension field K of order q.

    Returns y with y*y == a, or None if a is a non-residue. Used offline to
    mint G2 generators (see bls24315.py constants) and by tests."""
    import random

    rng = rng or random.Random(7)
    if a.is_zero():
        return K.zero()
    if a.pow((q - 1) // 2) != K.one():
        return None
    # write q - 1 = 2^s * t
    t, s = q - 1, 0
    while t % 2 == 0:
        t //= 2
        s += 1
    if s == 1:
        return a.pow((q + 1) // 4)

    # random non-residue
    def rand_elem():
        def r(base):
            if hasattr(base, "BASE"):
                return base(tuple(r(base.BASE) for _ in range(base.DEG)))
            return base.from_int(rng.randrange(q))

        return r(K)

    while True:
        z = rand_elem()
        if not z.is_zero() and z.pow((q - 1) // 2) != K.one():
            break
    m, c, u, r = s, z.pow(t), a.pow(t), a.pow((t + 1) // 2)
    while u != K.one():
        # least i with u^(2^i) == 1
        i, u2 = 0, u
        while u2 != K.one():
            u2 = u2.square()
            i += 1
        b = c.pow(1 << (m - i - 1))
        m, c = i, b.square()
        u, r = u * c, r * b
    return r
