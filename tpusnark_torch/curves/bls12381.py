"""Pure-Python BLS12-381 reference implementation: fields, curves, pairing.

Second curve instantiation (after BN254 in `ref.py`), proving the
no-codegen parametrization claim: the reference generates per-curve Go
packages 8x (gnark/internal/generator/backend/main.go,
backend/backend.go:28-33); here a curve is one ~350-line host module plus
the shared FieldSpec-parametrized device kernels.

Role: host oracle + verifier backend for BLS12-381 (pairings are not
perf-critical, SURVEY.md §2.5), and the decoder side of the bellman/zcash
interop fixtures (gnark/backend/groth16/bellman_test.go:19).

Textbook algorithms, from scratch:
  * Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = u+1; Fp12 = Fp6[w]/(w^2 - v)
  * G1: y^2 = x^3 + 4 over Fp (cofactor h1, r-order subgroup)
  * G2: y^2 = x^3 + 4(u+1) over Fp2 (M-type twist; w^6 = xi so the untwist
    (x, y) -> (x/w^2, y/w^3) lands on E(Fp12))
  * ate pairing: Miller loop over |x| (x = -0xd201000000010000; the sign is
    a final conjugation), generic affine line functions in E(Fp12)

The port's copy of tpusnark/curves/bls12381.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ._subgroup import ladder_mul_raw as _ladder_mul_raw

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_ABS = 0xD201000000010000  # BLS parameter |x|; x < 0

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


def finv(a: int) -> int:
    return pow(a, -1, P)


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero():
        return Fp2(0, 0)

    @staticmethod
    def one():
        return Fp2(1, 0)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fp2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self):
        return self * self

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def mul_xi(self):
        """* (u + 1)."""
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def inv(self):
        d = finv((self.c0 * self.c0 + self.c1 * self.c1) % P)
        return Fp2(self.c0 * d, -self.c1 * d)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def pow(self, e: int):
        res, base = Fp2.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def __repr__(self):
        return f"Fp2({self.c0:#x}, {self.c1:#x})"


XI = Fp2(1, 1)


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one():
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        """* v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return Fp6(self.c2.mul_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_xi()
        t1 = a2.square().mul_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + (a2 * t1).mul_xi() + (a1 * t2).mul_xi()).inv()
        return Fp6(t0 * d, t1 * d, t2 * d)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero():
        return Fp12(Fp6.zero(), Fp6.zero())

    @staticmethod
    def one():
        return Fp12(Fp6.one(), Fp6.zero())

    @staticmethod
    def from_fp(x: int):
        return Fp12(Fp6(Fp2(x, 0), Fp2.zero(), Fp2.zero()), Fp6.zero())

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fp12(a0 * b0 + (a1 * b1).mul_by_v(), a0 * b1 + a1 * b0)

    def square(self):
        return self * self

    def conj(self):
        return Fp12(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        d = (a0.square() - a1.square().mul_by_v()).inv()
        return Fp12(a0 * d, -(a1 * d))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fp12.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_one(self):
        return self == Fp12.one()


# w^2 = v, w^3 = v*w as Fp12 elements (for the untwist)
W2 = Fp12(Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()), Fp6.zero())  # v
W3 = Fp12(Fp6.zero(), Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()))  # v*w
W2_INV = W2.inv()
W3_INV = W3.inv()


# ------------------------------------------------------------------ G1 / G2
class G1:
    """Affine ops over Python ints. Infinity = None. y^2 = x^3 + 4."""

    B = 4

    @staticmethod
    def generator():
        return G1_GEN

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
                return G1.double(p1)
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
                acc = G1.add(acc, p1)
            p1 = G1.double(p1)
            k >>= 1
        return acc

    @staticmethod
    def is_on_curve(p1) -> bool:
        if p1 is None:
            return True
        x, y = p1
        return (y * y - x * x * x - G1.B) % P == 0

    @staticmethod
    def in_subgroup(p1) -> bool:
        """[r]P == O without mul()'s mod-r reduction (mul(P, R) would be
        a vacuous multiply-by-zero)."""
        return _ladder_mul_raw(G1, p1, R) is None


class G2:
    """Affine ops over Fp2 pairs. y^2 = x^3 + 4(u+1)."""

    B = XI * 4

    @staticmethod
    def generator():
        (x0, x1), (y0, y1) = G2_GEN
        return (Fp2(x0, x1), Fp2(y0, y1))

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
                return G2.double(p1)
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
        m = x1.square() * 3 * (y1 + y1).inv()
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
                acc = G2.add(acc, p1)
            p1 = G2.double(p1)
            k >>= 1
        return acc

    @staticmethod
    def is_on_curve(p1) -> bool:
        if p1 is None:
            return True
        x, y = p1
        return (y.square() - x.square() * x - G2.B).is_zero()

    @staticmethod
    def in_subgroup(p1) -> bool:
        """[r]P == O without mul()'s mod-r reduction (see G1)."""
        return _ladder_mul_raw(G2, p1, R) is None


# ------------------------------------------------------------------ pairing
def _untwist(q):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x/w^2, y/w^3); valid since w^6 = xi."""
    x, y = q
    xw = Fp12(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())
    yw = Fp12(Fp6(y, Fp2.zero(), Fp2.zero()), Fp6.zero())
    return (xw * W2_INV, yw * W3_INV)


def _line(t, q, p12):
    """l_{t,q} evaluated at p12 = (x, y) in E(Fp12); returns Fp12."""
    x1, y1 = t
    x2, y2 = q
    xp, yp = p12
    if x1 == x2 and y1 == y2:
        m = x1.square() * Fp12.from_fp(3) * (y1 + y1).inv()
    elif x1 == x2:
        return xp - x1  # vertical
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    return m * (xp - x1) - (yp - y1)


def _ec12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            m = x1.square() * Fp12.from_fp(3) * (y1 + y1).inv()
        else:
            return None
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def miller_loop(p, q) -> Fp12:
    """f_{|x|, Q}(P) for P in G1, Q in G2 (affine, not None)."""
    xp, yp = Fp12.from_fp(p[0]), Fp12.from_fp(p[1])
    q12 = _untwist(q)
    t = q12
    f = Fp12.one()
    for bit in bin(X_ABS)[3:]:
        f = f.square() * _line(t, t, (xp, yp))
        t = _ec12_add(t, t)
        if bit == "1":
            f = f * _line(t, q12, (xp, yp))
            t = _ec12_add(t, q12)
    # x < 0: f_{x} = conj(f_{|x|}) up to the final exponentiation
    return f.conj()


def final_exp(f: Fp12) -> Fp12:
    # easy part: f^((p^6-1)(p^2+1))
    f1 = f.conj() * f.inv()  # f^(p^6 - 1)
    f2 = f1.pow(P * P) * f1  # ^(p^2 + 1)
    # hard part (generic; fine for a host verifier)
    return f2.pow((P**4 - P**2 + 1) // R)


def pairing(p, q) -> Fp12:
    if p is None or q is None:
        return Fp12.one()
    return final_exp(miller_loop(p, q))


def multi_pairing(pairs) -> Fp12:
    """prod e(P_i, Q_i): shared final exponentiation."""
    f = Fp12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(p, q)
    return final_exp(f)
