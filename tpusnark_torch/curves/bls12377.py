"""Pure-Python BLS12-377 reference implementation: fields, curves, pairing.

The inner curve of the reference's native 2-chain (BLS12-377 proofs verified
inside BW6-761 circuits — gnark/std/algebra/native/sw_bls12377,
curve list backend/backend.go:28-33). Third curve instantiation through the
shared FieldSpec-parametrized device kernels (after BN254/BLS12-381),
structure mirrors `bls12381.py`.

Parameters, all derived and verified from the seed x = 0x8508c00000000001
(r = x^4 - x^2 + 1, p = (x-1)^2 r / 3 + x; p/r match the reference's
emparams.go:123,137):
  * Fp2 = Fp[u]/(u^2 + 5)     (-5 is a QNR mod p; verified)
  * G1: y^2 = x^3 + 1; cofactor (x-1)^2/3; generator = cofactor-cleared
    first curve point at x = 1 (matches the standard zexe/arkworks gen)
  * G2: y^2 = x^3 + 1/u over Fp2 (D-type twist, xi = u); order/cofactor
    verified against #E'(Fp2) = p^2 + 1 - (t2 - 3f2)/2; generator =
    cofactor-cleared first curve point at x = (2, 0)
  * ate pairing: Miller loop over x (x > 0: no final conjugation),
    untwist (x, y) -> (x*w^2, y*w^3) into E(Fp12), w^6 = u

The port's copy of tpusnark/curves/bls12377.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ._subgroup import ladder_mul_raw as _ladder_mul_raw

P = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
X_SEED = 0x8508C00000000001  # positive

G1_GEN = (
    0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
)
# derived (cofactor-cleared x=(2,0) point); NOT the arkworks constant — any
# order-r G2 point is a valid generator for this module's self-contained use
G2_GEN = (
    (
        0x00415ABB1137C88935BB08884AEE7B99049F123BF27DCE03401724764CD34F4D20A7C4C78130D2D07FAAB58C9B87BDA9,
        0x00A272C24CA7D3429D9F07B86366D6EA24148CD0D42BEBA1A208C4859CF3630F4DE60B0C0F56B5E10DDF884B60D27F88,
    ),
    (
        0x0199275DEFAACC0DB97BC0E7237BBB97F523908ED09DA02F4AC4EF1A54A524D933CC6492B66B5EE576521EBBBB23EE23,
        0x0121CB2668F07EAA4752E212F85ED167509504B67EF09DF578536C115AC38999E66E6D2DF31CBE0CEB2F80AC9C3A8051,
    ),
)

NR = -5  # Fp2 nonresidue: u^2 = -5


def finv(a: int) -> int:
    return pow(a, -1, P)


class Fp2:
    """Fp[u]/(u^2 + 5)."""

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
        return Fp2(
            self.c0 * o.c0 - 5 * self.c1 * o.c1,
            self.c0 * o.c1 + self.c1 * o.c0,
        )

    __rmul__ = __mul__

    def square(self):
        return self * self

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def inv(self):
        d = finv((self.c0 * self.c0 + 5 * self.c1 * self.c1) % P)
        return Fp2(self.c0 * d, -self.c1 * d)

    def mul_xi(self):
        """* u (the Fp6 nonresidue xi = u): (c0 + c1 u) u = -5 c1 + c0 u."""
        return Fp2(-5 * self.c1, self.c0)

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
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"


XI = Fp2(0, 1)  # v^3 = xi = u
B2 = XI.inv()  # twist coefficient: b' = 1/u


class Fp6:
    """Fp2[v]/(v^3 - u)."""

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
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
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
    """Fp6[w]/(w^2 - v)."""

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


# w^2 = v, w^3 = v*w as Fp12 elements (for the D-type untwist: MULTIPLY)
W2 = Fp12(Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()), Fp6.zero())  # v
W3 = Fp12(Fp6.zero(), Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()))  # v*w


# ------------------------------------------------------------------ G1 / G2
class G1:
    """Affine ops over Python ints. Infinity = None. y^2 = x^3 + 1."""

    B = 1

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
        """[r]P == O without mul()'s mod-r scalar reduction (mul(P, R)
        reduces to mul by 0 and would pass vacuously)."""
        return _ladder_mul_raw(G1, p1, R) is None


class G2:
    """Affine ops over Fp2 pairs. y^2 = x^3 + 1/u (D-type twist)."""

    B = B2

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
        """[r]P == O without mul()'s mod-r reduction (see G1.in_subgroup)."""
        return _ladder_mul_raw(G2, p1, R) is None


# ------------------------------------------------------------------ pairing
def _untwist(q):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x*w^2, y*w^3); D-type, w^6 = u."""
    x, y = q
    xw = Fp12(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())
    yw = Fp12(Fp6(y, Fp2.zero(), Fp2.zero()), Fp6.zero())
    return (xw * W2, yw * W3)


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
    """f_{x, Q}(P) for P in G1, Q in G2 (affine, not None); x > 0."""
    xp, yp = Fp12.from_fp(p[0]), Fp12.from_fp(p[1])
    q12 = _untwist(q)
    t = q12
    f = Fp12.one()
    for bit in bin(X_SEED)[3:]:
        f = f.square() * _line(t, t, (xp, yp))
        t = _ec12_add(t, t)
        if bit == "1":
            f = f * _line(t, q12, (xp, yp))
            t = _ec12_add(t, q12)
    return f


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
