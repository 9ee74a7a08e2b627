"""Pure-Python BN254: fields, curves, pairing.

In the port this module is the *oracle and verifier backend*: the role gnark-crypto's
native Go/asm implementation plays for the reference (SURVEY.md §2.5; pairing
used at gnark/backend/groth16/bn254/verify.go:71-135). Every device
kernel result is checked against this module, and proof verification (pairing,
not perf-critical — SURVEY.md §2.5 "verifier can stay on host") runs here.

All textbook algorithms, written from scratch:
  * Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 9+u; Fp12 = Fp6[w]/(w^2 - v)
  * G1: y^2 = x^3 + 3 over Fp (prime order r, cofactor 1)
  * G2: y^2 = x^3 + 3/xi over Fp2 (D-type twist)
  * optimal ate pairing: Miller loop over 6x+2 with the two Frobenius
    correction lines, lifted to E(Fp12) via the untwist (x,y)->(x w^2, y w^3)

A frozen copy of tpusnark_torch/curves/ref.py for the benchmark's reference:
the code as it stood when the benchmark was defined, so that a change to the
port's host curve code cannot move the yardstick. ``g1_mul_jacobian`` is the
benchmark's own (the input generator's scalar multiplications).
"""

from __future__ import annotations

from dataclasses import dataclass

# --- curve constants ---------------------------------------------------------
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_X = 4965661367192848881  # BN parameter t; r = 36t^4+36t^3+18t^2+6t+1
ATE_LOOP = 6 * BN_X + 2

G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def finv(a: int) -> int:
    return pow(a, -1, P)


# --- Fp2 ---------------------------------------------------------------------
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
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        return Fp2(a * c - b * d, a * d + b * c)

    __rmul__ = __mul__

    def square(self):
        a, b = self.c0, self.c1
        return Fp2((a + b) * (a - b), 2 * a * b)

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def inv(self):
        a, b = self.c0, self.c1
        t = finv(a * a + b * b)
        return Fp2(a * t, -b * t)

    def mul_xi(self):
        # * (9 + u)
        a, b = self.c0, self.c1
        return Fp2(9 * a - b, a + 9 * b)

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
        return f"Fp2({self.c0},{self.c1})"


XI = Fp2(9, 1)


# --- Fp6 ---------------------------------------------------------------------
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
        return Fp6(
            a0 * b0 + (a1 * b2 + a2 * b1).mul_xi(),
            a0 * b1 + a1 * b0 + (a2 * b2).mul_xi(),
            a0 * b2 + a1 * b1 + a2 * b0,
        )

    def square(self):
        return self * self

    def mul_by_v(self):
        # * v  (v^3 = xi)
        return Fp6(self.c2.mul_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_xi()
        t1 = (a2.square()).mul_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        d = a0 * t0 + (a1 * t2).mul_xi() + (a2 * t1).mul_xi()
        di = d.inv()
        return Fp6(t0 * di, t1 * di, t2 * di)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


# --- Fp12 --------------------------------------------------------------------
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
        # x^(p^6): w -> -w
        return Fp12(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        d = a0.square() - (a1.square()).mul_by_v()
        di = d.inv()
        return Fp12(a0 * di, -(a1 * di))

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


# w and w^2, w^3 as Fp12 elements (w^2 = v)
W = Fp12(Fp6.zero(), Fp6.one())
W2 = Fp12(Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()), Fp6.zero())  # v
W3 = Fp12(Fp6.zero(), Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()))  # v*w


# --- generic affine curve ops over a field class -----------------------------
# points are (x, y) tuples or None for infinity


def ec_add(p1, p2, field_add, field_sub, field_mul, field_inv, field_eq):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if field_eq(x1, x2):
        if field_eq(y1, y2):
            return ec_double(p1, field_add, field_sub, field_mul, field_inv)
        return None
    m = field_mul(field_sub(y2, y1), field_inv(field_sub(x2, x1)))
    x3 = field_sub(field_sub(field_mul(m, m), x1), x2)
    y3 = field_sub(field_mul(m, field_sub(x1, x3)), y1)
    return (x3, y3)


def ec_double(p1, field_add, field_sub, field_mul, field_inv):
    if p1 is None:
        return None
    x1, y1 = p1
    three_x2 = field_mul(field_mul(x1, x1), 3) if isinstance(x1, int) else (x1 * x1) * 3
    m = field_mul(three_x2, field_inv(field_add(y1, y1)))
    x3 = field_sub(field_sub(field_mul(m, m), x1), x1)
    y3 = field_sub(field_mul(m, field_sub(x1, x3)), y1)
    return (x3, y3)


# --- G1 (over Fp, ints) ------------------------------------------------------
class G1:
    """Affine G1 ops over Python ints. Infinity = None."""

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
        m = (y2 - y1) * finv(x2 - x1) % P
        x3 = (m * m - x1 - x2) % P
        y3 = (m * (x1 - x3) - y1) % P
        return (x3, y3)

    @staticmethod
    def double(p1):
        if p1 is None:
            return None
        x1, y1 = p1
        if y1 == 0:
            return None
        m = 3 * x1 * x1 * finv(2 * y1) % P
        x3 = (m * m - 2 * x1) % P
        y3 = (m * (x1 - x3) - y1) % P
        return (x3, y3)

    @staticmethod
    def neg(p1):
        if p1 is None:
            return None
        return (p1[0], (-p1[1]) % P)

    @staticmethod
    def mul(p1, k: int):
        k %= R
        res, base = None, p1
        while k:
            if k & 1:
                res = G1.add(res, base)
            base = G1.double(base)
            k >>= 1
        return res

    @staticmethod
    def msm(points, scalars):
        acc = None
        for pt, s in zip(points, scalars):
            acc = G1.add(acc, G1.mul(pt, s))
        return acc

    @staticmethod
    def on_curve(p1):
        if p1 is None:
            return True
        x, y = p1
        return (y * y - x * x * x - 3) % P == 0

    @staticmethod
    def generator():
        return G1_GEN


# --- G2 (over Fp2) -----------------------------------------------------------
B2 = Fp2(3, 0) * XI.inv()  # 3/(9+u)


class G2:
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
        x3 = m.square() - x1 - x2
        y3 = m * (x1 - x3) - y1
        return (x3, y3)

    @staticmethod
    def double(p1):
        if p1 is None:
            return None
        x1, y1 = p1
        if y1.is_zero():
            return None
        m = (x1.square() * 3) * (y1 * 2).inv()
        x3 = m.square() - x1 - x1
        y3 = m * (x1 - x3) - y1
        return (x3, y3)

    @staticmethod
    def neg(p1):
        if p1 is None:
            return None
        return (p1[0], -p1[1])

    @staticmethod
    def mul(p1, k: int):
        k %= R
        res, base = None, p1
        while k:
            if k & 1:
                res = G2.add(res, base)
            base = G2.double(base)
            k >>= 1
        return res

    @staticmethod
    def on_curve(p1):
        if p1 is None:
            return True
        x, y = p1
        return y.square() == x.square() * x + B2

    @staticmethod
    def in_subgroup(p1) -> bool:
        """r-torsion membership: [r]P == O, WITHOUT the mod-r scalar
        reduction G2.mul applies (mul(P, r) would be mul by 0 and vacuously
        pass). BN254 G2 has cofactor != 1 so on-curve does not imply
        subgroup (reference checks inside Verify,
        gnark/backend/groth16/bn254/verify.go:61)."""
        if p1 is None:
            return True
        if not G2.on_curve(p1):
            return False
        res, base, k = None, p1, R
        while k:
            if k & 1:
                res = G2.add(res, base)
            base = G2.double(base)
            k >>= 1
        return res is None

    @staticmethod
    def generator():
        return (Fp2(*G2_GEN[0]), Fp2(*G2_GEN[1]))


# --- pairing -----------------------------------------------------------------
def _untwist(q):
    """E'(Fp2) -> E(Fp12): (x,y) -> (x*w^2, y*w^3)."""
    if q is None:
        return None
    x, y = q
    xl = Fp12(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())
    yl = Fp12(Fp6(y, Fp2.zero(), Fp2.zero()), Fp6.zero())
    return (xl * W2, yl * W3)


def _lift_g1(p):
    if p is None:
        return None
    return (Fp12.from_fp(p[0]), Fp12.from_fp(p[1]))


def _frob12(z: Fp12) -> Fp12:
    return z.pow(P)


def _ec12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _ec12_double(p1)
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _ec12_double(p1):
    x1, y1 = p1
    m = (x1 * x1) * Fp12.from_fp(3) * (y1 + y1).inv()
    x3 = m * m - x1 - x1
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (E(Fp12) affine) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1) * Fp12.from_fp(3) * (y1 + y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(p, q) -> Fp12:
    """Optimal ate Miller loop f_{6x+2,Q}(P) with Frobenius correction lines."""
    if p is None or q is None:
        return Fp12.one()
    Q = _untwist(q)
    Pt = _lift_g1(p)
    T = Q
    f = Fp12.one()
    for bit in bin(ATE_LOOP)[3:]:  # MSB-1 downto 0
        f = f * f * _line(T, T, Pt)
        T = _ec12_double(T)
        if bit == "1":
            f = f * _line(T, Q, Pt)
            T = _ec12_add(T, Q)
    # correction lines with pi(Q), -pi^2(Q)
    Q1 = (_frob12(Q[0]), _frob12(Q[1]))
    Q2 = (_frob12(Q1[0]), -_frob12(Q1[1]))  # -pi^2(Q)
    f = f * _line(T, Q1, Pt)
    T = _ec12_add(T, Q1)
    f = f * _line(T, Q2, Pt)
    return f


_FINAL_EXP_HARD = (P**4 - P**2 + 1) // R


def final_exp(f: Fp12) -> Fp12:
    # easy part: f^((p^6-1)(p^2+1))
    f1 = f.conj() * f.inv()  # f^(p^6-1)
    f2 = f1.pow(P * P) * f1  # ^(p^2+1)
    # hard part (naive pow; fine for a host verifier)
    return f2.pow(_FINAL_EXP_HARD)


def pairing(p, q) -> Fp12:
    """e(P, Q) with P in G1 (int pair), Q in G2 (Fp2 pair)."""
    return final_exp(miller_loop(p, q))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with a single shared final exponentiation."""
    acc = Fp12.one()
    for p, q in pairs:
        acc = acc * miller_loop(p, q)
    return final_exp(acc).is_one()


# --- the input generator's scalar multiplication --------------------------------
def _jac_double(X, Y, Z):
    """2 (X, Y, Z) in Jacobian coordinates on y^2 = x^3 + 3 (dbl-2009-l)."""
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A, B = X * X % P, Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return (X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P)


def _jac_add_affine(X1, Y1, Z1, x2, y2):
    """(X1, Y1, Z1) + (x2, y2), the second point affine (madd-2007-bl)."""
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    r = 2 * (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _jac_double(X1, Y1, Z1) if r == 0 else (1, 1, 0)
    HH = H * H % P
    I = 4 * HH % P
    J, V = H * I % P, X1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % P
    return (X3, Y3, ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P)


def g1_mul_jacobian(pt, k: int):
    """k * pt on G1 (affine in and out, None the identity): double-and-add
    from the top bit in Jacobian coordinates with one inversion at the end,
    the same point as ``G1.mul``."""
    k %= R
    if pt is None or k == 0:
        return None
    X, Y, Z = 1, 1, 0
    for bit in bin(k)[2:]:
        X, Y, Z = _jac_double(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jac_add_affine(X, Y, Z, *pt)
    if Z == 0:
        return None
    zi = finv(Z)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)
