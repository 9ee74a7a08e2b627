"""Pure-Python BW6-761 reference implementation: fields, curves, pairing.

The OUTER curve of the reference's native 2-chain: its scalar field r equals
BLS12-377's base field p, so BLS12-377 G1/G2 coordinate arithmetic is NATIVE
inside a BW6-761 circuit (gnark/std/algebra/native/sw_bls12377,
curve list backend/backend.go:28-33).

Embedding degree 6: BOTH G1 and G2 live over the 761-bit prime field Fp
(G2 on a sextic twist that is itself defined over Fp) — structurally unlike
the BLS12 curves, which is why CurveConfig carries a `g2_over_fp` flag.

Parameters (p from the reference's emparams.go:235; r = BLS12-377 p;
everything else derived and verified computationally — see
tests/test_bw6_bls377.py):
  * E:  y^2 = x^3 - 1 over Fp; trace t found by the Hasse-interval scan
    t = ((p+1) mod r) + 13 r; r | #E; cofactor h1 = #E / r
  * E': y^2 = x^3 + 4 over Fp (sextic twist, M-type with zeta = -4:
    b' = b * zeta); order p + 1 - (t + 3f)/2 with 4p = t^2 + 3 f^2
  * Fp6 = Fp[w]/(w^6 + 4); untwist (x, y) -> (x/w^2, y/w^3) lands on E
    ((y^2 - x^3)/w^6 = 4/-4 = -1)
  * ate pairing: generic Miller loop over T = t - 1, generic final
    exponentiation (p^6-1)/r (host oracle; not performance-relevant)
  * generators: cofactor-cleared first curve points (x=2 for G1, x=1 for
    G2) — self-consistent, not the arkworks constants

The port's copy of tpusnark/curves/bw6761.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ._subgroup import ladder_mul_raw as _ladder_mul_raw

P = 0x122E824FB83CE0AD187C94004FAFF3EB926186A81D14688528275EF8087BE41707BA638E584E91903CEBAFF25B423048689C8ED12F9FD9071DCD3DC73EBFF2E98A116C25667A8F8160CF8AEEAF0A437E6913E6870000082F49D00000000008B
R = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001

# trace of Frobenius: t = ((p+1) mod r) + 13*r (Hasse-interval scan,
# verified by [p+1-t]P == O for random P on E)
TRACE = ((P + 1) % R) + 13 * R
N1 = P + 1 - TRACE  # #E(Fp)
H1 = N1 // R
import math as _math

_F = _math.isqrt((4 * P - TRACE * TRACE) // 3)
assert _F * _F == (4 * P - TRACE * TRACE) // 3
N2 = P + 1 - (TRACE + 3 * _F) // 2  # #E'(Fp) (verified twist order)
H2 = N2 // R
assert N1 % R == 0 and N2 % R == 0

ZETA = -4  # w^6 = -4; sextic twist scale (b' = b * zeta = 4)

G1_GEN = (
    0x00D82CBF66753123ED25942FFADBEC116B901330673728468B1653FEBAE12AA13A5D68DC240A36CFBE185365ABC6CB0CC5042C14BE9179F0C6C05FC952C93A806D5316C2B601DB66BD557011EB2C7DD0C1891418E3CE0E512DA946C2CA98C56F,
    0x00A62FD67FDD91E327A96C02BC80385547A171B11241A2653B54D7359CD7569806B159FD05975390F644CD4D4D121918F1F84BE0E364C557F196BD4095E732D987CA22009BA7577B80AAA35B641488679ED9EF0D43B32E776AD507137F20A2DD,
)
G2_GEN = (
    0xB57E4C181F2D61F9F68074B8B339DA2DA5CB0F398DAD1A696575790F81A64889E99E92B694535070923045A2BD226BE5A65F563E88E9F685B5F9B1D81E5D0CD3DCF42709AE8D9248FA04FC72B6A0FFCA5C80D003FCFA9292828EE95ECACBB5,
    0x3F609C495A48128E3CF2BD0AB9787D1705D28490477BDABEEAD9E6FC7DE49F3A6970349D49F707907D40FC3EFCAA7732083A01BE7F055989F11722DC140BF09AB25BF2F51D5BC9DE212766CEF77476EA0A2FD992D1D929FF03DDFF74690C96,
)


def finv(a: int) -> int:
    return pow(a, -1, P)


class Fp6:
    """Fp[w]/(w^6 + 4): direct sextic extension, coeffs little-endian."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = tuple(x % P for x in c)
        assert len(self.c) == 6

    @staticmethod
    def zero():
        return Fp6((0, 0, 0, 0, 0, 0))

    @staticmethod
    def one():
        return Fp6((1, 0, 0, 0, 0, 0))

    @staticmethod
    def from_fp(x: int):
        return Fp6((x, 0, 0, 0, 0, 0))

    @staticmethod
    def w_pow(k: int):
        """w^k = w^(k mod 6) * (-4)^(k // 6)."""
        c = [0] * 6
        c[k % 6] = pow(ZETA % P, k // 6, P)
        return Fp6(c)

    def __eq__(self, o):
        return self.c == o.c

    def __add__(self, o):
        return Fp6(tuple(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return Fp6(tuple(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return Fp6(tuple(-a for a in self.c))

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp6(tuple(a * o for a in self.c))
        out = [0] * 11
        for i, a in enumerate(self.c):
            if a == 0:
                continue
            for j, b in enumerate(o.c):
                out[i + j] += a * b
        # reduce w^k for k >= 6: w^6 = -4
        for k in range(10, 5, -1):
            out[k - 6] += ZETA * out[k]
        return Fp6(tuple(out[:6]))

    __rmul__ = __mul__

    def square(self):
        return self * self

    def inv(self):
        """Via the resultant trick: a^-1 = adj / norm using a^(s) products.
        Simpler (and fast enough for a host oracle): extended Euclid over
        the polynomial ring is avoided by norm-exponentiation:
        a^-1 = a^(q-2) with q = p^6 would be huge; instead use
        a^-1 = conj_prod / N where conj_prod = prod_{i=1..5} a^(p^i) and
        N = a * conj_prod in Fp."""
        cp = None
        for i in range(1, 6):
            fi = self.frobenius(i)
            cp = fi if cp is None else cp * fi
        n = (self * cp).c
        # N must be in Fp (all higher coeffs zero)
        assert all(x == 0 for x in n[1:]), "norm not in Fp"
        d = finv(n[0])
        return cp * d

    def frobenius(self, k: int = 1):
        """a^(p^k): coeff i picks up (w^i)^(p^k - 1) = gamma_i^k with
        gamma_i = (-4)^(i (p-1) / 6) (p = 1 mod 6)."""
        out = []
        for i, a in enumerate(self.c):
            g = pow(ZETA % P, (i * (pow(P, k) - 1) // 6) % (P - 1), P)
            out.append(a * g)
        return Fp6(tuple(out))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fp6.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_zero(self):
        return all(x == 0 for x in self.c)

    def is_one(self):
        return self == Fp6.one()


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
            """[r]P == O without mul()'s mod-r reduction (mul(P, R)
            would be a vacuous multiply-by-zero)."""
            return _ladder_mul_raw(_G, p1, R) is None

    _G.__name__ = name.upper()
    return _G


G1 = _make_group(-1, "g1")  # y^2 = x^3 - 1
G2 = _make_group(4, "g2")  # y^2 = x^3 + 4 (sextic twist over Fp)


# ------------------------------------------------------------------ pairing
_W2_INV = Fp6((0, 0, 1, 0, 0, 0)).inv()  # 1/w^2
_W3_INV = Fp6((0, 0, 0, 1, 0, 0)).inv()  # 1/w^3


def _untwist(q):
    """E'(Fp) -> E(Fp6): (x, y) -> (x/w^2, y/w^3)."""
    x, y = q
    return (Fp6.from_fp(x) * _W2_INV, Fp6.from_fp(y) * _W3_INV)


def _line(t, q, pxy):
    x1, y1 = t
    x2, y2 = q
    xp, yp = pxy
    if x1 == x2 and y1 == y2:
        m = x1.square() * 3 * (y1 + y1).inv()
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
            m = x1.square() * 3 * (y1 + y1).inv()
        else:
            return None
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def miller_loop(p, q) -> Fp6:
    """f_{T, Q}(P) with T = t - 1 (ate loop), P in G1, Q in G2 affine."""
    pxy = (Fp6.from_fp(p[0]), Fp6.from_fp(p[1]))
    q6 = _untwist(q)
    t = q6
    f = Fp6.one()
    T = TRACE - 1
    for bit in bin(T)[3:]:
        f = f.square() * _line(t, t, pxy)
        t = _ec6_add(t, t)
        if bit == "1":
            f = f * _line(t, q6, pxy)
            t = _ec6_add(t, q6)
    return f


def final_exp(f: Fp6) -> Fp6:
    # easy part: f^((p^3-1)(p+1)); hard part: (p^2-p+1)/r (generic)
    f1 = f.frobenius(3) * f.inv()  # f^(p^3 - 1)
    f2 = f1.frobenius(1) * f1  # ^(p + 1)
    return f2.pow((P * P - P + 1) // R)


def pairing(p, q) -> Fp6:
    if p is None or q is None:
        return Fp6.one()
    return final_exp(miller_loop(p, q))


def multi_pairing(pairs) -> Fp6:
    f = Fp6.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(p, q)
    return final_exp(f)
