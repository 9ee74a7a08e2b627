"""In-circuit BN254 optimal ate pairing over emulated Fp towers.

The std/algebra/emulated sw_bn254 pairing analog
(gnark/std/algebra/emulated/sw_bn254/pairing.go): Miller loop
f_{6x+2,Q}(P) with Frobenius correction lines + final exponentiation, all
over `Fp12Tower` (gadgets/fields_tower.py) — the substrate the reference's
recursion verifier (gnark/std/recursion/groth16/verifier.go:36)
builds on.

Geometry: G2 points stay in AFFINE TWIST coordinates E'(Fp2). For the
D-twist untwist (x, y) -> (x w^2, y w^3), a line through twist points with
twist-slope lam evaluated at a lifted G1 point (xp, yp) is SPARSE:

    l = yp  -  (lam * xp) w  +  (lam * x_T - y_T) w^3

(three of six w-power coefficients), so each step costs one e2 inversion
(the affine slope) + a handful of e2 muls + one e12 mul to fold into f.
The twist Frobenius pi(x, y) = (conj(x) xi^((p-1)/3), conj(y) xi^((p-1)/2))
replaces the host oracle's full-Fp12 Frobenius (curves/ref.py:_frob12).

Final exponentiation: easy part in closed form (conj/inv/frobenius^2), hard
part f^((p^4-p^2+1)/r) by plain square-and-multiply over the constant
exponent — correct but the dominant cost; swapping in the x-addition-chain
(3 pow-by-x calls) is the known optimization, tracked as future work.

The port's copy of tpusnark/gadgets/pairing.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.ref import ATE_LOOP, R
from ..curves.ref import P as BN_P
from ..curves.ref import Fp2 as HostFp2
from .emulated import EmuElement
from .fields_tower import _XI, E2, E12, Fp12Tower

# twist-Frobenius constants (compile-time host Fp2 values)
_TW_X = _XI.pow((BN_P - 1) // 3)  # multiplies conj(x)
_TW_Y = _XI.pow((BN_P - 1) // 2)  # multiplies conj(y)
_TW2_X = _XI.pow((BN_P * BN_P - 1) // 3)  # pi^2 x-twist (in Fp)
_TW2_Y = _XI.pow((BN_P * BN_P - 1) // 2)  # pi^2 y-twist (in Fp)

_HARD_EXP = (BN_P**4 - BN_P**2 + 1) // R


@dataclass
class G1Point:
    x: EmuElement
    y: EmuElement


@dataclass
class G2Point:
    x: E2
    y: E2


class PairingGadget(Fp12Tower):
    # ------------------------------------------------------------- builders
    def g1_point(self, x: int, y: int) -> G1Point:
        return G1Point(self.F.constant(x), self.F.constant(y))

    def g2_point(self, x: HostFp2, y: HostFp2) -> G2Point:
        return G2Point(self.e2_from_host(x), self.e2_from_host(y))

    # ------------------------------------------------------ line evaluation
    def _sparse_line(self, lam: E2, T: G2Point, P: G1Point) -> E12:
        """l = -yp + (lam xp) w + (y_T - lam x_T) w^3 — the untwisted
        m(xt - x1) - (yt - y1) of the host oracle (curves/ref.py:_line) in
        sparse form; folded with a generic e12 mul (a dedicated mul_by_034
        is the cheaper specialization, reference e12_pairing.go)."""
        F = self.F
        zero = self.e2(0, 0)
        c0 = E2(F.neg(P.y), F.constant(0))
        c1 = E2(F.mul(lam.c0, P.x), F.mul(lam.c1, P.x))
        c3 = self.e2_sub(T.y, self.e2_mul(lam, T.x))
        return self._unflatten([c0, c1, zero, c3, zero, zero])

    def _double_step(self, T: G2Point, P: G1Point) -> tuple[G2Point, E12]:
        """Tangent line at T; returns (2T, line)."""
        x, y = T.x, T.y
        x2 = self.e2_square(x)
        num = self.e2_add(self.e2_add(x2, x2), x2)  # 3x^2
        lam = self.e2_mul(num, self.e2_inv(self.e2_add(y, y)))
        line = self._sparse_line(lam, T, P)
        x3 = self.e2_sub(self.e2_square(lam), self.e2_add(x, x))
        y3 = self.e2_sub(self.e2_mul(lam, self.e2_sub(x, x3)), y)
        return G2Point(x3, y3), line

    def _add_step(self, T: G2Point, Q: G2Point, P: G1Point) -> tuple[G2Point, E12]:
        """Chord line through T and Q; returns (T+Q, line)."""
        lam = self.e2_mul(
            self.e2_sub(Q.y, T.y), self.e2_inv(self.e2_sub(Q.x, T.x))
        )
        line = self._sparse_line(lam, T, P)
        x3 = self.e2_sub(self.e2_sub(self.e2_square(lam), T.x), Q.x)
        y3 = self.e2_sub(self.e2_mul(lam, self.e2_sub(T.x, x3)), T.y)
        return G2Point(x3, y3), line

    def _twist_frob(self, Q: G2Point) -> G2Point:
        return G2Point(
            self.e2_mul(self.e2_conj(Q.x), self.e2_from_host(_TW_X)),
            self.e2_mul(self.e2_conj(Q.y), self.e2_from_host(_TW_Y)),
        )

    def _twist_frob2_neg(self, Q: G2Point) -> G2Point:
        """-pi^2(Q): pi^2 twists by Fp constants, then negate y."""
        return G2Point(
            self.e2_mul(Q.x, self.e2_from_host(_TW2_X)),
            self.e2_neg(self.e2_mul(Q.y, self.e2_from_host(_TW2_Y))),
        )

    # ------------------------------------------------------------- pairing
    def miller_loop(self, P: G1Point, Q: G2Point) -> E12:
        """f_{6x+2,Q}(P), same schedule as the host oracle
        (curves/ref.py:miller_loop) but in twist coordinates."""
        T = Q
        f = self.e12_one()
        first = True
        for bit in bin(ATE_LOOP)[3:]:
            if first:
                # f = 1: skip the leading square-and-mul, f := line
                T, f = self._double_step(T, P)
                first = False
            else:
                f = self.e12_square(f)
                T, line = self._double_step(T, P)
                f = self.e12_mul(f, line)
            if bit == "1":
                T, line = self._add_step(T, Q, P)
                f = self.e12_mul(f, line)
        Q1 = self._twist_frob(Q)
        Q2 = self._twist_frob2_neg(Q)
        T, line = self._add_step(T, Q1, P)
        f = self.e12_mul(f, line)
        _, line = self._add_step(T, Q2, P)
        return self.e12_mul(f, line)

    def _pow_const(self, a: E12, e: int) -> E12:
        res = None
        base = a
        while e:
            if e & 1:
                res = base if res is None else self.e12_mul(res, base)
            e >>= 1
            if e:
                base = self.e12_square(base)
        return res if res is not None else self.e12_one()

    def final_exp(self, f: E12) -> E12:
        # easy part: f^((p^6-1)(p^2+1))
        t = self.e12_mul(self.e12_conj(f), self.e12_inv(f))
        t = self.e12_mul(self.e12_frobenius_square(t), t)
        # hard part: t^((p^4-p^2+1)/r)
        return self._pow_const(t, _HARD_EXP)

    def pairing_check(self, pairs: list[tuple[G1Point, G2Point]]):
        """Assert prod e(P_i, Q_i) == 1 — the form every pairing-based
        verifier reduces to (reference pairing.go PairingCheck)."""
        assert pairs, "pairing_check needs at least one (G1, G2) pair"
        acc = None
        for P, Q in pairs:
            m = self.miller_loop(P, Q)
            acc = m if acc is None else self.e12_mul(acc, m)
        self.e12_assert_eq(self.final_exp(acc), self.e12_one())
