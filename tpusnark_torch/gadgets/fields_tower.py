"""In-circuit BN254 extension-field towers over emulated Fp.

The std/algebra/emulated `fields_bn254` analog
(gnark/std/algebra/emulated/fields_bn254/e2.go, e6.go, e12.go):
Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - xi) with xi = 9+u,
Fp12 = Fp6[w]/(w^2 - v) — the same tower as the host oracle
(curves/ref.py), every coefficient an `EmuElement` carried by
native circuit variables (gadgets/emulated.py does limb decomposition,
carry checks and reductions).

This is the arithmetic substrate for in-circuit pairing / recursion
verifiers (gnark/std/recursion/groth16/verifier.go:36): towers +
Frobenius here, the Miller loop in gadgets/pairing.py.

Frobenius: for z = sum_k c_k w^k (c_k in Fp2, k<6), z^p =
sum_k conj(c_k) * g_k * w^k with g_k = xi^(k(p-1)/6) — the g_k (and the
p^2-power analogs) are compile-time constants computed with the host Fp2.

The port's copy of tpusnark/gadgets/fields_tower.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.ref import P as BN_P
from ..curves.ref import Fp2 as HostFp2
from ..fields.spec import BN254_FP
from .emulated import EmuElement, EmulatedField, EmuParams

_XI = HostFp2(9, 1)
# gamma1[k] = xi^(k*(p-1)/6): Frobenius twists per w-power
_G1 = [_XI.pow(k * (BN_P - 1) // 6) for k in range(6)]
# gamma2[k] = xi^(k*(p^2-1)/6): the p^2-Frobenius twists (elements of Fp)
_G2 = [_XI.pow(k * (BN_P * BN_P - 1) // 6) for k in range(6)]


@dataclass
class E2:
    c0: EmuElement
    c1: EmuElement


@dataclass
class E6:
    c0: E2
    c1: E2
    c2: E2


@dataclass
class E12:
    c0: E6
    c1: E6


class Fp12Tower:
    """Tower ops bound to a circuit api (Builder / PlonkBuilder / TestEngine).

    Cost model (emulated fp muls): e2 mul = 3 (Karatsuba), e6 mul = 18,
    e12 mul = 54; inversions bottom out in ONE fp inverse hint.
    """

    def __init__(self, api, limb_bits: int = 64):
        self.api = api
        self.F = EmulatedField(api, EmuParams.for_modulus(BN254_FP.modulus, limb_bits))

    # ------------------------------------------------------------------ E2
    def e2(self, c0: int, c1: int) -> E2:
        return E2(self.F.constant(c0), self.F.constant(c1))

    def e2_from_host(self, h: HostFp2) -> E2:
        return self.e2(h.c0, h.c1)

    def e2_add(self, a: E2, b: E2) -> E2:
        return E2(self.F.add(a.c0, b.c0), self.F.add(a.c1, b.c1))

    def e2_sub(self, a: E2, b: E2) -> E2:
        return E2(self.F.sub(a.c0, b.c0), self.F.sub(a.c1, b.c1))

    def e2_neg(self, a: E2) -> E2:
        return E2(self.F.neg(a.c0), self.F.neg(a.c1))

    def e2_conj(self, a: E2) -> E2:
        return E2(a.c0, self.F.neg(a.c1))

    def e2_mul(self, a: E2, b: E2) -> E2:
        F = self.F
        # Karatsuba over u^2 = -1: 3 fp muls (reference e2.go Mul)
        t0 = F.mul(a.c0, b.c0)
        t1 = F.mul(a.c1, b.c1)
        t2 = F.mul(F.add(a.c0, a.c1), F.add(b.c0, b.c1))
        return E2(F.sub(t0, t1), F.sub(t2, F.add(t0, t1)))

    def e2_square(self, a: E2) -> E2:
        F = self.F
        # (a+b)(a-b), 2ab — 2 fp muls
        t0 = F.mul(F.add(a.c0, a.c1), F.sub(a.c0, a.c1))
        t1 = F.mul(a.c0, a.c1)
        return E2(t0, F.add(t1, t1))

    def _x9(self, a: EmuElement) -> EmuElement:
        # 9a by doubling chain (8a + a): adds only bump overflow, no hints
        F = self.F
        a2 = F.add(a, a)
        a4 = F.add(a2, a2)
        a8 = F.add(a4, a4)
        return F.add(a8, a)

    def e2_mul_xi(self, a: E2) -> E2:
        # * (9 + u): (9a - b, a + 9b)
        F = self.F
        return E2(F.sub(self._x9(a.c0), a.c1), F.add(a.c0, self._x9(a.c1)))

    def e2_inv(self, a: E2) -> E2:
        F = self.F
        norm = F.add(F.mul(a.c0, a.c0), F.mul(a.c1, a.c1))
        t = F.inverse(norm)
        return E2(F.mul(a.c0, t), F.neg(F.mul(a.c1, t)))

    def e2_assert_eq(self, a: E2, b: E2):
        self.F.assert_is_equal(a.c0, b.c0)
        self.F.assert_is_equal(a.c1, b.c1)

    def e2_value(self, a: E2) -> HostFp2:
        """Engine-side only."""
        return HostFp2(self.F.to_value(a.c0), self.F.to_value(a.c1))

    # ------------------------------------------------------------------ E6
    def e6(self, *cs: E2) -> E6:
        return E6(*cs)

    def e6_zero(self) -> E6:
        return E6(self.e2(0, 0), self.e2(0, 0), self.e2(0, 0))

    def e6_one(self) -> E6:
        return E6(self.e2(1, 0), self.e2(0, 0), self.e2(0, 0))

    def e6_add(self, a: E6, b: E6) -> E6:
        return E6(
            self.e2_add(a.c0, b.c0), self.e2_add(a.c1, b.c1), self.e2_add(a.c2, b.c2)
        )

    def e6_sub(self, a: E6, b: E6) -> E6:
        return E6(
            self.e2_sub(a.c0, b.c0), self.e2_sub(a.c1, b.c1), self.e2_sub(a.c2, b.c2)
        )

    def e6_neg(self, a: E6) -> E6:
        return E6(self.e2_neg(a.c0), self.e2_neg(a.c1), self.e2_neg(a.c2))

    def e6_mul(self, a: E6, b: E6) -> E6:
        # same shape as the host oracle (ref.py Fp6.__mul__)
        m = self.e2_mul
        xi = self.e2_mul_xi
        add = self.e2_add
        c0 = add(m(a.c0, b.c0), xi(add(m(a.c1, b.c2), m(a.c2, b.c1))))
        c1 = add(add(m(a.c0, b.c1), m(a.c1, b.c0)), xi(m(a.c2, b.c2)))
        c2 = add(add(m(a.c0, b.c2), m(a.c1, b.c1)), m(a.c2, b.c0))
        return E6(c0, c1, c2)

    def e6_mul_by_v(self, a: E6) -> E6:
        return E6(self.e2_mul_xi(a.c2), a.c0, a.c1)

    def e6_inv(self, a: E6) -> E6:
        m, xi, sub, add = self.e2_mul, self.e2_mul_xi, self.e2_sub, self.e2_add
        t0 = sub(self.e2_square(a.c0), xi(m(a.c1, a.c2)))
        t1 = sub(xi(self.e2_square(a.c2)), m(a.c0, a.c1))
        t2 = sub(self.e2_square(a.c1), m(a.c0, a.c2))
        d = add(m(a.c0, t0), add(xi(m(a.c1, t2)), xi(m(a.c2, t1))))
        di = self.e2_inv(d)
        return E6(m(t0, di), m(t1, di), m(t2, di))

    # ----------------------------------------------------------------- E12
    def e12_one(self) -> E12:
        return E12(self.e6_one(), self.e6_zero())

    def e12_add(self, a: E12, b: E12) -> E12:
        return E12(self.e6_add(a.c0, b.c0), self.e6_add(a.c1, b.c1))

    def e12_mul(self, a: E12, b: E12) -> E12:
        t0 = self.e6_mul(a.c0, b.c0)
        t1 = self.e6_mul(a.c1, b.c1)
        c0 = self.e6_add(t0, self.e6_mul_by_v(t1))
        c1 = self.e6_add(self.e6_mul(a.c0, b.c1), self.e6_mul(a.c1, b.c0))
        return E12(c0, c1)

    def e12_square(self, a: E12) -> E12:
        return self.e12_mul(a, a)

    def e12_conj(self, a: E12) -> E12:
        return E12(a.c0, self.e6_neg(a.c1))

    def e12_inv(self, a: E12) -> E12:
        d = self.e6_sub(self.e6_mul(a.c0, a.c0), self.e6_mul_by_v(self.e6_mul(a.c1, a.c1)))
        di = self.e6_inv(d)
        return E12(self.e6_mul(a.c0, di), self.e6_neg(self.e6_mul(a.c1, di)))

    def e12_assert_eq(self, a: E12, b: E12):
        for x, y in (
            (a.c0.c0, b.c0.c0),
            (a.c0.c1, b.c0.c1),
            (a.c0.c2, b.c0.c2),
            (a.c1.c0, b.c1.c0),
            (a.c1.c1, b.c1.c1),
            (a.c1.c2, b.c1.c2),
        ):
            self.e2_assert_eq(x, y)

    # ------------------------------------------------------------ Frobenius
    def _flatten(self, z: E12) -> list[E2]:
        """w-power coefficients: z = sum_k c_k w^k with w^2 = v."""
        return [z.c0.c0, z.c1.c0, z.c0.c1, z.c1.c1, z.c0.c2, z.c1.c2]

    def _unflatten(self, cs: list[E2]) -> E12:
        return E12(E6(cs[0], cs[2], cs[4]), E6(cs[1], cs[3], cs[5]))

    def e12_frobenius(self, z: E12) -> E12:
        """z^p: conjugate each Fp2 coefficient, twist by gamma1[k]."""
        out = []
        for k, c in enumerate(self._flatten(z)):
            cc = self.e2_conj(c)
            out.append(cc if k == 0 else self.e2_mul(cc, self.e2_from_host(_G1[k])))
        return self._unflatten(out)

    def e12_frobenius_square(self, z: E12) -> E12:
        """z^(p^2): twist by gamma2[k] (no conjugation: conj o conj = id)."""
        out = []
        for k, c in enumerate(self._flatten(z)):
            out.append(c if k == 0 else self.e2_mul(c, self.e2_from_host(_G2[k])))
        return self._unflatten(out)

    # -------------------------------------------------------------- values
    def e12_from_host(self, h) -> E12:
        """Lift a host ref.Fp12 constant (or engine value) into the circuit."""
        return E12(
            E6(*(self.e2_from_host(c) for c in (h.c0.c0, h.c0.c1, h.c0.c2))),
            E6(*(self.e2_from_host(c) for c in (h.c1.c0, h.c1.c1, h.c1.c2))),
        )

    def e12_value(self, a: E12):
        """Engine-side only: host Fp12 value."""
        from ..curves.ref import Fp6 as HostFp6
        from ..curves.ref import Fp12 as HostFp12

        return HostFp12(
            HostFp6(*(self.e2_value(c) for c in (a.c0.c0, a.c0.c1, a.c0.c2))),
            HostFp6(*(self.e2_value(c) for c in (a.c1.c0, a.c1.c1, a.c1.c2))),
        )
