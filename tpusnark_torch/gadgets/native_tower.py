"""In-circuit Fp2/Fp6/Fp12 tower arithmetic for BLS12-377 over its NATIVE
base field — the 2-chain payoff.

A BW6-761 circuit's scalar field IS BLS12-377's base field
(r_BW6 = p_BLS377), so BLS12-377 coordinates and tower elements are plain
native circuit variables here: one constraint per Fp multiplication, versus
the ~100x cost of the limb-emulated tower in gadgets/emulated.py. This is
the reference's production recursion path
(gnark/std/algebra/native/sw_bls12377/ g1.go, g2.go, pairing.go;
std/recursion/groth16/verifier.go:36-40 instantiated over it).

Tower shape mirrors the host oracle curves/bls12377.py exactly
(Fp2 = Fp[u]/(u^2+5), Fp6 = Fp2[v]/(v^3-u), Fp12 = Fp6[w]/(w^2-v)); every
formula here is the host formula with ints replaced by circuit vars, and
the unit tests drive both against random elements.

Inversions are hint-supplied and constrained (x * x^-1 == 1 in the tower),
the reference's DivUnchecked discipline.

The port's copy of tpusnark/gadgets/native_tower.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..curves import bls12377 as host

P = host.P


class NFp2:
    """In-circuit Fp2 = Fp[u]/(u^2 + 5): pairs of native variables."""

    def __init__(self, api):
        self.api = api

    def const(self, c: "host.Fp2"):
        return (c.c0 % P, c.c1 % P)

    def add(self, a, b):
        api = self.api
        return (api.add(a[0], b[0]), api.add(a[1], b[1]))

    def sub(self, a, b):
        api = self.api
        return (api.sub(a[0], b[0]), api.sub(a[1], b[1]))

    def neg(self, a):
        api = self.api
        return (api.neg(a[0]), api.neg(a[1]))

    def mul(self, a, b):
        # Karatsuba: 3 native muls (c0 = t0 - 5 t1; c1 = t2 - t0 - t1)
        api = self.api
        t0 = api.mul(a[0], b[0])
        t1 = api.mul(a[1], b[1])
        t2 = api.mul(api.add(a[0], a[1]), api.add(b[0], b[1]))
        c0 = api.sub(t0, api.mul(t1, 5))
        c1 = api.sub(t2, api.add(t0, t1))
        return (c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def mul_fp(self, a, s):
        api = self.api
        return (api.mul(a[0], s), api.mul(a[1], s))

    def mul_const(self, a, c: "host.Fp2"):
        api = self.api
        # (a0 + a1 u)(c0 + c1 u) = a0 c0 - 5 a1 c1 + (a0 c1 + a1 c0) u
        r0 = api.sub(api.mul(a[0], c.c0 % P), api.mul(a[1], 5 * c.c1 % P))
        r1 = api.add(api.mul(a[0], c.c1 % P), api.mul(a[1], c.c0 % P))
        return (r0, r1)

    def mul_xi(self, a):
        """* u: (a0 + a1 u) u = -5 a1 + a0 u."""
        api = self.api
        return (api.mul(a[1], P - 5), a[0])

    def conj(self, a):
        return (a[0], self.api.neg(a[1]))

    def inv(self, a):
        """Hint-supplied inverse, constrained a * ainv == 1. The hint
        returns 0 for a == 0, which makes the product constraint
        unsatisfiable — inversion of zero is an (intended) proving
        failure, as in the host verifier."""
        api = self.api

        def inv_hint(p, ins):
            z = host.Fp2(int(ins[0]), int(ins[1]))
            if z.is_zero():
                return [0, 0]
            zi = z.inv()
            return [zi.c0, zi.c1]

        outs = api.new_hint(inv_hint, 2, a[0], a[1])
        ai = (outs[0], outs[1])
        prod = self.mul(a, ai)
        api.assert_is_equal(prod[0], 1)
        api.assert_is_equal(prod[1], 0)
        return ai

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def assert_eq(self, a, b):
        self.api.assert_is_equal(a[0], b[0])
        self.api.assert_is_equal(a[1], b[1])

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def select(self, cond, a, b):
        api = self.api
        return (api.select(cond, a[0], b[0]), api.select(cond, a[1], b[1]))


class NFp6:
    """Fp2[v]/(v^3 - u); elements are (c0, c1, c2) NFp2 triples."""

    def __init__(self, f2: NFp2):
        self.f2 = f2

    def const(self, c: "host.Fp6"):
        f2 = self.f2
        return (f2.const(c.c0), f2.const(c.c1), f2.const(c.c2))

    def add(self, a, b):
        f2 = self.f2
        return tuple(f2.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f2 = self.f2
        return tuple(f2.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.f2.neg(x) for x in a)

    def mul(self, a, b):
        f2 = self.f2
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = f2.mul(a0, b0)
        t1 = f2.mul(a1, b1)
        t2 = f2.mul(a2, b2)
        c0 = f2.add(
            t0,
            f2.mul_xi(
                f2.sub(
                    f2.mul(f2.add(a1, a2), f2.add(b1, b2)), f2.add(t1, t2)
                )
            ),
        )
        c1 = f2.add(
            f2.sub(f2.mul(f2.add(a0, a1), f2.add(b0, b1)), f2.add(t0, t1)),
            f2.mul_xi(t2),
        )
        c2 = f2.add(
            f2.sub(f2.mul(f2.add(a0, a2), f2.add(b0, b2)), f2.add(t0, t2)), t1
        )
        return (c0, c1, c2)

    def square(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        f2 = self.f2
        return (f2.mul_xi(a[2]), a[0], a[1])

    def inv(self, a):
        f2 = self.f2
        a0, a1, a2 = a
        t0 = f2.sub(f2.square(a0), f2.mul_xi(f2.mul(a1, a2)))
        t1 = f2.sub(f2.mul_xi(f2.square(a2)), f2.mul(a0, a1))
        t2 = f2.sub(f2.square(a1), f2.mul(a0, a2))
        d = f2.add(
            f2.mul(a0, t0),
            f2.add(f2.mul_xi(f2.mul(a2, t1)), f2.mul_xi(f2.mul(a1, t2))),
        )
        di = f2.inv(d)
        return (f2.mul(t0, di), f2.mul(t1, di), f2.mul(t2, di))

    def zero(self):
        z = self.f2.zero()
        return (z, z, z)

    def one(self):
        return (self.f2.one(), self.f2.zero(), self.f2.zero())


class NFp12:
    """Fp6[w]/(w^2 - v); elements are (c0, c1) NFp6 pairs."""

    def __init__(self, api):
        self.api = api
        self.f2 = NFp2(api)
        self.f6 = NFp6(self.f2)
        # frobenius constants C_k = u^(k (p-1)/6) for basis slot w^k,
        # computed with the HOST tower and validated by tests against
        # host Fp12.pow(P)
        e = (P - 1) // 6
        u = host.Fp2(0, 1)
        self._frob_c = [u.pow(e * k) for k in range(6)]

    def const(self, c: "host.Fp12"):
        return (self.f6.const(c.c0), self.f6.const(c.c1))

    def from_fp(self, x):
        f2 = self.f2
        z2 = f2.zero()
        return (((x, 0), z2, z2), (z2, z2, z2))

    def add(self, a, b):
        f6 = self.f6
        return (f6.add(a[0], b[0]), f6.add(a[1], b[1]))

    def sub(self, a, b):
        f6 = self.f6
        return (f6.sub(a[0], b[0]), f6.sub(a[1], b[1]))

    def mul(self, a, b):
        f6 = self.f6
        a0, a1 = a
        b0, b1 = b
        t0 = f6.mul(a0, b0)
        t1 = f6.mul(a1, b1)
        c0 = f6.add(t0, f6.mul_by_v(t1))
        # Karatsuba for the cross term
        c1 = f6.sub(
            f6.mul(f6.add(a0, a1), f6.add(b0, b1)), f6.add(t0, t1)
        )
        return (c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def conj(self, a):
        return (a[0], self.f6.neg(a[1]))

    def inv(self, a):
        f6 = self.f6
        a0, a1 = a
        d = f6.sub(f6.square(a0), f6.mul_by_v(f6.square(a1)))
        di = f6.inv(d)
        return (f6.mul(a0, di), f6.neg(f6.mul(a1, di)))

    def one(self):
        return (self.f6.one(), self.f6.zero())

    def assert_eq(self, a, b):
        f2 = self.f2
        for c_a, c_b in zip(a, b):
            for x, y in zip(c_a, c_b):
                f2.assert_eq(x, y)

    def assert_eq_const(self, a, c: "host.Fp12"):
        self.assert_eq(a, self.const(c))

    # ------------------------------------------------------------ frobenius
    def _slots(self, a):
        """Basis view: slot k (coefficient of w^k) for k in 0..5 — the
        (c_i, a_j) lattice maps as w^(2j + i)."""
        (a0, a1, a2), (b0, b1, b2) = a
        return [a0, b0, a1, b1, a2, b2]

    def _from_slots(self, s):
        return ((s[0], s[2], s[4]), (s[1], s[3], s[5]))

    def frobenius(self, a, power: int = 1):
        """f -> f^(p^power) for power 1 or 2: slot k maps to
        conj^power(slot_k) * C_k^(...), with host-computed constants."""
        f2 = self.f2
        out = []
        for k, z in enumerate(self._slots(a)):
            if power == 1:
                c = self._frob_c[k]
                out.append(f2.mul_const(f2.conj(z), c))
            elif power == 2:
                c = self._frob_c[k] * self._frob_c[k].conj()
                out.append(f2.mul_const(z, c))
            else:
                raise ValueError("power must be 1 or 2")
        return self._from_slots(out)

    # ------------------------------------------------------------ exponents
    def pow_const(self, a, e: int):
        """a^e for a host-known positive exponent (square-and-multiply)."""
        assert e > 0
        bits = bin(e)[3:]
        acc = a
        for b in bits:
            acc = self.square(acc)
            if b == "1":
                acc = self.mul(acc, a)
        return acc

    # ---------------------------------------------------------- final exp
    def final_exp_3h(self, f):
        """finalexp(f)^3 = f^(3 (p^12 - 1)/r) — the BLS12 final
        exponentiation up to a cube. Sound for pairing-product checks:
        gcd(3, r) = 1 makes cubing injective on the r-th roots of unity, so
        finalexp(F) == c  <=>  finalexp(F)^3 == c^3.

        Easy part f^((p^6-1)(p^2+1)) then the hard part via the verified
        identity 3h' = (x-1)^2 (x+p) (x^2+p^2-1) + 3 (checked numerically
        in tests against (p^4-p^2+1)/r):
            g = easy(f);  out = ((g^(x-1))^(x-1))^(x+p) ^(x^2+p^2-1) * g^3
        where ^(x+p) = (.)^x * frob(.) and ^(p^2) = frob2."""
        x = host.X_SEED
        # easy: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
        f1 = self.mul(self.conj(f), self.inv(f))
        g = self.mul(self.frobenius(f1, 2), f1)
        # hard
        t = self.pow_const(g, x - 1)
        t = self.pow_const(t, x - 1)
        t = self.mul(self.pow_const(t, x), self.frobenius(t, 1))  # ^(x+p)
        # ^(x^2 + p^2 - 1) = ((.)^x)^x * frob2(.) * (.)^-1
        t2 = self.pow_const(self.pow_const(t, x), x)
        t = self.mul(self.mul(t2, self.frobenius(t, 2)), self.inv(t))
        g3 = self.mul(self.mul(g, g), g)
        return self.mul(t, g3)
