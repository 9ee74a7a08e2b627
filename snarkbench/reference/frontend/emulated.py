"""Non-native ("emulated") field arithmetic over limb-decomposed elements.

The std/math/emulated analog (gnark/std/math/emulated/doc.go,
field.go, field_mul.go): emulate arithmetic mod an arbitrary modulus r inside
the native SNARK field. An element is k limbs of w bits (LSB first) with a
tracked per-element overflow. Multiplication/reduction correctness is proven
by a hint-computed quotient and a limb-convolution identity

    conv(x, y) == conv(q, r_limbs) + c        (as integers)

checked limb-wise with hint-computed signed carries (each carry constrained by
`acc_i == carry_{i+1} * 2^w` plus a shifted bit-range check, final carry 0).
This is the schoolbook variant of gnark's approach — sound without a
commitment-derived challenge, at O(k^2) products per mul (k is 4-5, so the
quadratic term is small).

Overflow discipline mirrors the reference: add/sub are native limb-wise ops
that grow the overflow; mul reduces its inputs first if needed; `reduce`
re-normalizes via a division hint.

A frozen copy of tpusnark_torch/gadgets/emulated.py for the benchmark's
reference compile: the same code, so that it emits the same constraints.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EmuParams:
    modulus: int      # r, the emulated modulus
    limb_bits: int    # w
    n_limbs: int      # k

    @classmethod
    def for_modulus(cls, r: int, limb_bits: int = 64):
        k = (r.bit_length() + limb_bits - 1) // limb_bits
        return cls(r, limb_bits, k)

    def decompose(self, v: int) -> list[int]:
        v %= self.modulus
        mask = (1 << self.limb_bits) - 1
        return [(v >> (i * self.limb_bits)) & mask for i in range(self.n_limbs)]

    def recompose(self, limbs: list[int]) -> int:
        return sum(int(l) << (i * self.limb_bits) for i, l in enumerate(limbs))


@dataclass
class EmuElement:
    limbs: list          # circuit vars or ints, LSB first
    overflow: int = 0    # limbs are < 2^(limb_bits + overflow)


class EmulatedField:
    """Field of operations mod params.modulus, carried by native circuit
    variables through `api` (Builder / PlonkBuilder / TestEngine)."""

    def __init__(self, api, params: EmuParams):
        self.api = api
        self.pr = params
        p_bits = api.p.bit_length() if hasattr(api, "p") else 254
        # native capacity head-room: limb values must stay << native modulus
        self.max_overflow = p_bits - 2 * params.limb_bits - params.n_limbs.bit_length() - 3
        assert self.max_overflow > 1, "limb width too large for native field"

    # ------------------------------------------------------------- builders
    def constant(self, v: int) -> EmuElement:
        return EmuElement(self.pr.decompose(v), 0)

    def from_limbs(self, limb_vars) -> EmuElement:
        """Adopt witness limbs, range-checking each to w bits (the normal-form
        contract for inputs, like gnark's enforceWidth)."""
        assert len(limb_vars) == self.pr.n_limbs
        for lv in limb_vars:
            self.api.to_binary(lv, self.pr.limb_bits)
        return EmuElement(list(limb_vars), 0)

    def to_value(self, el: EmuElement) -> int:
        """Engine-side only: integer value mod r."""
        return self.pr.recompose([int(l) for l in el.limbs]) % self.pr.modulus

    # ----------------------------------------------------------- arithmetic
    def add(self, a: EmuElement, b: EmuElement) -> EmuElement:
        a, b = self._match(a, b)
        limbs = [self.api.add(x, y) for x, y in zip(a.limbs, b.limbs)]
        out = EmuElement(limbs, max(a.overflow, b.overflow) + 1)
        return self.reduce(out) if out.overflow >= self.max_overflow else out

    def sub(self, a: EmuElement, b: EmuElement) -> EmuElement:
        """a - b via the padded subtraction of the reference (doc.go
        'Subtraction'): add a multiple of r whose every limb dominates b's."""
        a, b = self._match(a, b)
        pad = self._sub_padding(b.overflow)
        limbs = [
            self.api.add(x, self.api.sub(u, y))
            for x, y, u in zip(a.limbs, b.limbs, pad)
        ]
        out = EmuElement(limbs, max(a.overflow, b.overflow) + 2)
        return self.reduce(out) if out.overflow >= self.max_overflow else out

    def neg(self, a: EmuElement) -> EmuElement:
        return self.sub(self.constant(0), a)

    def mul(self, a: EmuElement, b: EmuElement) -> EmuElement:
        a = self.reduce(a) if a.overflow else a
        b = self.reduce(b) if b.overflow else b
        return self._mul_reduced(a, b)

    def square(self, a: EmuElement) -> EmuElement:
        return self.mul(a, a)

    def inverse(self, a: EmuElement) -> EmuElement:
        """1/a mod r (r must be prime); hint + product check a*inv == 1."""
        r = self.pr.modulus
        k, w = self.pr.n_limbs, self.pr.limb_bits

        def inv_hint(p, ins):
            v = self.pr.recompose(ins) % r
            return self.pr.decompose(pow(v, r - 2, r))

        a = self.reduce(a) if a.overflow else a
        outs = self.api.new_hint(inv_hint, k, *a.limbs)
        inv = self.from_limbs(outs)
        prod = self._mul_reduced(a, inv)
        self.assert_is_equal(prod, self.constant(1))
        return inv

    def div(self, a: EmuElement, b: EmuElement) -> EmuElement:
        return self.mul(a, self.inverse(b))

    def div_unchecked(self, a: EmuElement, b: EmuElement) -> EmuElement:
        """q with b*q == a (hint-supplied a/b). Unlike div(), b == 0 does
        NOT make the circuit unsatisfiable as long as a == 0 too (q is then
        unconstrained) — the branch-safe division complete point addition
        needs (reference discipline: std/math/emulated Div vs DivUnchecked
        in std/algebra, gnark/std/algebra/emulated/sw_emulated/
        point.go AddUnified)."""
        r = self.pr.modulus
        k = self.pr.n_limbs

        def div_hint(p, ins):
            av = self.pr.recompose(ins[:k]) % r
            bv = self.pr.recompose(ins[k:]) % r
            q = av * pow(bv, r - 2, r) % r if bv else 0
            return self.pr.decompose(q)

        a = self.reduce(a) if a.overflow else a
        b = self.reduce(b) if b.overflow else b
        outs = self.api.new_hint(div_hint, k, *a.limbs, *b.limbs)
        q = self.from_limbs(outs)
        self.assert_is_equal(self._mul_reduced(b, q), a)
        return q

    def select(self, cond, a: EmuElement, b: EmuElement) -> EmuElement:
        """cond ? a : b, limb-wise native selects (cond a native boolean)."""
        a = self.reduce(a) if a.overflow else a
        b = self.reduce(b) if b.overflow else b
        return EmuElement(
            [self.api.select(cond, x, y) for x, y in zip(a.limbs, b.limbs)], 0
        )

    # ------------------------------------------------------------ reduction
    def reduce(self, a: EmuElement) -> EmuElement:
        """Re-normalize: hint (q, rem) with value(a) == q*r + rem, rem in
        normal form; constrained by the convolution-carry identity."""
        r = self.pr.modulus
        k, w = self.pr.n_limbs, self.pr.limb_bits
        nq = self._quot_limbs(a.overflow)

        def reduce_hint(p, ins):
            v = self.pr.recompose(ins)
            q, rem = divmod(v, r)
            mask = (1 << w) - 1
            return [(q >> (i * w)) & mask for i in range(nq)] + self.pr.decompose(rem)

        outs = self.api.new_hint(reduce_hint, nq + k, *a.limbs)
        q_limbs, rem_limbs = outs[:nq], outs[nq:]
        for qv in q_limbs:
            self.api.to_binary(qv, w)
        rem = self.from_limbs(rem_limbs)
        # value(a) == conv(q, r_limbs) + rem
        rhs = self._conv_plus(q_limbs, self._r_limbs(nq), rem.limbs)
        self._assert_int_eq(a.limbs, rhs,
                            lhs_bound=w + a.overflow + 1,
                            rhs_bound=2 * w + nq.bit_length() + 1)
        return rem

    def assert_is_equal(self, a: EmuElement, b: EmuElement):
        """Value equality mod r: x - y divisible by r, via hint quotient
        (signed, handled by adding a dominating multiple of r first)."""
        a = self.reduce(a) if a.overflow else a
        b = self.reduce(b) if b.overflow else b
        r = self.pr.modulus
        k, w = self.pr.n_limbs, self.pr.limb_bits
        pad = self._sub_padding(0)  # multiple of r dominating normal-form b
        pad_val = self.pr.recompose(pad)
        nq = self._quot_limbs(2)

        def diff_hint(p, ins):
            xa, xb = ins[:k], ins[k:]
            d = self.pr.recompose(xa) + pad_val - self.pr.recompose(xb)
            q, rem = divmod(d, r)
            assert rem == 0, "assert_is_equal on unequal values"
            mask = (1 << w) - 1
            return [(q >> (i * w)) & mask for i in range(nq)]

        q_limbs = self.api.new_hint(diff_hint, nq, *a.limbs, *b.limbs)
        for qv in q_limbs:
            self.api.to_binary(qv, w)
        # a + pad - b == q * r  (as integers)
        lhs = [
            self.api.add(x, self.api.sub(u, y))
            for x, y, u in zip(a.limbs, b.limbs, pad)
        ]
        rhs = self._conv_plus(q_limbs, self._r_limbs(nq), [0] * k)
        self._assert_int_eq(lhs, rhs,
                            lhs_bound=w + 3,
                            rhs_bound=2 * w + nq.bit_length() + 1)

    def is_zero(self, a: EmuElement):
        """Boolean: value(a) == 0 mod r. Reduce to canonical rem then compare
        against both canonical representatives (0 and r would differ: after
        divmod rem < r, so rem == 0 iff value == 0)."""
        a = self.reduce(a) if a.overflow else a
        # reduce() guarantees rem = value mod r in [0, r): but from_limbs only
        # range-checks limbs; canonicality (rem < r) is enforced here
        self._assert_lt_modulus(a)
        flags = [self.api.is_zero(l) for l in a.limbs]
        acc = 1
        for f in flags:
            acc = self.api.mul(acc, f)
        return acc

    # ------------------------------------------------------------ internals
    def _match(self, a, b):
        return a, b

    def _r_limbs(self, nq: int) -> list[int]:
        mask = (1 << self.pr.limb_bits) - 1
        r = self.pr.modulus
        n = self.pr.n_limbs
        return [(r >> (i * self.pr.limb_bits)) & mask for i in range(n)]

    def _quot_limbs_for_bits(self, total_value_bits: int) -> int:
        """Limbs needed for q = value // r when value < 2^total_value_bits."""
        w = self.pr.limb_bits
        q_bits = max(1, total_value_bits - self.pr.modulus.bit_length() + 1)
        return (q_bits + w - 1) // w + 1

    def _quot_limbs(self, overflow: int) -> int:
        """Limbs for value/r given per-limb overflow f (value < 2^(wk+f+logk))."""
        w, k = self.pr.limb_bits, self.pr.n_limbs
        return self._quot_limbs_for_bits(w * k + overflow + k.bit_length() + 1)

    def _sub_padding(self, overflow: int) -> list[int]:
        """Multiple of r whose limbs each exceed 2^(w+overflow) (doc.go:
        'Subtraction'): u' = (2^(w+overflow), ...), u = u' + (r - u' mod r),
        regrouped to normal-ish form."""
        w, k = self.pr.limb_bits, self.pr.n_limbs
        r = self.pr.modulus
        base = 1 << (w + overflow + 1)
        u = sum(base << (w * i) for i in range(k))  # base at every limb
        adj = (-u) % r  # add limb-wise so every limb keeps dominating
        mask = (1 << w) - 1
        limbs = [base + ((adj >> (w * i)) & mask) for i in range(k)]
        assert sum(l << (w * i) for i, l in enumerate(limbs)) % r == 0
        assert all(l > (1 << (w + overflow)) for l in limbs)
        return limbs

    def _conv_plus(self, x, y_const, extra):
        """conv(x, y_const) + extra, as a list of 2k-ish limb variables."""
        n_out = len(x) + len(y_const) - 1
        out = [0] * max(n_out, len(extra))
        for i, xv in enumerate(x):
            for j, yc in enumerate(y_const):
                if yc:
                    out[i + j] = self.api.add(out[i + j], self.api.mul(xv, yc))
        for i, e in enumerate(extra):
            out[i] = self.api.add(out[i], e)
        return out

    def _mul_reduced(self, a: EmuElement, b: EmuElement) -> EmuElement:
        """Product of two normal-form elements with hint-computed (q, c):
        conv(a, b) == conv(q, r_limbs) + c."""
        r = self.pr.modulus
        k, w = self.pr.n_limbs, self.pr.limb_bits
        # product of two normal-form values < 2^(2wk)
        nq = self._quot_limbs_for_bits(2 * w * k + 1)

        def mul_hint(p, ins):
            xa, xb = ins[:k], ins[k:]
            prod = self.pr.recompose(xa) * self.pr.recompose(xb)
            q, c = divmod(prod, r)
            mask = (1 << w) - 1
            return [(q >> (i * w)) & mask for i in range(nq)] + self.pr.decompose(c)

        outs = self.api.new_hint(mul_hint, nq + k, *a.limbs, *b.limbs)
        q_limbs, c_limbs = outs[:nq], outs[nq:]
        for qv in q_limbs:
            self.api.to_binary(qv, w)
        c = self.from_limbs(c_limbs)
        # LHS: conv(a, b) with b variable — variable-variable products
        n_out = 2 * k - 1
        lhs = [0] * n_out
        for i, xv in enumerate(a.limbs):
            for j, yv in enumerate(b.limbs):
                lhs[i + j] = self.api.add(lhs[i + j], self.api.mul(xv, yv))
        rhs = self._conv_plus(q_limbs, self._r_limbs(nq), c.limbs)
        self._assert_int_eq(lhs, rhs,
                            lhs_bound=2 * w + k.bit_length(),
                            rhs_bound=2 * w + nq.bit_length() + 1)
        return c

    def _assert_int_eq(self, lhs, rhs, lhs_bound: int, rhs_bound: int):
        """Σ lhs_i 2^(wi) == Σ rhs_i 2^(wi) as INTEGERS: hint-computed signed
        carries, acc_i = lhs_i - rhs_i + carry_i must equal carry_{i+1}*2^w,
        carry range-checked via shifted bit decomposition, final carry 0."""
        api = self.api
        w = self.pr.limb_bits
        n = max(len(lhs), len(rhs))
        lhs = list(lhs) + [0] * (n - len(lhs))
        rhs = list(rhs) + [0] * (n - len(rhs))
        cb = max(lhs_bound, rhs_bound) - w + 2  # carry bit bound (signed)
        assert w + max(lhs_bound, rhs_bound) + 2 < api.p.bit_length() - 1

        def carry_hint(p, ins):
            half = len(ins) // 2
            carries = []
            c = 0
            for i in range(half):
                l_ = int(ins[i])
                r_ = int(ins[half + i])
                # values arrive mod p; they are true small ints by the bounds
                if l_ > p // 2:
                    l_ -= p
                if r_ > p // 2:
                    r_ -= p
                acc = l_ - r_ + c
                assert acc % (1 << w) == 0, "int-eq carry misalignment"
                c = acc >> w
                carries.append(c % p)
            assert c == 0, "int-eq final carry nonzero"
            return carries

        carries = api.new_hint(carry_hint, n, *lhs, *rhs)
        prev = 0
        for i in range(n):
            ci = carries[i]
            # range check: ci + 2^cb in [0, 2^(cb+1))
            api.to_binary(api.add(ci, 1 << cb), cb + 2)
            acc = api.add(api.sub(lhs[i], rhs[i]), prev)
            api.assert_is_equal(acc, api.mul(ci, 1 << w))
            prev = ci
        api.assert_is_equal(carries[-1], 0)

    def _assert_lt_modulus(self, a: EmuElement):
        """Canonicality: value(a) < r for a normal-form element, by the
        borrow-chain comparison against r's limbs."""
        api = self.api
        w, k = self.pr.limb_bits, self.pr.n_limbs
        # compute (r - 1 - a) limb-wise with borrows: a <= r-1
        r1 = self.pr.modulus - 1
        mask = (1 << w) - 1
        r1_limbs = [(r1 >> (i * w)) & mask for i in range(k)]

        def borrow_hint(p, ins):
            borrows = []
            b = 0
            for i in range(k):
                d = r1_limbs[i] - int(ins[i]) - b
                b = 1 if d < 0 else 0
                borrows.append(b)
            assert b == 0, "value >= modulus"
            return borrows

        borrows = api.new_hint(borrow_hint, k, *a.limbs)
        prev = 0
        for i in range(k):
            bi = borrows[i]
            api.assert_is_boolean(bi)
            # r1_i - a_i - prev + 2^w * bi must fit w bits
            diff = api.add(api.sub(r1_limbs[i], api.add(a.limbs[i], prev)),
                           api.mul(bi, 1 << w))
            api.to_binary(diff, w)
            prev = bi
        api.assert_is_equal(borrows[-1], 0)
