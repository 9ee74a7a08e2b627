"""Shared frontend API surface built from the primitive ops.

Completes the reference's 50-method frontend.API
(gnark/frontend/api.go:26-162) with the derived methods — each is
written purely against the primitive builder surface (add/mul/select/
is_zero/to_binary/...), so ONE implementation serves the R1CS builder, the
Plonkish builder, and the big-int test engine (the reference re-implements
these per builder; frontend/cs/r1cs/api.go, scs/api.go, test/engine.go).

The port's copy of tpusnark/frontend/api_ext.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


class APIExtensions:
    # ---- arithmetic ---------------------------------------------------------
    def mul_acc(self, a, b, c):
        """a + b*c (reference api.go:43 MulAcc)."""
        return self.add(a, self.mul(b, c))

    def div_unchecked(self, a, b):
        """a/b with 0/0 = 0 allowed (api.go:55): res is the hint inverse
        product, constrained by res*b == a — no invertibility requirement."""
        ca, cb = self.constant_value(a), self.constant_value(b)
        if cb is not None:
            if cb == 0:
                assert ca == 0 or ca is None, "x/0 with x != 0"
                if ca == 0:
                    return 0
            else:
                return self.div(a, b)
        from ..constraint.hints import div_unchecked_hint

        (res,) = self.new_hint(div_unchecked_hint, 1, a, b)
        # ONE checked constraint res*b == a (gnark DivUnchecked is a single
        # R1C/gate, frontend/cs/r1cs/api.go:262); builders provide the
        # product-check primitive, the big-int engine never reaches here
        # (constants short-circuit above)
        self._assert_product(res, b, a)
        return res

    def _assert_product(self, x, y, z):
        """x*y == z as one constraint; builders may override (the generic
        form costs an extra multiplication wire)."""
        self.assert_is_equal(self.mul(x, y), z)

    def batch_invert(self, vals):
        """[1/v_i] via one batch hint + one product constraint each
        (api.go:157 BatchInverter)."""
        from ..constraint.hints import batch_invert_hint_factory

        if not vals:
            return []
        outs = self.new_hint(batch_invert_hint_factory(len(vals)), len(vals), *vals)
        for v, iv in zip(vals, outs):
            self.assert_is_equal(self.mul(v, iv), 1)
        return outs

    # ---- selection ----------------------------------------------------------
    def lookup2(self, b0, b1, i0, i1, i2, i3):
        """2-bit mux (api.go:98): returns i_{b1b0}."""
        self.assert_is_boolean(b0)
        self.assert_is_boolean(b1)
        t0 = self.select(b0, i1, i0)
        t1 = self.select(b0, i3, i2)
        return self.select(b1, t1, t0)

    # ---- comparison ---------------------------------------------------------
    def cmp(self, a, b, nbits: int | None = None):
        """-1/0/1 (as field values) for a < / == / > b, comparing canonical
        values bitwise from the MSB (reference frontend/cs/r1cs/api.go Cmp)."""
        nbits = nbits or self.field_bit_len()
        ba = self.to_binary(a, nbits)
        bb = self.to_binary(b, nbits)
        res = 0
        for i in range(nbits - 1, -1, -1):
            za = self.is_zero(ba[i])
            zb = self.is_zero(bb[i])
            a_gt = self.and_(ba[i], zb)
            b_gt = self.and_(bb[i], za)
            n = self.select(b_gt, -1, 0)
            m = self.select(a_gt, 1, n)
            res = self.select(self.is_zero(res), m, res)
        return res

    def field_bit_len(self) -> int:
        return self.p.bit_length()

    # ---- assertions ---------------------------------------------------------
    def assert_is_crumb(self, a):
        """a in {0,1,2,3} (api.go:125): (a^2-3a)(a^2-3a+2) == 0 — the
        reference's two-constraint formulation."""
        ca = self.constant_value(a)
        if ca is not None:
            assert ca in (0, 1, 2, 3), "constant not a crumb"
            return
        t = self.sub(self.mul(a, a), self.mul(a, 3))
        self.assert_is_equal(self.mul(t, self.add(t, 2)), 0)

    def is_boolean(self, a) -> bool:
        """Whether `a` is already known boolean (constrained or marked)."""
        ca = self.constant_value(a)
        if ca is not None:
            return ca in (0, 1)
        return self._bool_key(a) in self._booleans

    def mark_boolean(self, a):
        """Record (without constraining) that `a` is boolean — the caller
        guarantees it (api MarkBoolean); later assert_is_boolean calls
        become no-ops."""
        assert self.constant_value(a) is None, "constants need no marking"
        self._booleans.add(self._bool_key(a))

