"""Circuit-definition frontend: the gnark `frontend.API` analog.

Reference surface being reproduced: the 50-method circuit DSL
(gnark/frontend/api.go:26-150) and the R1CS builder's
linear-expression value representation with constant folding
(gnark/frontend/cs/r1cs/builder.go:55-75, api.go). Pythonic rather
than struct-tag reflection: inputs are declared with `public()` / `secret()`
and the circuit body is ordinary Python calling API methods.

Values are either python ints (compile-time constants, like gnark's
ConstantValue path) or `Var`s holding a linear combination of wires.
add/sub/scale are free (no constraints); mul/div/inverse emit R1Cs whose
single unknown the solver derives.

The port's copy of tpusnark/frontend/builder.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constraint.system import COEFF_ONE, ConstraintSystem


@dataclass(frozen=True)
class Var:
    """A linear combination of wires: tuple of (coeff_id, wire_id)."""

    terms: tuple


from .api_ext import APIExtensions


class Builder(APIExtensions):
    def _bool_key(self, a):
        return a.terms

    def println(self, *vals):
        """Record a log entry resolved at solve time (reference api.go:136,
        log storage constraint/core.go:98, resolution solver.go:248-318).
        Resolved strings land in cs.solve_logs after solve()."""
        entry = []
        for v in vals:
            cv = self.constant_value(v)
            entry.append(("const", cv) if cv is not None else ("lin", self._lin(v)))
        self.cs.logs.append(entry)

    def __init__(self, modulus: int):
        self.cs = ConstraintSystem(modulus)
        self.p = modulus
        self._booleans: set = set()  # vids known boolean (dedup constraint)
        self._deferred: list = []  # compile-time callbacks (gnark Defer)
        self.kv: dict = {}  # gadget-shared state (gnark internal/kvstore)

    def defer_(self, fn):
        """Register fn(api) to run at compile() before finalize (gnark
        frontend Compiler.Defer, frontend/compile.go:133 callDeferred —
        used by lookup tables and the range checker to emit their closing
        argument once all queries are known)."""
        self._deferred.append(fn)

    # ----------------------------------------------------------------- inputs
    def public(self, name: str) -> Var:
        return Var(((COEFF_ONE, self.cs.add_public(name)),))

    def secret(self, name: str) -> Var:
        return Var(((COEFF_ONE, self.cs.add_secret(name)),))

    # ------------------------------------------------------------ conversions
    def _lin(self, v) -> list:
        """Any value -> linear expression (list of (cid, vid))."""
        if isinstance(v, Var):
            return list(v.terms)
        c = int(v) % self.p
        if c == 0:
            return []
        return [(self.cs.coeff_id(c), 0)]

    def constant_value(self, v):
        """int if v is a compile-time constant, else None."""
        if not isinstance(v, Var):
            return int(v) % self.p
        if all(vid == 0 for _, vid in v.terms):
            return sum(self.cs.coeffs[cid] for cid, _ in v.terms) % self.p
        return None

    def _merge(self, terms) -> Var:
        acc: dict[int, int] = {}
        for cid, vid in terms:
            acc[vid] = (acc.get(vid, 0) + self.cs.coeffs[cid]) % self.p
        out = tuple(
            (self.cs.coeff_id(c), vid) for vid, c in sorted(acc.items()) if c != 0
        )
        return Var(out)

    def _scale(self, v, c: int):
        c = c % self.p
        if c == 0:
            return 0
        terms = [
            (self.cs.coeff_id(self.cs.coeffs[cid] * c % self.p), vid)
            for cid, vid in self._lin(v)
        ]
        return self._merge(terms)

    def _new_wire_var(self) -> tuple[Var, int]:
        w = self.cs.new_internal()
        return Var(((COEFF_ONE, w),)), w

    # --------------------------------------------------------------- arithmetic
    def add(self, a, b, *rest):
        vals = [a, b, *rest]
        if all(not isinstance(v, Var) for v in vals):
            return sum(int(v) for v in vals) % self.p
        terms = []
        for v in vals:
            terms.extend(self._lin(v))
        return self._merge(terms)

    def sub(self, a, b, *rest):
        out = self.add(a, self.neg(b))
        for r in rest:
            out = self.add(out, self.neg(r))
        return out

    def neg(self, a):
        if not isinstance(a, Var):
            return (-int(a)) % self.p
        return self._scale(a, self.p - 1)

    def mul(self, a, b, *rest):
        out = self._mul2(a, b)
        for r in rest:
            out = self._mul2(out, r)
        return out

    def _mul2(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            return ca * cb % self.p
        if ca is not None:
            return self._scale(b, ca)
        if cb is not None:
            return self._scale(a, cb)
        o, w = self._new_wire_var()
        self.cs.add_r1c(self._lin(a), self._lin(b), self._lin(o), solved_wire=w)
        return o

    def div(self, a, b):
        """a / b; UNSATISFIABLE when b == 0, even for 0/0. gnark Div emits an
        extra b * bInv = 1 constraint to force b != 0
        (gnark/frontend/cs/r1cs/api.go:286-303); without it the
        solver would happily assign 0 to the quotient of 0/0 (solveR1C's
        zero-divisor branch just checks a*b == c). div_unchecked (api_ext)
        keeps the single-constraint form."""
        cb = self.constant_value(b)
        if cb is not None:
            return self._scale(a, pow(cb, -1, self.p)) if cb else self._err_div0()
        b_inv = self.inverse(b)
        ca = self.constant_value(a)
        if ca is not None:
            return self._scale(b_inv, ca)
        o, w = self._new_wire_var()
        self.cs.add_r1c(self._lin(a), self._lin(b_inv), self._lin(o), solved_wire=w)
        return o

    def _err_div0(self):
        raise ZeroDivisionError("division by constant zero in circuit")

    def _assert_product(self, x, y, z):
        """x*y == z as ONE pure-check R1C (no solved wire)."""
        self.cs.add_r1c(self._lin(x), self._lin(y), self._lin(z))

    def inverse(self, a):
        """1/a as ONE constraint a * inv = 1 (solver fails when a == 0) —
        gnark Inverse (gnark/frontend/cs/r1cs/api.go:322-344)."""
        ca = self.constant_value(a)
        if ca is not None:
            if ca == 0:
                self._err_div0()
            return pow(ca, -1, self.p)
        o, w = self._new_wire_var()
        self.cs.add_r1c(self._lin(a), self._lin(o), self._lin(1), solved_wire=w)
        return o

    def square(self, a):
        return self.mul(a, a)

    # ----------------------------------------------------------------- boolean
    def assert_is_boolean(self, a):
        if not isinstance(a, Var):
            assert int(a) % self.p in (0, 1), "constant not boolean"
            return
        key = a.terms
        if key in self._booleans:
            return
        self._booleans.add(key)
        one_minus = self.sub(1, a)
        self.cs.add_r1c(self._lin(a), self._lin(one_minus), [], dbg="assertIsBoolean")

    def and_(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        return self.mul(a, b)

    def or_(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        return self.sub(self.add(a, b), self.mul(a, b))

    def xor(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        return self.sub(self.add(a, b), self.mul(2, self.mul(a, b)))

    def select(self, cond, a, b):
        """cond ? a : b (cond boolean)."""
        self.assert_is_boolean(cond)
        return self.add(b, self.mul(cond, self.sub(a, b)))

    def is_zero(self, a):
        """1 if a == 0 else 0 (hint + 2 constraints, gnark IsZero shape)."""
        ca = self.constant_value(a)
        if ca is not None:
            return 1 if ca == 0 else 0
        from ..constraint.hints import inv_hint

        (inv_w,) = self.cs.add_hint(inv_hint, [self._lin(a)], 1)
        inv = Var(((COEFF_ONE, inv_w),))
        b = self.sub(1, self.mul(a, inv))  # 1 - a*inv
        # enforce b * a == 0  (if a != 0 then b must be 0)
        self.cs.add_r1c(self._lin(b), self._lin(a), [], dbg="isZero")
        return b

    # ------------------------------------------------------------- commitments
    def commit(self, *vals) -> Var:
        """BSB22 commitment to the wires of `vals`; returns an in-circuit
        random-oracle challenge bound to them (gnark frontend Commit,
        gnark/frontend/cs/r1cs/api.go:683 + commitment.go:15).

        Committed wires are collected sorted and deduplicated; public inputs
        are hashed by the verifier directly, private wires go into the
        Pedersen commitment, earlier commitment wires are re-committed by
        challenge value (like the reference). The hint output wire is
        replaced by the real Pedersen-commit + hash-to-field at prove time."""
        from ..constraint.hints import bsb22_placeholder
        from ..constraint.system import Groth16Commitment

        prior = {c.commitment_index for c in self.cs.commitments}
        wires: set[int] = set()
        for v in vals:
            for _, vid in self._lin(v):
                if vid != 0:  # never commit to the constant-one wire
                    wires.add(vid)
        # private wires already committed by an earlier commitment: commit to
        # that commitment's wire instead (reference api.go:752-758)
        for c in self.cs.commitments:
            committed = set(c.private_committed)
            overlap = wires & committed
            if overlap:
                wires -= overlap
                wires.add(c.commitment_index)
        pub = sorted(w for w in wires if self.cs._wire_kind[w] == "pub")
        com = sorted(w for w in wires if w in prior)
        priv = sorted(w for w in wires if self.cs._wire_kind[w] != "pub" and w not in prior)
        if not (pub or com or priv):
            raise ValueError("must commit to at least one variable")

        idx = len(self.cs.commitments)
        inputs = [[(self.cs.coeff_id(idx), 0)]]  # commitment depth as constant
        inputs += [[(COEFF_ONE, w)] for w in pub + com + priv]
        (out_w,) = self.cs.add_hint(bsb22_placeholder, inputs, 1)
        self.cs.commitments.append(
            Groth16Commitment(
                public_and_commitment_committed=pub + com,
                nb_public_committed=len(pub),
                private_committed=priv,
                commitment_index=out_w,
            )
        )
        return Var(((COEFF_ONE, out_w),))

    # -------------------------------------------------------------- assertions
    def assert_is_equal(self, a, b):
        d = self.sub(a, b)
        cd = self.constant_value(d)
        if cd is not None:
            if cd != 0:
                raise AssertionError("constant constraint violated at compile time")
            return
        self.cs.add_r1c(self._lin(d), [(COEFF_ONE, 0)], [], dbg="assertIsEqual")

    def assert_is_different(self, a, b):
        # a-b must be invertible
        self.inverse(self.sub(a, b))

    def assert_is_less_or_equal(self, a, b, nbits: int = 64):
        """a <= b, sound for UNCONSTRAINED operands: both a and b are
        range-constrained to nbits bits (like gnark's mustBeLessOrEqVar,
        frontend/cs/r1cs/api_assertions.go, which decomposes both sides),
        then b - a must also fit nbits bits. With a, b < 2^nbits <= 2^252 < p/2
        the mod-p difference of a > b lands in (p - 2^nbits, p), which cannot
        decompose into nbits bits, so negative transfers are rejected."""
        assert nbits <= self.p.bit_length() - 2
        self.to_binary(a, nbits)
        self.to_binary(b, nbits)
        self.to_binary(self.sub(b, a), nbits)

    # ---------------------------------------------------------------- bits
    def to_binary(self, a, nbits: int):
        """Decompose into nbits boolean wires (LSB first) + recomposition
        constraint. gnark: std/math/bits ToBinary with hint."""
        from ..constraint.hints import bits_hint_factory

        outs = self.cs.add_hint(bits_hint_factory(nbits), [self._lin(a)], nbits)
        bit_vars = [Var(((COEFF_ONE, w),)) for w in outs]
        acc_terms = []
        for i, bv in enumerate(bit_vars):
            self.assert_is_boolean(bv)
            acc_terms.extend(self._lin(self._scale(bv, 1 << i)))
        self.assert_is_equal(self._merge(acc_terms), a)
        return bit_vars

    def from_binary(self, bits):
        terms = []
        for i, bv in enumerate(bits):
            self.assert_is_boolean(bv)
            terms.extend(self._lin(self._scale(bv, 1 << i)))
        return self._merge(terms)

    # ---------------------------------------------------------------- hints
    def new_hint(self, fn, n_out: int, *inputs):
        outs = self.cs.add_hint(fn, [self._lin(v) for v in inputs], n_out)
        return [Var(((COEFF_ONE, w),)) for w in outs]

    # ---------------------------------------------------------------- finalize
    def compile(self) -> ConstraintSystem:
        # run deferred callbacks; a callback may defer more (gnark loops the
        # same way over the growing list, frontend/compile.go:133)
        i = 0
        while i < len(self._deferred):
            self._deferred[i](self)
            i += 1
        return self.cs.finalize()
