"""The circuit builder of the benchmark's reference compile.

A frozen copy of the parts of ``tpusnark_torch/frontend/builder.py`` (and of
the coefficient table of ``constraint/system.py``) that the configurations'
circuits use: the same linear-combination values, constant folding and
constraint shapes, so that compiling a configuration here gives the same
R1CS, constraint for constraint, as the port's compile. The constraint
system only records: hints allocate their output wires and are never run,
since the reference solves nothing. What the reference reads back is
``public_columns``: each public wire's terms in A, B and C by constraint.
"""

from __future__ import annotations

from dataclasses import dataclass

COEFF_ONE = 1


def _hint(*_args):
    raise RuntimeError("the reference compile records hints and never runs them")


@dataclass(frozen=True)
class Var:
    """A linear combination of wires: tuple of (coeff_id, wire_id)."""

    terms: tuple


class R1CS:
    """The constraints L * R = O over a prime field, as lists of
    (coeff_id, wire_id); wire 0 is the constant-one public wire."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.coeffs: list[int] = [0, 1, 2, modulus - 1]
        self._coeff_ids: dict[int, int] = {0: 0, 1: 1, 2: 2, modulus - 1: 3}
        self.kinds: list[str] = ["pub"]
        self.public_names: list[str] = ["1"]
        self.secret_names: list[str] = []
        self.constraints: list[tuple] = []

    @property
    def n_public(self) -> int:
        return len(self.public_names)

    @property
    def n_wires(self) -> int:
        return len(self.kinds)

    def add_public(self, name: str) -> int:
        self.public_names.append(name)
        self.kinds.append("pub")
        return len(self.kinds) - 1

    def add_secret(self, name: str) -> int:
        self.secret_names.append(name)
        self.kinds.append("sec")
        return len(self.kinds) - 1

    def new_internal(self) -> int:
        self.kinds.append("int")
        return len(self.kinds) - 1

    def coeff_id(self, c: int) -> int:
        c = c % self.modulus
        cid = self._coeff_ids.get(c)
        if cid is None:
            cid = len(self.coeffs)
            self.coeffs.append(c)
            self._coeff_ids[c] = cid
        return cid

    def add_r1c(self, L, R, O, solved_wire=None, dbg=None) -> int:
        self.constraints.append((list(L), list(R), list(O)))
        return len(self.constraints) - 1

    def add_hint(self, fn, inputs, n_out: int) -> list[int]:
        return [self.new_internal() for _ in range(n_out)]

    def public_columns(self) -> list[tuple[list, list, list]]:
        """Per public wire, in the finalized order (the constant-one wire,
        then the public inputs as declared): its (constraint, coefficient)
        terms in A, in B and in C."""
        index, pos = {}, 0
        for w, kind in enumerate(self.kinds):
            if kind == "pub":
                index[w] = pos
                pos += 1
        cols = [([], [], []) for _ in range(pos)]
        coeffs = self.coeffs
        for j, lro in enumerate(self.constraints):
            for side, terms in enumerate(lro):
                for cid, vid in terms:
                    i = index.get(vid)
                    if i is not None:
                        cols[i][side].append((j, coeffs[cid]))
        return cols


class Builder:
    """The builder API the configurations' circuits call (gnark's
    frontend.API: add/sub/mul/div/inverse/select/is_zero/to_binary/...)."""

    def __init__(self, modulus: int):
        self.cs = R1CS(modulus)
        self.p = modulus
        self._booleans: set = set()
        self._deferred: list = []
        self.kv: dict = {}

    def defer_(self, fn):
        self._deferred.append(fn)

    # ----------------------------------------------------------------- inputs
    def public(self, name: str) -> Var:
        return Var(((COEFF_ONE, self.cs.add_public(name)),))

    def secret(self, name: str) -> Var:
        return Var(((COEFF_ONE, self.cs.add_secret(name)),))

    # ------------------------------------------------------------ conversions
    def _lin(self, v) -> list:
        if isinstance(v, Var):
            return list(v.terms)
        c = int(v) % self.p
        if c == 0:
            return []
        return [(self.cs.coeff_id(c), 0)]

    def constant_value(self, v):
        if not isinstance(v, Var):
            return int(v) % self.p
        if all(vid == 0 for _, vid in v.terms):
            return sum(self.cs.coeffs[cid] for cid, _ in v.terms) % self.p
        return None

    def _merge(self, terms) -> Var:
        acc: dict[int, int] = {}
        for cid, vid in terms:
            acc[vid] = (acc.get(vid, 0) + self.cs.coeffs[cid]) % self.p
        return Var(tuple((self.cs.coeff_id(c), vid) for vid, c in sorted(acc.items()) if c != 0))

    def _scale(self, v, c: int):
        c = c % self.p
        if c == 0:
            return 0
        terms = [(self.cs.coeff_id(self.cs.coeffs[cid] * c % self.p), vid) for cid, vid in self._lin(v)]
        return self._merge(terms)

    def _new_wire_var(self):
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
        cb = self.constant_value(b)
        if cb is not None:
            if not cb:
                raise ZeroDivisionError("division by constant zero in circuit")
            return self._scale(a, pow(cb, -1, self.p))
        b_inv = self.inverse(b)
        ca = self.constant_value(a)
        if ca is not None:
            return self._scale(b_inv, ca)
        o, w = self._new_wire_var()
        self.cs.add_r1c(self._lin(a), self._lin(b_inv), self._lin(o), solved_wire=w)
        return o

    def _assert_product(self, x, y, z):
        self.cs.add_r1c(self._lin(x), self._lin(y), self._lin(z))

    def inverse(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("division by constant zero in circuit")
            return pow(ca, -1, self.p)
        o, w = self._new_wire_var()
        self.cs.add_r1c(self._lin(a), self._lin(o), self._lin(1), solved_wire=w)
        return o

    def square(self, a):
        return self.mul(a, a)

    # ----------------------------------------------------------------- boolean
    def assert_is_boolean(self, a):
        if not isinstance(a, Var):
            if int(a) % self.p not in (0, 1):
                raise AssertionError("constant not boolean")
            return
        key = a.terms
        if key in self._booleans:
            return
        self._booleans.add(key)
        one_minus = self.sub(1, a)
        self.cs.add_r1c(self._lin(a), self._lin(one_minus), [])

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
        self.assert_is_boolean(cond)
        return self.add(b, self.mul(cond, self.sub(a, b)))

    def is_zero(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            return 1 if ca == 0 else 0
        (inv_w,) = self.cs.add_hint(_hint, [self._lin(a)], 1)
        inv = Var(((COEFF_ONE, inv_w),))
        b = self.sub(1, self.mul(a, inv))
        self.cs.add_r1c(self._lin(b), self._lin(a), [])
        return b

    # -------------------------------------------------------------- assertions
    def assert_is_equal(self, a, b):
        d = self.sub(a, b)
        cd = self.constant_value(d)
        if cd is not None:
            if cd != 0:
                raise AssertionError("constant constraint violated at compile time")
            return
        self.cs.add_r1c(self._lin(d), [(COEFF_ONE, 0)], [])

    # ---------------------------------------------------------------- bits
    def to_binary(self, a, nbits: int):
        outs = self.cs.add_hint(_hint, [self._lin(a)], nbits)
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

    def compile(self) -> R1CS:
        i = 0
        while i < len(self._deferred):
            self._deferred[i](self)
            i += 1
        return self.cs
