"""Plonkish circuit builder: the gnark SCS builder analog (the port's copy of
tpusnark/frontend/plonk_builder.py: same code).

Reference surface: gnark/frontend/cs/scs/builder.go
(addPlonkConstraint :190, addMulGate :145, addAddGate :159) implementing the
same frontend.API as the R1CS builder but emitting
qL*a + qR*b + qM*ab + qO*c + qC = 0 gates.

Representation choice (slightly stronger than gnark's single-Term values):
a circuit value is an *affine* form c*wire + k, so additions/scalings with
constants are free and a generic mul of two affine forms folds into ONE gate
(qM = c1*c2, qL = c1*k2, qR = c2*k1, qC = k1*k2). gnark emits separate add
gates for constant offsets; this builder does not need to.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constraint.scs import Gate, SparseConstraintSystem
from ..constraint.system import COEFF_MINUS_ONE, COEFF_ONE


@dataclass(frozen=True)
class AVar:
    """c * W[wire] + k."""

    c: int
    wire: int
    k: int


from .api_ext import APIExtensions


class PlonkBuilder(APIExtensions):
    def _bool_key(self, a):
        a = self._affine(a)
        return (a.c, a.wire, a.k)

    def println(self, *vals):
        entry = []
        for v in vals:
            cv = self.constant_value(v)
            if cv is not None:
                entry.append(("const", cv))
            else:
                av = self._affine(v)
                entry.append(("affine", (av.c, av.wire, av.k)))
        self.cs.logs.append(entry)

    def __init__(self, modulus: int):
        self.cs = SparseConstraintSystem(modulus)
        self.p = modulus
        self._booleans: set = set()
        # gate-level CSE (gnark scs addConstraintExist/mulConstraintExist,
        # gnark/frontend/cs/scs/builder.go:471,559): an add/mul gate
        # fully determines its output wire from (input wires, coefficients),
        # so identical gates reuse the first output instead of re-emitting.
        self._add_cache: dict = {}
        self._mul_cache: dict = {}

    # ----------------------------------------------------------------- inputs
    def public(self, name: str) -> AVar:
        return AVar(1, self.cs.add_public(name), 0)

    def secret(self, name: str) -> AVar:
        return AVar(1, self.cs.add_secret(name), 0)

    # ------------------------------------------------------------ conversions
    def _affine(self, v) -> AVar:
        if isinstance(v, AVar):
            return v
        return AVar(0, 0, int(v) % self.p)

    def constant_value(self, v):
        if not isinstance(v, AVar):
            return int(v) % self.p
        return v.k % self.p if v.c % self.p == 0 else None

    def _cid(self, c: int) -> int:
        return self.cs.coeff_id(c)

    def _new_out(self) -> tuple[AVar, int]:
        w = self.cs.new_internal()
        return AVar(1, w, 0), w

    # -------------------------------------------------------------- arithmetic
    def add(self, a, b, *rest):
        out = self._add2(a, b)
        for r in rest:
            out = self._add2(out, r)
        return out

    def _add2(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            return (ca + cb) % self.p
        if ca is not None:
            b = self._affine(b)
            return AVar(b.c, b.wire, (b.k + ca) % self.p)
        if cb is not None:
            a = self._affine(a)
            return AVar(a.c, a.wire, (a.k + cb) % self.p)
        a, b = self._affine(a), self._affine(b)
        if a.wire == b.wire:
            c = (a.c + b.c) % self.p
            k = (a.k + b.k) % self.p
            return AVar(c, a.wire, k) if c else k
        # canonical operand order, then CSE: out is a pure function of
        # (wa, ca, wb, cb, ka+kb) — reuse an identical earlier gate's output
        if (b.wire, b.c) < (a.wire, a.c):
            a, b = b, a
        key = (a.wire, a.c % self.p, b.wire, b.c % self.p, (a.k + b.k) % self.p)
        hit = self._add_cache.get(key)
        if hit is not None:
            return hit
        # one gate: a.c*wa + b.c*wb - out + (ka+kb) = 0
        out, w = self._new_out()
        self._add_cache[key] = out
        self.cs.add_gate(
            Gate(
                xa=a.wire,
                xb=b.wire,
                xc=w,
                qL=self._cid(a.c),
                qR=self._cid(b.c),
                qO=COEFF_MINUS_ONE,
                qC=self._cid((a.k + b.k) % self.p),
            ),
            solved_wire=w,
        )
        return out

    def neg(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            return (-ca) % self.p
        a = self._affine(a)
        return AVar((-a.c) % self.p, a.wire, (-a.k) % self.p)

    def sub(self, a, b, *rest):
        out = self._add2(a, self.neg(b))
        for r in rest:
            out = self._add2(out, self.neg(r))
        return out

    def mul(self, a, b, *rest):
        out = self._mul2(a, b)
        for r in rest:
            out = self._mul2(out, r)
        return out

    def _scale(self, a, c: int):
        c = c % self.p
        ca = self.constant_value(a)
        if ca is not None:
            return ca * c % self.p
        a = self._affine(a)
        nc = a.c * c % self.p
        nk = a.k * c % self.p
        return AVar(nc, a.wire, nk) if nc else nk

    def _mul2(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None:
            return self._scale(b, ca)
        if cb is not None:
            return self._scale(a, cb)
        a, b = self._affine(a), self._affine(b)
        if (b.wire, b.c, b.k) < (a.wire, a.c, a.k):
            a, b = b, a
        key = (
            a.wire,
            b.wire,
            a.c * b.c % self.p,
            a.c * b.k % self.p,
            b.c * a.k % self.p,
            a.k * b.k % self.p,
        )
        hit = self._mul_cache.get(key)
        if hit is not None:
            return hit
        # (c1 w1 + k1)(c2 w2 + k2) = c1c2 w1w2 + c1k2 w1 + c2k1 w2 + k1k2
        out, w = self._new_out()
        self._mul_cache[key] = out
        self.cs.add_gate(
            Gate(
                xa=a.wire,
                xb=b.wire,
                xc=w,
                qM=self._cid(a.c * b.c % self.p),
                qL=self._cid(a.c * b.k % self.p),
                qR=self._cid(b.c * a.k % self.p),
                qO=COEFF_MINUS_ONE,
                qC=self._cid(a.k * b.k % self.p),
            ),
            solved_wire=w,
        )
        return out

    def _assert_product(self, x, y, z):
        """x*y == z as ONE pure-check gate (no solved wire):
        (cx wx + kx)(cy wy + ky) - (cz wz + kz) = 0."""
        cx, cy = self.constant_value(x), self.constant_value(y)
        if cx is not None or cy is not None:
            self.assert_is_equal(self.mul(x, y), z)
            return
        x, y, z = self._affine(x), self._affine(y), self._affine(z)
        self.cs.add_gate(
            Gate(
                xa=x.wire,
                xb=y.wire,
                xc=z.wire,
                qM=self._cid(x.c * y.c % self.p),
                qL=self._cid(x.c * y.k % self.p),
                qR=self._cid(y.c * x.k % self.p),
                qO=self._cid((-z.c) % self.p),
                qC=self._cid((x.k * y.k - z.k) % self.p),
            )
        )

    def div(self, a, b):
        """a/b, UNSATISFIABLE when b == 0: one extra inverse gate forces
        b != 0 (gnark scs Div = Inverse(i2) + DivUnchecked,
        gnark/frontend/cs/scs/api.go:191-196 — without it, a gate
        b*out = a with b == 0 constrains only a == 0 and leaves out free,
        so a hand-crafted PLONK witness could assign 0/0 arbitrarily)."""
        cb = self.constant_value(b)
        if cb is not None:
            if cb == 0:
                raise ZeroDivisionError("division by constant zero in circuit")
            return self._scale(a, pow(cb, -1, self.p))
        self.inverse(b)
        a, b = self._affine(a), self._affine(b)
        # out * b = a  ->  qM(out*wb)... out is a fresh single wire:
        # gate(xa=out, xb=b.wire, xc=a.wire):
        #   b.c*(out*wb) + b.k*out - a.c*wa - a.k = 0
        out, w = self._new_out()
        self.cs.add_gate(
            Gate(
                xa=w,
                xb=b.wire,
                xc=a.wire,
                qM=self._cid(b.c),
                qL=self._cid(b.k),
                qO=self._cid((-a.c) % self.p),
                qC=self._cid((-a.k) % self.p),
            ),
            solved_wire=w,
        )
        return out

    def inverse(self, a):
        """1/a as ONE gate: inv*(a.c*wa + a.k) - 1 = 0 (gnark scs Inverse,
        gnark/frontend/cs/scs/api.go:199-230). Solver fails on
        a == 0 (zero qM*wb + qL denominator -> errDivideByZero analog)."""
        ca = self.constant_value(a)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("division by constant zero in circuit")
            return pow(ca, -1, self.p)
        a = self._affine(a)
        out, w = self._new_out()
        self.cs.add_gate(
            Gate(
                xa=w,
                xb=a.wire,
                xc=0,
                qM=self._cid(a.c),
                qL=self._cid(a.k),
                qC=COEFF_MINUS_ONE,
            ),
            solved_wire=w,
        )
        return out

    def square(self, a):
        return self.mul(a, a)

    # ----------------------------------------------------------------- boolean
    def assert_is_boolean(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            assert ca in (0, 1), "constant not boolean"
            return
        a = self._affine(a)
        key = (a.c, a.wire, a.k)
        if key in self._booleans:
            return
        self._booleans.add(key)
        # v^2 - v = 0 with v = c*w + k:
        # c^2 w^2 + (2ck - c) w + k^2 - k = 0
        self.cs.add_gate(
            Gate(
                xa=a.wire,
                xb=a.wire,
                xc=a.wire,
                qM=self._cid(a.c * a.c % self.p),
                qL=self._cid((2 * a.c * a.k - a.c) % self.p),
                qC=self._cid((a.k * a.k - a.k) % self.p),
            ),
            dbg="assertIsBoolean",
        )

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
        return self.sub(self.add(a, b), self._scale(self.mul(a, b), 2))

    def select(self, cond, a, b):
        self.assert_is_boolean(cond)
        return self.add(b, self.mul(cond, self.sub(a, b)))

    def is_zero(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            return 1 if ca == 0 else 0
        from ..constraint.hints import inv_hint

        (inv,) = self.new_hint(inv_hint, 1, a)
        b = self.sub(1, self.mul(a, inv))
        # b * a == 0
        self.assert_is_equal(self.mul(b, a), 0)
        return b

    # -------------------------------------------------------------- assertions
    def assert_is_equal(self, a, b):
        d = self.sub(a, b)
        cd = self.constant_value(d)
        if cd is not None:
            if cd != 0:
                raise AssertionError("constant constraint violated at compile time")
            return
        d = self._affine(d)
        self.cs.add_gate(
            Gate(
                xa=d.wire,
                xb=d.wire,
                xc=d.wire,
                qL=self._cid(d.c),
                qC=self._cid(d.k),
            ),
            dbg="assertIsEqual",
        )

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))

    def assert_is_less_or_equal(self, a, b, nbits: int = 64):
        """a <= b, sound for UNCONSTRAINED operands: range-constrains a, b,
        and b - a to nbits bits (see builder.py for the soundness argument;
        mirrors gnark's mustBeLessOrEqVar)."""
        assert nbits <= self.p.bit_length() - 2
        self.to_binary(a, nbits)
        self.to_binary(b, nbits)
        self.to_binary(self.sub(b, a), nbits)

    # ------------------------------------------------------------------- bits
    def to_binary(self, a, nbits: int):
        from ..constraint.hints import bits_hint_factory

        outs = self.new_hint(bits_hint_factory(nbits), nbits, a)
        acc = 0
        for i, bv in enumerate(outs):
            self.assert_is_boolean(bv)
            acc = self.add(acc, self._scale(bv, 1 << i))
        self.assert_is_equal(acc, a)
        return outs

    def from_binary(self, bits):
        acc = 0
        for i, bv in enumerate(bits):
            self.assert_is_boolean(bv)
            acc = self.add(acc, self._scale(bv, 1 << i))
        return acc

    # ------------------------------------------------------------- commitments
    def commit(self, *values) -> AVar:
        """BSB22 in-circuit commitment (gnark frontend/cs/scs/api.go:623):
        emits one COMMITTED row per value (-v = 0, balanced by the qcp_i *
        P_i column), a placeholder hint computing the challenge, and a
        COMMITMENT row (-challenge = 0, balanced by the prover-completed
        qk). Returns the challenge variable; metadata lands in
        cs.commitments with gnark's pre-offset row indexing."""
        from ..constraint.hints import bsb22_placeholder
        from ..constraint.scs import PlonkCommitment

        vs = [v for v in values if self.constant_value(v) is None]
        assert vs, "commit() needs at least one non-constant variable"
        committed_rows = []
        for v in vs:
            av = self._affine(v)
            committed_rows.append(len(self.cs.gates))
            self.cs.add_gate(
                Gate(
                    xa=av.wire,
                    xb=av.wire,
                    xc=av.wire,
                    qL=self._cid((-av.c) % self.p),
                    qC=self._cid((-av.k) % self.p),
                ),
                dbg="bsb22 committed",
            )
        depth = len(self.cs.commitments)
        triples = [(0, 0, depth)] + [
            (a.c, a.wire, a.k) for a in (self._affine(v) for v in vs)
        ]
        (out_wire,) = self.cs.add_hint(bsb22_placeholder, triples, 1)
        commitment_row = len(self.cs.gates)
        self.cs.add_gate(
            Gate(
                xa=out_wire,
                xb=out_wire,
                xc=out_wire,
                qL=COEFF_MINUS_ONE,
            ),
            dbg="bsb22 commitment",
        )
        self.cs.commitments.append(
            PlonkCommitment(commitment_index=commitment_row, committed=committed_rows)
        )
        return AVar(1, out_wire, 0)

    # ------------------------------------------------------------------ hints
    def new_hint(self, fn, n_out: int, *inputs):
        triples = []
        for v in inputs:
            av = self._affine(v)
            triples.append((av.c, av.wire, av.k))
        outs = self.cs.add_hint(fn, triples, n_out)
        return [AVar(1, w, 0) for w in outs]

    # --------------------------------------------------------------- finalize
    def compile(self) -> SparseConstraintSystem:
        return self.cs.finalize()
