"""Test engine: execute a circuit over plain big ints, no constraint system.

The analog of gnark's test engine (gnark/test/engine.go:53-150):
implements the same builder API surface as frontend.Builder / PlonkBuilder
but every value IS its witness value mod p. Used as the fast correctness
oracle and the cross-check against compiled-circuit solving (the
dual-interpreter strategy, SURVEY.md §4).

The port's copy of tpusnark/testing/engine.py: same code, imports inside tpusnark_torch."""

from __future__ import annotations


class CircuitNotSatisfiedError(Exception):
    pass


from ..frontend.api_ext import APIExtensions


class TestEngine(APIExtensions):
    """api-compatible evaluator; `assignment` provides the input values."""

    def mark_boolean(self, a):
        self.assert_is_boolean(a)

    def is_boolean(self, a) -> bool:
        return int(a) % self.p in (0, 1)

    def println(self, *vals):
        print("circuit:", *[int(v) % self.p for v in vals])

    __test__ = False  # not a pytest class

    def __init__(self, modulus: int, assignment: dict):
        self.p = modulus
        self.assignment = assignment

    # ---- inputs ----
    def public(self, name: str) -> int:
        return int(self.assignment[name]) % self.p

    def secret(self, name: str) -> int:
        return int(self.assignment[name]) % self.p

    def constant_value(self, v):
        return int(v) % self.p

    # ---- arithmetic ----
    def add(self, *vals):
        return sum(int(v) for v in vals) % self.p

    def sub(self, a, *rest):
        return (int(a) - sum(int(r) for r in rest)) % self.p

    def neg(self, a):
        return (-int(a)) % self.p

    def mul(self, *vals):
        out = 1
        for v in vals:
            out = out * int(v) % self.p
        return out

    def div(self, a, b):
        b = int(b) % self.p
        if b == 0:
            raise CircuitNotSatisfiedError("division by zero")
        return int(a) * pow(b, -1, self.p) % self.p

    def inverse(self, a):
        return self.div(1, a)

    def square(self, a):
        return self.mul(a, a)

    # ---- boolean ----
    def assert_is_boolean(self, a):
        if int(a) % self.p not in (0, 1):
            raise CircuitNotSatisfiedError(f"not boolean: {a}")

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
        return (int(a) + int(b) - 2 * int(a) * int(b)) % self.p

    def select(self, cond, a, b):
        self.assert_is_boolean(cond)
        return a if int(cond) % self.p == 1 else b

    def is_zero(self, a):
        return 1 if int(a) % self.p == 0 else 0

    # ---- assertions ----
    def assert_is_equal(self, a, b):
        if (int(a) - int(b)) % self.p != 0:
            raise CircuitNotSatisfiedError(f"{a} != {b}")

    def assert_is_different(self, a, b):
        if (int(a) - int(b)) % self.p == 0:
            raise CircuitNotSatisfiedError(f"{a} == {b}")

    def assert_is_less_or_equal(self, a, b, nbits: int = 64):
        # mirrors the builders: BOTH operands range-checked, then the
        # difference (sound even for unconstrained a, b)
        if int(a) % self.p >= (1 << nbits):
            raise CircuitNotSatisfiedError(f"{a} does not fit {nbits} bits")
        if int(b) % self.p >= (1 << nbits):
            raise CircuitNotSatisfiedError(f"{b} does not fit {nbits} bits")
        d = (int(b) - int(a)) % self.p
        if d >= (1 << nbits):
            raise CircuitNotSatisfiedError(f"{a} > {b} (mod-p difference {d})")

    # ---- bits ----
    def to_binary(self, a, nbits: int):
        a = int(a) % self.p
        bits = [(a >> i) & 1 for i in range(nbits)]
        if sum(b << i for i, b in enumerate(bits)) != a:
            raise CircuitNotSatisfiedError(f"{a} does not fit in {nbits} bits")
        return bits

    def from_binary(self, bits):
        for b in bits:
            self.assert_is_boolean(b)
        return sum(int(b) << i for i, b in enumerate(bits)) % self.p

    # ---- commitments ----
    def commit(self, *vals) -> int:
        """BSB22 challenge under the engine: the deterministic placeholder
        (the reference's engine also runs the placeholder hint; real
        commitments only exist at prove time)."""
        from ..constraint.hints import bsb22_placeholder

        self._commit_depth = getattr(self, "_commit_depth", -1) + 1
        ins = [self._commit_depth] + [int(v) % self.p for v in vals]
        return bsb22_placeholder(self.p, ins)[0]

    # ---- hints ----
    def new_hint(self, fn, n_out: int, *inputs):
        outs = fn(self.p, [int(v) % self.p for v in inputs])
        assert len(outs) == n_out
        return [int(o) % self.p for o in outs]


def is_solved(circuit_fn, modulus: int, assignment: dict) -> bool:
    """Run circuit_fn(api) under the engine; True iff no assertion fails.
    The analog of test.IsSolved (gnark/test/assert.go)."""
    try:
        circuit_fn(TestEngine(modulus, assignment))
        return True
    except (CircuitNotSatisfiedError, AssertionError, ZeroDivisionError):
        return False
