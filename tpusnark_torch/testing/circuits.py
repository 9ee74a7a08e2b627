"""Registered circuit corpus: the analog of the reference's
internal/backend/circuits/ (26 mini-circuits in a map, swept through the
full check matrix by integration_test.go:29-60).

Each entry's `define(api)` runs unchanged on the big-int TestEngine, the
R1CS Builder, and the Plonkish PlonkBuilder (the three interpreters of the
dual-oracle strategy, SURVEY.md §4). Assignments: `valid` must satisfy the
circuit, `invalid` must fail on EVERY interpreter.

The port's copy of tpusnark/testing/circuits.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class CorpusEntry:
    name: str
    define: Callable  # define(api) -> None
    valid: list
    invalid: list
    r1cs_only: bool = False  # uses R1CS-only API (e.g. commit on Builder)


CORPUS: dict[str, CorpusEntry] = {}


def _register(name, define, valid, invalid, r1cs_only=False):
    CORPUS[name] = CorpusEntry(name, define, valid, invalid, r1cs_only)


def _c_add(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.add(x, x, 3), y)


_register("add", _c_add, [{"x": 5, "y": 13}], [{"x": 5, "y": 14}])


def _c_sub(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.sub(api.add(x, 10), x, x), y)


_register("sub", _c_sub, [{"x": 4, "y": 6}], [{"x": 4, "y": 7}])


def _c_mul(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.mul(x, x, 2), y)


_register("mul", _c_mul, [{"x": 3, "y": 18}], [{"x": 3, "y": 19}])


def _c_div(api):
    x, y, z = api.secret("x"), api.secret("y"), api.public("z")
    api.assert_is_equal(api.div(x, y), z)


_register("div", _c_div, [{"x": 12, "y": 3, "z": 4}], [{"x": 12, "y": 3, "z": 5}, {"x": 1, "y": 0, "z": 1}])


def _c_inverse(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.mul(api.inverse(x), x, y), y)


_register("inverse", _c_inverse, [{"x": 7, "y": 11}], [{"x": 0, "y": 11}])


def _c_neg(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.add(api.neg(x), x, y), y)


_register("neg", _c_neg, [{"x": 9, "y": 2}], [])


def _c_square(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.square(x), y)


_register("square", _c_square, [{"x": 6, "y": 36}], [{"x": 6, "y": 35}])


def _c_cubic(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.add(api.mul(x, x, x), x, 5), y)


_register("cubic", _c_cubic, [{"x": 3, "y": 35}], [{"x": 3, "y": 36}])


def _c_xor(api):
    a, b, c = api.secret("a"), api.secret("b"), api.public("c")
    api.assert_is_equal(api.xor(a, b), c)


_register("xor", _c_xor, [{"a": 1, "b": 0, "c": 1}, {"a": 1, "b": 1, "c": 0}], [{"a": 1, "b": 0, "c": 0}, {"a": 2, "b": 0, "c": 0}])


def _c_or(api):
    a, b, c = api.secret("a"), api.secret("b"), api.public("c")
    api.assert_is_equal(api.or_(a, b), c)


_register("or", _c_or, [{"a": 1, "b": 0, "c": 1}, {"a": 0, "b": 0, "c": 0}], [{"a": 1, "b": 1, "c": 0}])


def _c_and(api):
    a, b, c = api.secret("a"), api.secret("b"), api.public("c")
    api.assert_is_equal(api.and_(a, b), c)


_register("and", _c_and, [{"a": 1, "b": 1, "c": 1}, {"a": 0, "b": 1, "c": 0}], [{"a": 1, "b": 1, "c": 0}])


def _c_select(api):
    c, a, b, out = api.secret("c"), api.secret("a"), api.secret("b"), api.public("out")
    api.assert_is_equal(api.select(c, a, b), out)


_register(
    "select",
    _c_select,
    [{"c": 1, "a": 10, "b": 20, "out": 10}, {"c": 0, "a": 10, "b": 20, "out": 20}],
    [{"c": 1, "a": 10, "b": 20, "out": 20}, {"c": 3, "a": 10, "b": 20, "out": 10}],
)


def _c_iszero(api):
    x, b = api.secret("x"), api.public("b")
    api.assert_is_equal(api.is_zero(x), b)


_register("iszero", _c_iszero, [{"x": 0, "b": 1}, {"x": 5, "b": 0}], [{"x": 5, "b": 1}, {"x": 0, "b": 0}])


def _c_assert_equal(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(api.add(x, 1), y)


_register("assert_equal", _c_assert_equal, [{"x": 1, "y": 2}], [{"x": 1, "y": 3}])


def _c_assert_different(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_different(x, y)


_register("assert_different", _c_assert_different, [{"x": 1, "y": 2}], [{"x": 2, "y": 2}])


def _c_assert_bool(api):
    x = api.secret("x")
    api.assert_is_boolean(x)


_register("assert_bool", _c_assert_bool, [{"x": 0}, {"x": 1}], [{"x": 2}])


def _c_tobinary(api):
    x = api.secret("x")
    bits = api.to_binary(x, 4)
    api.assert_is_equal(bits[0], api.public("b0"))
    api.assert_is_equal(bits[3], api.public("b3"))


_register(
    "tobinary",
    _c_tobinary,
    [{"x": 9, "b0": 1, "b3": 1}, {"x": 6, "b0": 0, "b3": 0}],
    [{"x": 9, "b0": 0, "b3": 1}, {"x": 16, "b0": 0, "b3": 0}],
)


def _c_frombinary(api):
    b0, b1, b2 = api.secret("b0"), api.secret("b1"), api.secret("b2")
    api.assert_is_equal(api.from_binary([b0, b1, b2]), api.public("x"))


_register(
    "frombinary",
    _c_frombinary,
    [{"b0": 1, "b1": 0, "b2": 1, "x": 5}],
    [{"b0": 1, "b1": 0, "b2": 1, "x": 4}, {"b0": 2, "b1": 0, "b2": 0, "x": 2}],
)


def _c_exp(api):
    # x^8 by squaring: exercises mul chains
    x, y = api.secret("x"), api.public("y")
    t = api.square(api.square(api.square(x)))
    api.assert_is_equal(t, y)


_register("exp", _c_exp, [{"x": 2, "y": 256}], [{"x": 2, "y": 255}])


def _c_hint(api):
    from ..constraint.hints import inv_hint

    x, y = api.secret("x"), api.public("y")
    (ix,) = api.new_hint(inv_hint, 1, x)
    api.assert_is_equal(api.mul(ix, x), 1)
    api.assert_is_equal(api.mul(ix, y), api.div(y, x))


_register("hint", _c_hint, [{"x": 7, "y": 3}], [])


def _c_lessorequal(api):
    x, y = api.secret("x"), api.public("y")
    api.assert_is_less_or_equal(x, y, nbits=8)


_register("lessorequal", _c_lessorequal, [{"x": 3, "y": 10}, {"x": 10, "y": 10}], [{"x": 11, "y": 10}])


def _c_poly(api):
    # (x+1)(x+2)(x+3) == y
    x, y = api.secret("x"), api.public("y")
    api.assert_is_equal(
        api.mul(api.add(x, 1), api.add(x, 2), api.add(x, 3)), y
    )


_register("poly", _c_poly, [{"x": 1, "y": 24}], [{"x": 1, "y": 25}])


def _c_muladdmix(api):
    # z == 3xy + 2x + y + 7
    x, y, z = api.secret("x"), api.secret("y"), api.public("z")
    api.assert_is_equal(api.add(api.mul(x, y, 3), api.mul(x, 2), y, 7), z)


_register("muladdmix", _c_muladdmix, [{"x": 2, "y": 3, "z": 32}], [{"x": 2, "y": 3, "z": 33}])


def _c_negative_wrap(api):
    # p-1 behaves as -1: (p-1) * x + x == 0
    x = api.secret("x")
    m = api.mul(x, -1)
    api.assert_is_equal(api.add(m, x), 0)


_register("negative_wrap", _c_negative_wrap, [{"x": 123}], [])


def _c_commit(api):
    # BSB22 challenge used as a verifier-random value (R1CS builders + the
    # engine implement commit; PlonkBuilder does too, but the corpus runs it
    # on both so it stays generic)
    x = api.secret("x")
    c = api.commit(x)
    api.assert_is_different(x, c)


_register("commit", _c_commit, [{"x": 3}], [], r1cs_only=True)
