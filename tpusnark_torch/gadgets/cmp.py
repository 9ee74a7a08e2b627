"""Bounded comparators (the std/math/cmp analog).

Mirrors gnark/std/math/cmp/bounded.go (BoundedComparator: IsLess,
IsLessEq, AssertIsLess, Min/Max for values with a known bit bound) built on
bit decomposition: for a,b < 2^n with n <= field_bits-2, the sign of a-b is
bit n of (2^n + a - b).

The port's copy of tpusnark/gadgets/cmp.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


class BoundedComparator:
    """Comparator for values known to fit `nbits` bits (caller guarantee, as
    in gnark's absDiffBound contract); each operand is range-checked once."""

    def __init__(self, api, nbits: int):
        assert nbits + 1 <= api.field_bit_len() - 1
        self.api = api
        self.nbits = nbits

    def _borrow(self, a, b):
        """bit nbits of (2^nbits + a - b): 1 iff a >= b."""
        api = self.api
        shifted = api.add(api.sub(a, b), 1 << self.nbits)
        bits = api.to_binary(shifted, self.nbits + 1)
        return bits[self.nbits]

    def is_less(self, a, b):
        return self.api.sub(1, self._borrow(a, b))

    def is_less_eq(self, a, b):
        return self._borrow(b, a)

    def assert_is_less(self, a, b):
        self.api.assert_is_equal(self.is_less(a, b), 1)

    def assert_is_less_eq(self, a, b):
        self.api.assert_is_equal(self.is_less_eq(a, b), 1)

    def min_(self, a, b):
        return self.api.select(self.is_less(a, b), a, b)

    def max_(self, a, b):
        return self.api.select(self.is_less(a, b), b, a)


def is_equal(api, a, b):
    return api.is_zero(api.sub(a, b))
