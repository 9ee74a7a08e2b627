"""Bit-slicing gadget: the std/math/bitslice analog.

Reference: gnark/std/math/bitslice/partition.go:18 — split a
variable at bit `split` into (lower, upper) with width enforcement. The
reference uses a hint plus range checks; same structure here (hint the two
halves, range-check both, constrain the recomposition).

The port's copy of tpusnark/gadgets/bitslice.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


def partition(api, v, split: int, nbits: int | None = None):
    """Return (lower, upper) with v == lower + 2^split * upper,
    lower < 2^split and upper < 2^(nbits - split).

    nbits: total width bound of v (defaults to the field bit length - 1 so
    the recomposition cannot wrap)."""
    total = nbits if nbits is not None else api.p.bit_length() - 1
    assert 0 <= split <= total
    if split == 0:
        api_zero = 0
        return api_zero, v
    if split == total:
        return v, 0

    def split_hint(p, ins):
        val = int(ins[0]) % p
        return [val & ((1 << split) - 1), val >> split]

    lower, upper = api.new_hint(split_hint, 2, v)
    # width checks (to_binary constrains the decomposition)
    api.to_binary(lower, split)
    api.to_binary(upper, total - split)
    api.assert_is_equal(api.add(lower, api.mul(upper, 1 << split)), v)
    return lower, upper
