"""Bit/base conversions beyond the builders' to_binary/from_binary
(the std/math/bits analog).

Mirrors gnark/std/math/bits/{conversion_ternary.go,naf.go}:
ternary decomposition and non-adjacent form, both hint-computed then
recomposition-constrained, same shape as gnark's ToTernary/ToNAF.

The port's copy of tpusnark/gadgets/bits.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


def to_ternary(api, v, ndigits: int):
    """Base-3 digits of v (LSB first); each digit constrained to {0,1,2} via
    d(d-1)(d-2)=0, recomposition enforced."""

    def tern_hint(p, ins):
        x = ins[0] % p
        return [(x // 3**i) % 3 for i in range(ndigits)]

    digits = api.new_hint(tern_hint, ndigits, v)
    acc = 0
    for i, d in enumerate(digits):
        # d*(d-1)*(d-2) == 0
        api.assert_is_equal(api.mul(d, api.mul(api.sub(d, 1), api.sub(d, 2))), 0)
        acc = api.add(acc, api.mul(3**i, d))
    api.assert_is_equal(acc, v)
    return digits


def from_ternary(api, digits):
    acc = 0
    for i, d in enumerate(digits):
        api.assert_is_equal(api.mul(d, api.mul(api.sub(d, 1), api.sub(d, 2))), 0)
        acc = api.add(acc, api.mul(3**i, d))
    return acc


def to_naf(api, v, nbits: int):
    """Non-adjacent form: digits in {-1,0,1}, recomposition Σ d_i 2^i == v.
    Digit-set constraint d(d-1)(d+1)=0 (gnark: nNaf hint + same check)."""

    def naf_hint(p, ins):
        x = ins[0] % p
        out = []
        for _ in range(nbits):
            if x & 1:
                d = 2 - (x % 4)  # 1 if x%4==1 else -1
                x -= d
            else:
                d = 0
            x >>= 1
            out.append(d % p)
        return out

    digits = api.new_hint(naf_hint, nbits, v)
    acc = 0
    for i, d in enumerate(digits):
        api.assert_is_equal(api.mul(d, api.mul(api.sub(d, 1), api.add(d, 1))), 0)
        acc = api.add(acc, api.mul(1 << i, d))
    api.assert_is_equal(acc, v)
    return digits
