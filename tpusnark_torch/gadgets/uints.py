"""Unsigned-integer word gadgets (U32/U64) over circuit bits.

The analog of gnark's std/math/uints (gnark/std/math/uints/uint8.go):
gnark represents words as 8-bit limbs checked with byte lookup tables; here a
word is its little-endian bit vector, which maps better onto our builders
(bit decomposition is a single to_binary and all bitwise ops become per-bit
R1CS/Plonk gates, while rotations/shifts are free wire shuffles).

A `U32`/`U64` is a list of bit variables, LSB first. All functions take the
circuit `api` (Builder, PlonkBuilder or TestEngine) as first argument.

The port's copy of tpusnark/gadgets/uints.py: same code.
"""

from __future__ import annotations


def from_var(api, v, nbits: int = 32):
    """Decompose a field element into an nbits-wide word (list of bits)."""
    return api.to_binary(v, nbits)


def to_var(api, bits):
    """Recompose a word into a field element (constant words fold to ints)."""
    if all(isinstance(b, int) for b in bits):
        return sum(b << i for i, b in enumerate(bits))
    return api.from_binary(bits)


def from_const(value: int, nbits: int = 32):
    """Constant word (plain 0/1 ints — every api treats ints as constants)."""
    return [(value >> i) & 1 for i in range(nbits)]


def xor(api, a, b):
    return [api.xor(x, y) for x, y in zip(a, b, strict=True)]


def and_(api, a, b):
    return [api.and_(x, y) for x, y in zip(a, b, strict=True)]


def or_(api, a, b):
    return [api.or_(x, y) for x, y in zip(a, b, strict=True)]


def not_(api, a):
    return [api.sub(1, x) for x in a]


def rotr(a, k: int):
    """Rotate right by k — a pure wire shuffle, zero constraints."""
    n = len(a)
    k %= n
    # bit i of the result is bit (i+k) mod n of the input (LSB-first layout)
    return [a[(i + k) % n] for i in range(n)]


def rotl(a, k: int):
    return rotr(a, len(a) - (k % len(a)))


def shr(a, k: int):
    """Logical shift right by k (zero fill)."""
    n = len(a)
    k = min(k, n)
    return a[k:] + [0] * k


def shl(a, k: int):
    n = len(a)
    k = min(k, n)
    return [0] * k + a[: n - k]


def add(api, *words):
    """Sum of k same-width words, truncated mod 2^n.

    One field addition of the recomposed words plus a single (n + ceil(log2 k))
    -bit decomposition — the standard arithmetization of a modular adder
    (cheaper than gnark's byte-limb carry chain on our builders).
    """
    n = len(words[0])
    k = len(words)
    extra = max(1, (k - 1).bit_length())
    total = api.add(*[to_var(api, w) for w in words]) if k > 1 else to_var(api, words[0])
    bits = api.to_binary(total, n + extra)
    return bits[:n]


def assert_equal(api, a, b):
    for x, y in zip(a, b, strict=True):
        api.assert_is_equal(x, y)


def value_of(api, v, nbits: int = 32):
    """gnark's uints.NewU32/NewU64 analog: accept an int constant or a circuit
    variable and return a checked word."""
    if isinstance(v, int):
        return from_const(v, nbits)
    return from_var(api, v, nbits)


def to_bytes_be(api, a):
    """Split a word into big-endian byte values (list of field elements),
    gnark's UnpackMSB analog — used to feed byte-oriented hash paddings."""
    n = len(a)
    assert n % 8 == 0
    out = []
    for byte_i in range(n // 8 - 1, -1, -1):
        out.append(api.from_binary(a[8 * byte_i : 8 * byte_i + 8]))
    return out
