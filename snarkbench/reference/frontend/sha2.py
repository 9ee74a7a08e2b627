"""In-circuit SHA-256 (the std/hash/sha2 gadget).

The analog of gnark's gnark/std/hash/sha2/sha2.go (+
std/permutation/sha2/sha2blocks.go): the full FIPS 180-4 compression
function over U32 bit-vector words from gadgets/uints.py. Rotations are free
wire shuffles; Ch/Maj use the xor-and forms that cost one constraint per bit;
modular adders are single wide bit decompositions.

API mirrors hashlib: Sha256Gadget().update(list-of-byte-vars).digest() returns
32 byte-valued circuit variables.

A frozen copy of tpusnark_torch/gadgets/sha2.py for the benchmark's
reference compile: the same code, so that it emits the same constraints.
"""

from __future__ import annotations

from . import uints as u

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _ch(api, x, y, z):
    # Ch(x,y,z) = z ^ (x & (y ^ z)) — one AND + two XOR per bit
    return u.xor(api, z, u.and_(api, x, u.xor(api, y, z)))


def _maj(api, x, y, z):
    # Maj(x,y,z) = x ^ ((x ^ y) & (x ^ z))
    return u.xor(api, x, u.and_(api, u.xor(api, x, y), u.xor(api, x, z)))


def _sigma(api, w, r1, r2, s):
    return u.xor(api, u.xor(api, u.rotr(w, r1), u.rotr(w, r2)), u.shr(w, s))


def _Sigma(api, w, r1, r2, r3):
    return u.xor(api, u.xor(api, u.rotr(w, r1), u.rotr(w, r2)), u.rotr(w, r3))


def compress(api, state, block_words):
    """One SHA-256 compression: state = 8 U32 words, block = 16 U32 words.
    Mirrors sha2blocks.go's permutation (same schedule/round structure)."""
    w = list(block_words)
    for t in range(16, 64):
        s0 = _sigma(api, w[t - 15], 7, 18, 3)
        s1 = _sigma(api, w[t - 2], 17, 19, 10)
        w.append(u.add(api, w[t - 16], s0, w[t - 7], s1))

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = u.add(api, h, _Sigma(api, e, 6, 11, 25), _ch(api, e, f, g),
                   u.from_const(_K[t]), w[t])
        t2 = u.add(api, _Sigma(api, a, 2, 13, 22), _maj(api, a, b, c))
        h, g, f = g, f, e
        e = u.add(api, d, t1)
        d, c, b = c, b, a
        a = u.add(api, t1, t2)

    return [u.add(api, s, v) for s, v in
            zip(state, [a, b, c, d, e, f, g, h], strict=True)]


class Sha256Gadget:
    """Byte-oriented SHA-256 over circuit variables (each input var must hold
    a value in [0,256); callers decompose words with uints.to_bytes_be)."""

    def __init__(self, api):
        self.api = api
        self._bytes = []

    def update(self, byte_vars):
        self._bytes.extend(byte_vars)
        return self

    def digest(self):
        api = self.api
        msg = list(self._bytes)
        bitlen = len(msg) * 8
        # FIPS padding: 0x80, zeros, 64-bit big-endian length
        msg.append(0x80)
        while (len(msg) % 64) != 56:
            msg.append(0)
        msg += [(bitlen >> (8 * i)) & 0xFF for i in range(7, -1, -1)]

        state = [u.from_const(h) for h in _H0]
        for off in range(0, len(msg), 64):
            words = []
            for i in range(16):
                chunk = msg[off + 4 * i : off + 4 * i + 4]
                # big-endian bytes -> U32 bits (LSB first)
                bits = []
                for j in (3, 2, 1, 0):
                    bv = chunk[j]
                    bits.extend(bv if isinstance(bv, list)
                                else u.value_of(api, bv, 8))
                words.append(bits)
            state = compress(api, state, words)

        out = []
        for word in state:
            out.extend(u.to_bytes_be(api, word))
        return out


def sha256_of_bytes(api, byte_vars):
    return Sha256Gadget(api).update(byte_vars).digest()
