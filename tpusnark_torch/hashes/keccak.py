"""Legacy Keccak-256 (pre-SHA3 padding), pure Python.

Needed to derive gnark-crypto's MiMC round constants bit-exactly: gnark's
MiMC seeds a legacy Keccak-256 chain with the string "seed"
(gnark-crypto ecc/*/fr/mimc; consumed by the reference circuit gadget at
gnark/std/hash/mimc/encrypt.go:78 GetConstants()). hashlib only
ships SHA3 (0x06 domain padding); legacy Keccak pads with 0x01.

The port's copy of tpusnark/hashes/keccak.py: same code.
"""

from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(a: list[list[int]]):
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        a[0][0] ^= rc


def sponge(data: bytes, rate: int, dsbyte: int, out_len: int) -> bytes:
    """Generic Keccak sponge (host oracle): rate in bytes, domain byte
    (0x01 legacy Keccak, 0x06 SHA3), out_len bytes (single squeeze block
    suffices for all the SHA3/Keccak variants: out_len <= rate)."""
    pad_len = rate - (len(data) % rate)
    if pad_len == 1:
        padded = data + bytes([dsbyte | 0x80])
    else:
        padded = data + bytes([dsbyte]) + b"\x00" * (pad_len - 2) + b"\x80"
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            a[x][y] ^= lane
        _keccak_f(a)
    out = b""
    for i in range(-(-out_len // 8)):
        x, y = i % 5, i // 5
        out += a[x][y].to_bytes(8, "little")
    return out[:out_len]


def sha3_256(data: bytes) -> bytes:
    return sponge(data, 136, 0x06, 32)


def sha3_384(data: bytes) -> bytes:
    return sponge(data, 104, 0x06, 48)


def sha3_512(data: bytes) -> bytes:
    return sponge(data, 72, 0x06, 64)


def keccak512(data: bytes) -> bytes:
    return sponge(data, 72, 0x01, 64)


def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    # legacy multi-rate padding: 0x01 ... 0x80
    pad_len = rate - (len(data) % rate)
    padded = data + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else (
        data + b"\x81"
    )
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            a[x][y] ^= lane
        _keccak_f(a)
    out = b""
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += a[x][y].to_bytes(8, "little")
    return out
