"""In-circuit SHA3 / legacy-Keccak sponge hashes over keccak_f.

The std/hash/sha3 analog (gnark/std/hash/sha3/sha3.go:17-90,
hashes.go:12-99): absorb byte-stream blocks into the 25-lane state, permute,
squeeze. Circuits are static-shape, so the gadget hashes a FIXED-length list
of in-circuit bytes (the reference's Write/Sum object protocol reduces to
the same thing once the written length is fixed at compile time; variable
length needs a max-length circuit + selector masking, out of scope here).

Bytes are circuit variables constrained to 8 bits; lanes are uints 64-bit
bit-lists (LSB first) like the keccakf gadget. Padding bytes are constants
folded in at compile time. Host oracle: hashes.keccak.sponge.

The port's copy of tpusnark/gadgets/sha3.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .keccakf import keccak_f
from . import uints as u

_VARIANTS = {
    "sha3-256": (136, 0x06, 32),
    "sha3-384": (104, 0x06, 48),
    "sha3-512": (72, 0x06, 64),
    "keccak-256": (136, 0x01, 32),
    "keccak-512": (72, 0x01, 64),
}


def _byte_bits(api, v):
    """One in-circuit byte -> 8 bits (LSB first), range-constrained."""
    return u.from_var(api, v, 8)


def sponge(api, data_bytes, variant: str = "sha3-256"):
    """Hash a fixed-length list of in-circuit byte variables.

    Returns out_len byte variables (each the recombination of 8 boolean
    wires). reference: absorbing/squeezeBlocks at std/hash/sha3/sha3.go:70-90."""
    rate, dsbyte, out_len = _VARIANTS[variant]
    n = len(data_bytes)
    bits = [_byte_bits(api, v) for v in data_bytes]
    # constant padding (compile-time): dsbyte ... 0x80 (multi-rate)
    pad_len = rate - (n % rate)
    if pad_len == 1:
        pad = [dsbyte | 0x80]
    else:
        pad = [dsbyte] + [0] * (pad_len - 2) + [0x80]
    bits += [u.from_const(b, 8) for b in pad]

    # state: 25 lanes of 64 zero bits
    state = [u.from_const(0, 64) for _ in range(25)]
    for off in range(0, len(bits), rate):
        block = bits[off : off + rate]
        for i in range(rate // 8):
            lane_bits = []
            for b in range(8):
                lane_bits.extend(block[8 * i + b])
            state[i] = u.xor(api, state[i], lane_bits)
        state = keccak_f(api, state)

    out = []
    for i in range(-(-out_len // 8)):
        lane = state[i]
        for b in range(8):
            if len(out) == out_len:
                break
            out.append(u.to_var(api, lane[8 * b : 8 * b + 8]))
    return out


def sha3_256(api, data_bytes):
    return sponge(api, data_bytes, "sha3-256")


def sha3_384(api, data_bytes):
    return sponge(api, data_bytes, "sha3-384")


def sha3_512(api, data_bytes):
    return sponge(api, data_bytes, "sha3-512")


def keccak256(api, data_bytes):
    """NewLegacyKeccak256 analog (hashes.go:64)."""
    return sponge(api, data_bytes, "keccak-256")


def keccak512(api, data_bytes):
    return sponge(api, data_bytes, "keccak-512")
