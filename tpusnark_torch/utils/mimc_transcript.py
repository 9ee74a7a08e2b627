"""Recursion-friendly (MiMC) transcript hashing.

The reference verifies PLONK proofs inside circuits by running the prover
with a circuit-friendly challenge hash (gnark
`WithProverChallengeHashFunction` + std/recursion/plonk — the in-circuit
verifier recomputes the same transcript with the gadget hash,
gnark/std/recursion/plonk/verifier.go).

`MiMCFrHash` is the host side of that pair for this framework: a
hashlib-like object (so it slots into `backend.config.with_challenge_hash`
and `Transcript(hash_factory=...)`) built on the gnark-compatible MiMC
permutation over BN254 fr.

Chunking rule (must be mirrored exactly by the in-circuit verifier,
gadgets/recursion_plonk.py): every `update()` payload is independently
left-zero-padded to a multiple of 32 bytes; each 32-byte big-endian word w
is absorbed as the PAIR (w >> 128, w & (2^128 - 1)) — both halves < 2^128
< r, so byte->field conversion is unambiguous and, in-circuit, computable
from 64-bit emulated limbs (hi = l2 + 2^64 l3, lo = l0 + 2^64 l1) or from a
254-bit native decomposition. The digest is the 32-byte big-endian MiMC
state (already < r).

The port's copy of tpusnark/utils/mimc_transcript.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..fields.spec import BN254_FR
from ..hashes.mimc import MiMC

_M128 = (1 << 128) - 1


def word_pair(v: int) -> tuple[int, int]:
    """The (hi, lo) 128-bit halves a 32-byte word is absorbed as."""
    return (v >> 128, v & _M128)


class MiMCFrHash:
    """hashlib-like MiMC-over-fr transcript hash (see module docstring)."""

    name = "mimc-fr"
    digest_size = 32

    def __init__(self):
        self._h = MiMC(BN254_FR.modulus)

    def update(self, data: bytes):
        data = bytes(data)
        pad = (-len(data)) % 32
        data = b"\x00" * pad + data
        for i in range(0, len(data), 32):
            v = int.from_bytes(data[i : i + 32], "big")
            hi, lo = word_pair(v)
            self._h.write(hi, lo)
        return self

    def digest(self) -> bytes:
        return int(self._h.sum()).to_bytes(32, "big")
