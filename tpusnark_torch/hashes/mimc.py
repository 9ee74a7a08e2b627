"""MiMC hash: native (host) implementation + circuit gadget.

Reference behavior: gnark/std/hash/mimc/mimc.go (Miyaguchi-Preneel
mode, Sum at :63-75) and encrypt.go:146-152 (BN254: 110 rounds of
x <- (x + h + c_i)^5, then + h). Round constants follow gnark-crypto's
derivation: a legacy Keccak-256 chain seeded with "seed", one squeeze per
round, each digest reduced into fr — so hash values match gnark's MiMC
bit-for-bit.

The gadget works against either builder (R1CS Builder or PlonkBuilder):
it only uses add/mul.

The port's copy of tpusnark/hashes/mimc.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

import functools

from ..fields.spec import BN254_FR
from .keccak import keccak256

N_ROUNDS = 110
_SEED = b"seed"


@functools.lru_cache(maxsize=None)
def mimc_constants(modulus: int = BN254_FR.modulus, n_rounds: int = N_ROUNDS) -> tuple:
    """gnark-crypto initConstants: rnd = keccak(seed); rnd = keccak(rnd);
    then round i uses keccak^(i+1)(rnd) reduced mod p (big-endian)."""
    rnd = keccak256(_SEED)
    out = []
    for _ in range(n_rounds):
        rnd_next = keccak256(rnd)
        out.append(int.from_bytes(rnd_next, "big") % modulus)
        rnd = rnd_next
    return tuple(out)


# --------------------------------------------------------------------- native
class MiMC:
    """Host oracle, mirrors gnark-crypto's digest over field elements."""

    def __init__(self, modulus: int = BN254_FR.modulus):
        self.p = modulus
        self.cts = mimc_constants(modulus)
        self.h = 0
        self.data: list[int] = []

    def write(self, *vals: int):
        self.data.extend(int(v) % self.p for v in vals)

    def _encrypt(self, m: int) -> int:
        p, h = self.p, self.h
        x = m
        for c in self.cts:
            t = (x + h + c) % p
            x = pow(t, 5, p)
        return (x + h) % p

    def sum(self) -> int:
        for m in self.data:
            r = self._encrypt(m)
            self.h = (self.h + r + m) % self.p
        self.data = []
        return self.h

    def reset(self):
        self.h = 0
        self.data = []


def mimc_hash(vals, modulus: int = BN254_FR.modulus) -> int:
    h = MiMC(modulus)
    h.write(*vals)
    return h.sum()


# --------------------------------------------------------------------- gadget
class MiMCGadget:
    """In-circuit MiMC (same transcript as the native oracle).

    api: any builder exposing add/mul (frontend.Builder or PlonkBuilder)."""

    def __init__(self, api):
        self.api = api
        self.cts = mimc_constants(api.p)
        self.h = 0
        self.data: list = []

    def write(self, *vals):
        self.data.extend(vals)

    def _pow5(self, x):
        api = self.api
        r = api.mul(x, x)
        r = api.mul(r, r)
        return api.mul(r, x)

    def _encrypt(self, m):
        api = self.api
        x = m
        for c in self.cts:
            x = self._pow5(api.add(x, self.h, c))
        return api.add(x, self.h)

    def sum(self):
        api = self.api
        for m in self.data:
            r = self._encrypt(m)
            self.h = api.add(self.h, r, m)
        self.data = []
        return self.h

    def reset(self):
        self.h = 0
        self.data = []
