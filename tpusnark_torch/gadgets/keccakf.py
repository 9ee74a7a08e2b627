"""In-circuit Keccak-f[1600] permutation: the std/permutation/keccakf analog.

Reference: gnark/std/permutation/keccakf/keccakf.go — the bare
permutation over 25 U64 words (sponge constructions layer on top, as in the
reference's std/hash/sha3). Words are uints-gadget bit lists (LSB first, 64
bits); xor/and/not are per-bit boolean gates, rotations are free
(bit-index permutations). Round constants and rotation offsets are shared
with the host oracle (`hashes.keccak`), which the tests compare against.

The port's copy of tpusnark/gadgets/keccakf.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..hashes.keccak import _RC, _ROT
from . import uints as u


def keccak_f(api, state):
    """Permute `state`: 25 64-bit words (list, index x + 5*y), each a
    uints bit-list. Returns the permuted 25 words."""
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = []
        for x in range(5):
            t = a[x][0]
            for y in range(1, 5):
                t = u.xor(api, t, a[x][y])
            c.append(t)
        d = [u.xor(api, c[(x - 1) % 5], u.rotl(c[(x + 1) % 5], 1)) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] = u.xor(api, a[x][y], d[x])
        # rho + pi
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = u.rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = u.xor(
                    api,
                    b[x][y],
                    u.and_(api, u.not_(api, b[(x + 1) % 5][y]), b[(x + 2) % 5][y]),
                )
        # iota
        a[0][0] = u.xor(api, a[0][0], u.from_const(rc, 64))
    return [a[x][y] for y in range(5) for x in range(5)]
