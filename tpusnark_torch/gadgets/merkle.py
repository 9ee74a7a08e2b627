"""Merkle proof verification with MiMC (binary tree).

Mirrors gnark/std/accumulator/merkle/verify.go: recompute the
root from a leaf + authentication path, selecting child order with the
path-bit at each level.

The port's copy of tpusnark/gadgets/merkle.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

from ..hashes.mimc import MiMC, MiMCGadget


def verify_merkle_proof(api, root, leaf, path, path_bits):
    """path: list of sibling hashes (circuit vars), leaf->root order.
    path_bits: booleans; bit=1 means the current node is the RIGHT child."""
    cur = leaf
    for sib, bit in zip(path, path_bits):
        left = api.select(bit, sib, cur)
        right = api.select(bit, cur, sib)
        h = MiMCGadget(api)
        h.write(left, right)
        cur = h.sum()
    api.assert_is_equal(cur, root)


# ------------------------------------------------------------------ host side
def merkle_root(leaves: list[int], modulus: int) -> int:
    """Host oracle: complete binary tree (len must be a power of two)."""
    level = [int(x) % modulus for x in leaves]
    assert level and (len(level) & (len(level) - 1)) == 0
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            h = MiMC(modulus)
            h.write(level[i], level[i + 1])
            nxt.append(h.sum())
        level = nxt
    return level[0]


def merkle_path(leaves: list[int], index: int, modulus: int):
    """(siblings, bits) for leaves[index]; bits[i]=1 iff node is right child."""
    level = [int(x) % modulus for x in leaves]
    sibs, bits = [], []
    idx = index
    while len(level) > 1:
        sib = idx ^ 1
        sibs.append(level[sib])
        bits.append(idx & 1)
        nxt = []
        for i in range(0, len(level), 2):
            h = MiMC(modulus)
            h.write(level[i], level[i + 1])
            nxt.append(h.sum())
        level = nxt
        idx //= 2
    return sibs, bits
