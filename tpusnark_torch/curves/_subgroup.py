"""Shared raw-scalar ladder for subgroup checks.

Host curve modules' `mul(P, k)` reduce k mod the group order r, which makes
`mul(P, r)` a multiply-by-zero — a vacuous subgroup test.
`ladder_mul_raw` runs the same double-and-add WITHOUT the reduction so
`ladder_mul_raw(G, P, r) is None` genuinely tests r-torsion membership
(the reference rejects out-of-subgroup points at point unmarshal via
gnark-crypto's subgroup checks; we check at Verify time instead).

The port's copy of tpusnark/curves/_subgroup.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


def ladder_mul_raw(G, p1, k: int):
    """[k]P by double-and-add over group-class G, with NO mod-r reduction."""
    acc = None
    while k:
        if k & 1:
            acc = G.add(acc, p1)
        p1 = G.double(p1)
        k >>= 1
    return acc
