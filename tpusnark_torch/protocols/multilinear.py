"""Multilinear-extension helpers over big ints (host side).

The gnark-crypto `polynomial.MultiLin` analog (used by gnark's GKR at
gnark/std/gkr + gnark-crypto/ecc/bn254/fr/polynomial): a multilinear
polynomial on {0,1}^n stored as its 2^n evaluations, with fix-first-variable
folding and point evaluation. Host-side big-int math — these tables are the
prover's bookkeeping, tiny next to the SNARK hot path; device offload of GKR
layer evaluation happens at the jfield level when tables are large.

The port's copy of tpusnark/protocols/multilinear.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


class MultiLin:
    """Evaluations of a multilinear polynomial on the boolean hypercube,
    index i = (x_{n-1},...,x_0) with x_0 the LOW bit = FIRST variable."""

    def __init__(self, evals: list[int], p: int):
        assert len(evals) & (len(evals) - 1) == 0, "length must be a power of 2"
        self.e = [v % p for v in evals]
        self.p = p

    @property
    def n_vars(self) -> int:
        return (len(self.e) - 1).bit_length()

    def fix_first(self, r: int) -> "MultiLin":
        """Bind the first variable to r: f'(x') = f(r, x')."""
        p = self.p
        half = len(self.e) // 2
        out = [0] * half
        for i in range(half):
            lo = self.e[2 * i]      # x_0 = 0
            hi = self.e[2 * i + 1]  # x_0 = 1
            out[i] = (lo + r * (hi - lo)) % p
        return MultiLin(out, p)

    def evaluate(self, point: list[int]) -> int:
        cur = self
        for r in point:
            cur = cur.fix_first(r)
        assert len(cur.e) == 1
        return cur.e[0]

    def __len__(self):
        return len(self.e)


def eq_table(point: list[int], p: int) -> MultiLin:
    """eq(x, point) for x over the hypercube — the Lagrange kernel, computed
    in O(2^n) by successive doubling (same trick as gnark-crypto's
    `FoldedEqTable`)."""
    table = [1]
    for r in point:
        half = len(table)
        nxt = [0] * (2 * half)
        for i, t in enumerate(table):
            tr = (t * r) % p
            nxt[i] = (t - tr) % p       # new variable = 0 -> (1 - r)
            nxt[i + half] = tr          # new variable = 1 -> r
        table = nxt
    return MultiLin(table, p)


def interpolate_univariate(xs_ys: list[tuple[int, int]], x: int, p: int) -> int:
    """Lagrange-interpolate the points and evaluate at x (verifier side)."""
    acc = 0
    for i, (xi, yi) in enumerate(xs_ys):
        num, den = 1, 1
        for j, (xj, _) in enumerate(xs_ys):
            if i == j:
                continue
            num = num * ((x - xj) % p) % p
            den = den * ((xi - xj) % p) % p
        acc = (acc + yi * num * pow(den, p - 2, p)) % p
    return acc
