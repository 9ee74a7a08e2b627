"""Range checker: commit-based (log-derivative lookup) with decomposition
fallback — the gnark std/rangecheck analog.

Reference surface: std/rangecheck/rangecheck.go:24 (New picks the
commit-based checker when the builder supports commitments, else plain
bit decomposition) and rangecheck_commit.go (collect checks, defer one
batched argument: decompose every checked value into base-2^c limbs via a
hint, constrain the recomposition, and look all limbs up in the [0, 2^c)
table; a shifted extra lookup handles non-multiple-of-c widths).

The port's copy of tpusnark/gadgets/rangecheck.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..constraint.hints import register_hint
from ..constraint.system import COEFF_ONE
from ..frontend.builder import Var
from .lookup import LookupTable


def decompose_hint(p, ins):
    """ins = [n_limbs, base_bits, value] -> limbs (little-endian)."""
    n, c, v = int(ins[0]), int(ins[1]), int(ins[2]) % p
    return [(v >> (c * i)) & ((1 << c) - 1) for i in range(n)]


register_hint(decompose_hint)

_KV_KEY = "rangechecker"


def range_checker(api, base_bits: int = 8) -> "RangeChecker":
    """The builder-wide shared checker (gnark newCommitRangechecker's
    kvstore discipline: one batched argument per circuit)."""
    rc = api.kv.get(_KV_KEY)
    if rc is None:
        rc = RangeChecker(api, base_bits)
        api.kv[_KV_KEY] = rc
    return rc


class RangeChecker:
    def __init__(self, api, base_bits: int = 8):
        self.api = api
        self.c = base_bits
        self.collected: list = []  # (var, bits)
        self.closed = False
        api.defer_(self._commit)

    def check(self, v, bits: int):
        """Constrain v < 2^bits."""
        if self.closed:
            raise RuntimeError("range checker already closed")
        assert 0 < bits <= self.api.p.bit_length() - 2
        self.collected.append((v, bits))

    def _commit(self, api):
        if self.closed:
            return
        self.closed = True
        if not self.collected:
            return
        c = self.c
        cs = api.cs
        table = LookupTable(api)
        for i in range(1 << c):
            table.insert(i)

        to_look: list = []
        for v, bits in self.collected:
            k = -(-bits // c)
            hint_inputs = [
                [(cs.coeff_id(k), 0)],
                [(cs.coeff_id(c), 0)],
                api._lin(v),
            ]
            outs = cs.add_hint(decompose_hint, hint_inputs, k)
            limbs = [Var(((COEFF_ONE, w),)) for w in outs]
            # recomposition: sum limb_i * 2^(c*i) == v
            acc_terms = []
            for i, lv in enumerate(limbs):
                acc_terms.extend(api._lin(api._scale(lv, 1 << (c * i))))
            api.assert_is_equal(api._merge(acc_terms), v)
            to_look.extend(limbs)
            top_bits = bits - c * (k - 1)
            if top_bits < c:
                # top limb must fit top_bits: its shifted copy must also be
                # in [0, 2^c) (rangecheck_commit.go's shifted check)
                to_look.append(api._scale(limbs[-1], 1 << (c - top_bits)))
        table.lookup(*to_look)