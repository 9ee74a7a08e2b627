"""Log-derivative lookup tables (Haböck22), the gnark logderivlookup analog.

Reference surface being reproduced:
- std/lookup/logderivlookup/logderivlookup.go:60-92 — append-only Table with
  Insert (returns a constant index) and Lookup (values via hint), the lookup
  results recorded as (index, value) query rows;
- std/internal/logderivarg/logderivarg.go — the closing argument emitted at
  compile time (via Defer):
      sum_i count_i / (x - rlc(table_i)) == sum_q 1 / (x - rlc(query_q))
  where x is a BSB22 commitment over everything and rlc combines the
  (index, value) rows with in-circuit-MiMC-derived coefficients;
- constraint/blueprint_logderivlookup.go:13 — the solving-time lookup is a
  hint here (same semantics, no opcode system needed: the hint carries the
  table entries as extra inputs).

Soundness: the commitment challenge binds the counts, queries and (variable)
entries before the rational identity is checked, so a prover cannot pick
query values outside the table (Schwartz–Zippel over the random challenge).

The port's copy of tpusnark/gadgets/lookup.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..constraint.hints import register_hint
from ..constraint.system import COEFF_ONE
from ..frontend.builder import Var


def lookup_hint(p, ins):
    """ins = [n_entries, n_queries, entries..., indices...] -> values."""
    n_e, n_q = int(ins[0]), int(ins[1])
    entries = ins[2 : 2 + n_e]
    inds = ins[2 + n_e :]
    assert len(inds) == n_q, "lookup hint arity mismatch"
    out = []
    for i in inds:
        i = int(i)
        if not 0 <= i < n_e:
            raise ValueError(f"lookup index {i} out of range [0, {n_e})")
        out.append(entries[i] % p)
    return out


def count_hint(p, ins):
    """ins = [n_table, table pairs (i, entry)..., query pairs (ind, val)...]
    -> per-table-row multiplicities (logderivarg countHint analog)."""
    n_t = int(ins[0])
    rows = ins[1:]
    table = [(int(rows[2 * i]) % p, int(rows[2 * i + 1]) % p) for i in range(n_t)]
    queries = rows[2 * n_t :]
    counts: dict = {}
    for j in range(0, len(queries), 2):
        key = (int(queries[j]) % p, int(queries[j + 1]) % p)
        counts[key] = counts.get(key, 0) + 1
    return [counts.get(row, 0) for row in table]


register_hint(lookup_hint)
register_hint(count_hint)


class LookupTable:
    """Append-only lookup table bound to an R1CS Builder.

    t = LookupTable(api); idx = t.insert(v); outs = t.lookup(i0, i1, ...).
    The log-derivative argument is emitted automatically at api.compile()."""

    def __init__(self, api):
        self.api = api
        self.entries: list = []
        self.queries: list = []  # (index Var/int, value Var) pairs
        self.immutable = False
        api.defer_(self._commit)

    def insert(self, val) -> int:
        if self.immutable:
            raise RuntimeError("inserting into committed lookup table")
        self.entries.append(val)
        return len(self.entries) - 1

    def lookup(self, *inds):
        if self.immutable:
            raise RuntimeError("looking up from committed lookup table")
        if not self.entries:
            raise RuntimeError("looking up from empty table")
        if not inds:
            return []
        api = self.api
        cs = api.cs
        hint_inputs = [
            [(cs.coeff_id(len(self.entries)), 0)],
            [(cs.coeff_id(len(inds)), 0)],
        ]
        hint_inputs += [api._lin(e) for e in self.entries]
        hint_inputs += [api._lin(i) for i in inds]
        outs = cs.add_hint(lookup_hint, hint_inputs, len(inds))
        vals = [Var(((COEFF_ONE, w),)) for w in outs]
        self.queries.extend(zip(inds, vals))
        return vals

    # ---------------------------------------------------------------- closing
    def _commit(self, api):
        if self.immutable or not self.queries:
            self.immutable = True
            return
        self.immutable = True
        cs = api.cs

        # counts: how many queries hit each table row
        n_t = len(self.entries)
        count_inputs = [[(cs.coeff_id(n_t), 0)]]
        for i, e in enumerate(self.entries):
            count_inputs.append([(cs.coeff_id(i), 0)])
            count_inputs.append(api._lin(e))
        for ind, val in self.queries:
            count_inputs.append(api._lin(ind))
            count_inputs.append(api._lin(val))
        count_ws = cs.add_hint(count_hint, count_inputs, n_t)
        counts = [Var(((COEFF_ONE, w),)) for w in count_ws]

        # commitment binds (variable) entries, queries and counts
        to_commit: list = []
        if any(isinstance(e, Var) for e in self.entries):
            to_commit.extend(e for e in self.entries if isinstance(e, Var))
        for ind, val in self.queries:
            if isinstance(ind, Var):
                to_commit.append(ind)
            to_commit.append(val)
        to_commit.extend(counts)
        x = api.commit(*to_commit)

        # row coefficients from in-circuit MiMC (logderivarg
        # randLinearCoefficients: coeff_i = MiMC(i+1, commitment))
        from ..hashes.mimc import MiMCGadget

        coeffs = []
        for i in range(2):
            h = MiMCGadget(api)
            h.write(i + 1, x)
            coeffs.append(h.sum())

        def rlc(ind, val):
            return api.add(api.mul(coeffs[0], ind), api.mul(coeffs[1], val))

        lp = 0
        for i, e in enumerate(self.entries):
            # DivUnchecked like the reference logderivarg (logderivarg.go:121):
            # a zero denominator means the FS challenge collided with a table
            # row — the argument's own soundness event, not worth a gate
            lp = api.add(lp, api.div_unchecked(counts[i], api.sub(x, rlc(i, e))))
        rp = 0
        for ind, val in self.queries:
            rp = api.add(rp, api.inverse(api.sub(x, rlc(ind, val))))
        api.assert_is_equal(lp, rp)
