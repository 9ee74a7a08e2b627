"""Constraint-system IR (the port's copy of tpusnark/constraint/system.py).

Reference design being reproduced (not translated): gnark keeps one packed
instruction stream + coefficient table + wire levels
(gnark/constraint/core.go:30-130, blueprint.go:9-76,
instruction_tree.go:7-25).

Wire layout after finalize() (gnark R1CS convention): wire 0 is the
constant-one public wire, then public inputs, secret inputs, internal wires.
Inputs may be declared in any order while building; finalize() renumbers.

Coefficient table: deduplicated big-int coefficients with gnark's reserved
ids 0,1,2,-1 (gnark/frontend/cs/coeff_table.go:10-34).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# reserved coefficient ids (gnark convention)
COEFF_ZERO = 0
COEFF_ONE = 1
COEFF_TWO = 2
COEFF_MINUS_ONE = 3


@dataclass
class Hint:
    """Out-of-circuit callback: fn(field_modulus, inputs) -> outputs.

    gnark analog: constraint/solver/hint.go:87-98. Inputs are evaluated
    linear expressions; outputs are fresh internal wires."""

    fn: object
    inputs: list  # list of LinExp (list of (cid, vid))
    outputs: list  # wire ids


@dataclass
class R1C:
    """L * R = O, each a linear expression: list of (coeff_id, wire_id)."""

    L: list
    R: list
    O: list


@dataclass
class Groth16Commitment:
    """BSB22 commitment metadata (gnark constraint/commitment.go:9-14).

    public_and_commitment_committed: sorted wire ids of committed public
    inputs followed by committed earlier-commitment wires; private_committed:
    sorted wire ids of committed private/internal wires; commitment_index:
    the wire holding the commitment challenge (the hint output)."""

    public_and_commitment_committed: list
    nb_public_committed: int
    private_committed: list
    commitment_index: int


class ConstraintSystem:
    """R1CS over a prime field (SCS/Plonkish lives in scs.py)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.coeffs: list[int] = [0, 1, 2, modulus - 1]
        self._coeff_ids: dict[int, int] = {0: 0, 1: 1, 2: 2, modulus - 1: 3}
        # provisional wires: kind per id; wire 0 = constant-one public wire
        self._wire_kind: list[str] = ["pub"]
        self.public_names: list[str] = ["1"]
        self.secret_names: list[str] = []
        self.constraints: list[R1C] = []
        # instructions in emission order: ("r1c", cidx, solved) | ("hint", Hint, None)
        self.instructions: list[tuple] = []
        # wire -> instruction index that defines it (solver dependency edges)
        self.wire_def: dict[int, int] = {}
        self.debug_info: list[str | None] = []
        from ..debug import SymbolTable

        # interned user call-stack records (gnark debug/symbol_table.go);
        # populated only under TPUSNARK_DEBUG=1
        self.symbols = SymbolTable()
        self.commitments: list[Groth16Commitment] = []
        # api.Println entries: [("const", int) | ("lin", [(cid, wid), ...])];
        # resolved into solve_logs by the solver (reference core.go:98)
        self.logs: list = []
        self.solve_logs: list[str] = []
        self._finalized = False

    # ------------------------------------------------------------------ wires
    @property
    def n_public(self) -> int:
        return len(self.public_names)

    @property
    def n_secret(self) -> int:
        return len(self.secret_names)

    @property
    def n_wires(self) -> int:
        return len(self._wire_kind)

    @property
    def n_internal(self) -> int:
        return self.n_wires - self.n_public - self.n_secret

    def add_public(self, name: str) -> int:
        self.public_names.append(name)
        self._wire_kind.append("pub")
        return len(self._wire_kind) - 1

    def add_secret(self, name: str) -> int:
        self.secret_names.append(name)
        self._wire_kind.append("sec")
        return len(self._wire_kind) - 1

    def new_internal(self) -> int:
        self._wire_kind.append("int")
        return len(self._wire_kind) - 1

    # ------------------------------------------------------------------ coeffs
    def coeff_id(self, c: int) -> int:
        c = c % self.modulus
        cid = self._coeff_ids.get(c)
        if cid is None:
            cid = len(self.coeffs)
            self.coeffs.append(c)
            self._coeff_ids[c] = cid
        return cid

    # ------------------------------------------------------------- instructions
    def add_r1c(self, L, R, O, solved_wire: int | None = None, dbg: str | None = None) -> int:
        """Append constraint L*R=O. If solved_wire is given, the solver derives
        that wire from this constraint."""
        from .. import profile

        if profile.is_active():  # gnark: profile.RecordConstraint, core.go:347
            profile.record_constraint()
        idx = len(self.constraints)
        self.constraints.append(R1C(list(L), list(R), list(O)))
        iidx = len(self.instructions)
        self.instructions.append(("r1c", idx, solved_wire))
        if solved_wire is not None:
            self.wire_def[solved_wire] = iidx
        from ..debug import maybe_capture

        self.debug_info.append(maybe_capture(self.symbols, dbg))
        return idx

    def debug_str(self, idx: int) -> str | None:
        """Resolve debug_info[idx] (string or interned stack ref) to text."""
        from ..debug import format_dbg

        return format_dbg(getattr(self, "symbols", None), self.debug_info[idx])

    def add_hint(self, fn, inputs, n_out: int) -> list[int]:
        outs = [self.new_internal() for _ in range(n_out)]
        h = Hint(fn, [list(e) for e in inputs], outs)
        iidx = len(self.instructions)
        self.instructions.append(("hint", h, None))
        for w in outs:
            self.wire_def[w] = iidx
        return outs

    # ---------------------------------------------------------------- finalize
    def finalize(self):
        """Renumber wires to [1 | publics | secrets | internals] (gnark
        layout, required by Groth16 key split). Idempotent."""
        if self._finalized:
            return self
        order = {"pub": 0, "sec": 1, "int": 2}
        ids = sorted(range(self.n_wires), key=lambda w: (order[self._wire_kind[w]], w))
        perm = [0] * self.n_wires
        for new, old in enumerate(ids):
            perm[old] = new

        def remap_expr(e):
            return [(cid, perm[vid]) for cid, vid in e]

        self.logs = [
            [
                ("lin", remap_expr(v)) if kind == "lin" else (kind, v)
                for kind, v in entry
            ]
            for entry in self.logs
        ]

        for c in self.constraints:
            c.L = remap_expr(c.L)
            c.R = remap_expr(c.R)
            c.O = remap_expr(c.O)
        new_insts = []
        for inst in self.instructions:
            if inst[0] == "r1c":
                solved = inst[2]
                new_insts.append(("r1c", inst[1], None if solved is None else perm[solved]))
            else:
                h = inst[1]
                h.inputs = [remap_expr(e) for e in h.inputs]
                h.outputs = [perm[w] for w in h.outputs]
                new_insts.append(inst)
        self.instructions = new_insts
        self.wire_def = {perm[w]: i for w, i in self.wire_def.items()}
        for cm in self.commitments:
            cm.public_and_commitment_committed = sorted(
                perm[w] for w in cm.public_and_commitment_committed
            )
            cm.private_committed = sorted(perm[w] for w in cm.private_committed)
            cm.commitment_index = perm[cm.commitment_index]
        self._wire_kind = [self._wire_kind[old] for old in ids]
        self._finalized = True
        return self

    # ---------------------------------------------------------------- levels
    def compute_levels(self) -> list[list[int]]:
        """Group instructions into dependency levels (gnark's Levels,
        constraint/core.go:117): all instructions in a level depend only on
        wires defined in earlier levels -> solvable in parallel."""
        n_inst = len(self.instructions)
        level = [0] * n_inst

        def wire_level(w):
            d = self.wire_def.get(w)
            return -1 if d is None else level[d]

        for i, inst in enumerate(self.instructions):
            kind = inst[0]
            deps = []
            if kind == "r1c":
                c = self.constraints[inst[1]]
                solved = inst[2]
                for e in (c.L, c.R, c.O):
                    for _, vid in e:
                        if vid != solved:
                            deps.append(vid)
            else:
                h = inst[1]
                for e in h.inputs:
                    for _, vid in e:
                        deps.append(vid)
            lv = 0
            for w in deps:
                wl = wire_level(w)
                if wl + 1 > lv:
                    lv = wl + 1
            level[i] = lv
        n_levels = max(level) + 1 if n_inst else 0
        out = [[] for _ in range(n_levels)]
        for i, lv in enumerate(level):
            out[lv].append(i)
        return out

    # ------------------------------------------------------------- term arenas
    def term_arrays(self):
        """Flatten all constraints into numpy arenas for device evaluation:
        returns dict name -> (row_ids, coeff_ids, wire_ids)."""
        out = {}
        for name in ("L", "R", "O"):
            rows, cids, vids = [], [], []
            for i, c in enumerate(self.constraints):
                for cid, vid in getattr(c, name):
                    rows.append(i)
                    cids.append(cid)
                    vids.append(vid)
            out[name] = (
                np.asarray(rows, dtype=np.int32),
                np.asarray(cids, dtype=np.uint32),
                np.asarray(vids, dtype=np.int32),
            )
        return out

    def stats(self) -> dict:
        return {
            "n_constraints": len(self.constraints),
            "n_wires": self.n_wires,
            "n_public": self.n_public,
            "n_secret": self.n_secret,
            "n_internal": self.n_internal,
            "n_coeffs": len(self.coeffs),
            "n_levels": len(self.compute_levels()),
        }
