"""Sparse (Plonkish) constraint system: gates qL*a + qR*b + qM*a*b + qO*c + qC = 0
(the port's copy of tpusnark/constraint/scs.py: same code).

The analog of gnark's SparseR1CS IR
(gnark/constraint/r1cs_sparse.go:142-151, per-curve system at
gnark/constraint/bn254/system.go + the SCS blueprints in
constraint/blueprint_scs.go). Gates live in flat arrays (wire-id and
coeff-id columns) so trace building (backend/plonk setup BuildTrace,
gnark/backend/plonk/bn254/setup.go:175) and witness-column
construction are single gathers.

Row layout after finalize() (gnark convention,
backend/plonk/bn254/setup.go:110-161): the first n_public rows are public-
input rows (qL = -1, xa = the public wire) so the verifier's PI(X)
polynomial cancels them; circuit gates follow.

The witness solver walks gates in emission order deriving at most one
unknown wire per gate (the reference's instruction solver,
constraint/bn254/solver.go:418-524, specialized to SCS blueprints).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hints import hint_name as hint_name_of
from .system import COEFF_MINUS_ONE, COEFF_ONE, COEFF_ZERO, Hint


@dataclass
class Gate:
    """qL*W[xa] + qR*W[xb] + qM*W[xa]*W[xb] + qO*W[xc] + qC = 0.
    All q* are coeff-table ids; xa/xb/xc are wire ids."""

    xa: int
    xb: int
    xc: int
    qL: int = COEFF_ZERO
    qR: int = COEFF_ZERO
    qO: int = COEFF_ZERO
    qM: int = COEFF_ZERO
    qC: int = COEFF_ZERO


@dataclass
class PlonkCommitment:
    """BSB22 commitment metadata on an SCS (gnark constraint.PlonkCommitment,
    recorded by frontend/cs/scs/api.go:623 Commit). Row indices are
    PRE-public-offset, exactly like gnark's: the trace row is
    n_public + index. The committed rows read `-v + qcp_i(w^row)*P_i(w^row)
    = 0` (qcp selector is 1 there); the commitment row reads
    `-challenge + qk(w^row) = 0` with qk completed by the prover."""

    commitment_index: int  # row of the challenge-injection constraint
    committed: list[int]  # rows of the committed-value constraints


class SparseConstraintSystem:
    def __init__(self, modulus: int):
        self.modulus = modulus
        self.coeffs: list[int] = [0, 1, 2, modulus - 1]
        self._coeff_ids: dict[int, int] = {0: 0, 1: 1, 2: 2, modulus - 1: 3}
        self._wire_kind: list[str] = []
        self.public_names: list[str] = []
        self.secret_names: list[str] = []
        self.gates: list[Gate] = []
        # ("gate", gate_idx, solved_wire | None) | ("hint", Hint, None)
        self.instructions: list[tuple] = []
        self.debug_info: list[str | None] = []
        from ..debug import SymbolTable

        self.symbols = SymbolTable()
        self.commitments: list[PlonkCommitment] = []
        # api.Println entries: [("const", int) | ("affine", (c, wire, k))]
        self.logs: list = []
        self.solve_logs: list[str] = []
        self._finalized = False

    def commitment_skip_rows(self) -> set[int]:
        """Post-finalize trace rows whose gate equation involves the qcp /
        completed-qk columns and therefore cannot be checked by the plain
        gate evaluation (the quotient enforces them)."""
        skip = set()
        for cm in self.commitments:
            skip.add(self.n_public + cm.commitment_index)
            for r in cm.committed:
                skip.add(self.n_public + r)
        return skip

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

    def coeff_id(self, c: int) -> int:
        c = c % self.modulus
        cid = self._coeff_ids.get(c)
        if cid is None:
            cid = len(self.coeffs)
            self.coeffs.append(c)
            self._coeff_ids[c] = cid
        return cid

    # ------------------------------------------------------------- instructions
    def add_gate(self, gate: Gate, solved_wire: int | None = None, dbg=None) -> int:
        from .. import profile

        if profile.is_active():
            profile.record_constraint()
        idx = len(self.gates)
        self.gates.append(gate)
        self.instructions.append(("gate", idx, solved_wire))
        from ..debug import maybe_capture

        self.debug_info.append(maybe_capture(self.symbols, dbg))
        return idx

    def debug_str(self, idx: int) -> str | None:
        """Resolve debug_info[idx] (string or interned stack ref) to text."""
        from ..debug import format_dbg

        return format_dbg(getattr(self, "symbols", None), self.debug_info[idx])

    def add_hint(self, fn, inputs, n_out: int) -> list[int]:
        """inputs: list of (coeff:int, wire:int, const:int) affine values."""
        outs = [self.new_internal() for _ in range(n_out)]
        self.instructions.append(("hint", Hint(fn, list(inputs), outs), None))
        return outs

    # ---------------------------------------------------------------- finalize
    def finalize(self):
        """Renumber wires to [publics | secrets | internals] and prepend the
        public-input rows (qL=-1). Idempotent."""
        if self._finalized:
            return self
        order = {"pub": 0, "sec": 1, "int": 2}
        ids = sorted(range(self.n_wires), key=lambda w: (order[self._wire_kind[w]], w))
        perm = [0] * self.n_wires
        for new, old in enumerate(ids):
            perm[old] = new
        for g in self.gates:
            g.xa, g.xb, g.xc = perm[g.xa], perm[g.xb], perm[g.xc]
        new_insts = []
        for inst in self.instructions:
            if inst[0] == "gate":
                s = inst[2]
                new_insts.append(("gate", inst[1], None if s is None else perm[s]))
            else:
                h = inst[1]
                h.inputs = [(c, perm[w], k) for (c, w, k) in h.inputs]
                h.outputs = [perm[w] for w in h.outputs]
                new_insts.append(inst)
        self.instructions = new_insts
        self._wire_kind = [self._wire_kind[old] for old in ids]
        def remap_log(kind, v):
            if kind == "affine":
                c, w, k = v
                return ("affine", (c, perm[w], k))
            return (kind, v)

        self.logs = [[remap_log(k_, v_) for k_, v_ in entry] for entry in self.logs]

        # public-input rows at the front (qL = -1, xa = public wire i)
        pub_gates = [
            Gate(xa=i, xb=i, xc=i, qL=COEFF_MINUS_ONE) for i in range(self.n_public)
        ]
        self.gates = pub_gates + self.gates
        self.instructions = [
            ("gate", i, None) for i in range(self.n_public)
        ] + [
            ("gate", inst[1] + self.n_public, inst[2]) if inst[0] == "gate" else inst
            for inst in self.instructions
        ]
        self.debug_info = ["public input"] * self.n_public + self.debug_info
        self._finalized = True
        return self

    @property
    def n_gates(self) -> int:
        return len(self.gates)

    # ------------------------------------------------------------- trace arrays
    def gate_arrays(self):
        """Columns as numpy arrays: (xa, xb, xc) int32 wire ids and
        (qL,qR,qO,qM,qC) coefficient VALUES as python-int lists."""
        n = self.n_gates
        xa = np.fromiter((g.xa for g in self.gates), dtype=np.int32, count=n)
        xb = np.fromiter((g.xb for g in self.gates), dtype=np.int32, count=n)
        xc = np.fromiter((g.xc for g in self.gates), dtype=np.int32, count=n)
        cf = self.coeffs
        q = {
            name: [cf[getattr(g, name)] for g in self.gates]
            for name in ("qL", "qR", "qO", "qM", "qC")
        }
        return (xa, xb, xc), q

    def stats(self) -> dict:
        return {
            "n_gates": self.n_gates,
            "n_wires": self.n_wires,
            "n_public": self.n_public,
            "n_secret": self.n_secret,
            "n_coeffs": len(self.coeffs),
        }


class UnsatisfiedGateError(Exception):
    def __init__(self, idx, dbg=None):
        super().__init__(f"gate #{idx} is not satisfied" + (f": {dbg}" if dbg else ""))
        self.idx = idx


def solve_scs(
    cs: SparseConstraintSystem,
    assignment: dict,
    hint_overrides: dict | None = None,
    logs: bool = True,
) -> list[int]:
    """Solve all wires; returns W with len == n_wires.

    hint_overrides: {hint fn or name -> replacement} — the prover's
    OverrideHint seam (the PLONK prover swaps the BSB22 placeholder for the
    real KZG-commit + hash-to-field, reference prove.go:310-313)."""
    p = cs.modulus
    cf = cs.coeffs
    overrides = {}
    if hint_overrides:
        from .hints import hint_name

        for k, v in hint_overrides.items():
            overrides[k if isinstance(k, str) else hint_name(k)] = v
    skip_rows = cs.commitment_skip_rows()
    W: list = [None] * cs.n_wires
    for i, name in enumerate(cs.public_names):
        W[i] = int(assignment[name]) % p
    for j, name in enumerate(cs.secret_names):
        W[cs.n_public + j] = int(assignment[name]) % p

    def val(w):
        v = W[w]
        if v is None:
            raise RuntimeError(f"wire {w} used before solved")
        return v

    for inst in cs.instructions:
        if inst[0] == "hint":
            h = inst[1]
            ins = [(c * val(w) + k) % p if c % p else k % p for (c, w, k) in h.inputs]
            fn = overrides.get(hint_name_of(h.fn), h.fn) if overrides else h.fn
            outs = fn(p, ins)
            assert len(outs) == len(h.outputs)
            for w, v in zip(h.outputs, outs):
                W[w] = int(v) % p
            continue
        _, gidx, solved = inst
        if gidx in skip_rows:
            # commitment rows: the qcp / completed-qk column (absent here)
            # balances the equation; enforced by the quotient, not the solver
            continue
        if gidx < cs.n_public:
            # public-input row: -w_i + PI(omega^i) = 0 by construction of the
            # verifier's PI polynomial; nothing to check or solve here
            continue
        g = cs.gates[gidx]
        qL, qR, qO, qM, qC = cf[g.qL], cf[g.qR], cf[g.qO], cf[g.qM], cf[g.qC]
        if solved is None:
            a, b, c = val(g.xa), val(g.xb), val(g.xc)
            if (qL * a + qR * b + qM * a * b + qO * c + qC) % p != 0:
                raise UnsatisfiedGateError(gidx, cs.debug_str(gidx))
            continue
        if solved == g.xc and solved not in (g.xa, g.xb):
            a, b = val(g.xa), val(g.xb)
            num = (qL * a + qR * b + qM * a * b + qC) % p
            W[solved] = (-num) * pow(qO, -1, p) % p
        elif solved == g.xa and solved != g.xb:
            b, c = val(g.xb), val(g.xc)
            den = (qL + qM * b) % p
            if den == 0:
                if (qR * b + qO * c + qC) % p != 0:
                    raise UnsatisfiedGateError(gidx, cs.debug_str(gidx))
                W[solved] = 0
            else:
                W[solved] = (-(qR * b + qO * c + qC)) * pow(den, -1, p) % p
        elif solved == g.xb:
            a, c = val(g.xa), val(g.xc)
            den = (qR + qM * a) % p
            if den == 0:
                if (qL * a + qO * c + qC) % p != 0:
                    raise UnsatisfiedGateError(gidx, cs.debug_str(gidx))
                W[solved] = 0
            else:
                W[solved] = (-(qL * a + qO * c + qC)) * pow(den, -1, p) % p
        else:
            raise RuntimeError(f"gate #{gidx}: cannot solve wire {solved}")
    Wout = [w if w is not None else 0 for w in W]
    if cs.logs:
        cs.solve_logs = [] if not logs else [
            " ".join(
                str(v if kind == "const" else (v[0] * Wout[v[1]] + v[2]) % p)
                for kind, v in entry
            )
            for entry in cs.logs
        ]
    return Wout
