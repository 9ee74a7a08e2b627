"""Witness solver on the device, whole dependency levels at once
(counterpart of tpusnark/constraint/solver_jax.py).

gnark analog: the level-parallel solver (gnark/constraint/bn254/solver.go:
418-524) walks `Levels` with a worker pool; here each level is a few batched
operations over all of its instructions:

  * the wire vector W lives on the device as (words, n_wires) Montgomery
    words, written in place level by level (tpusnark's W is immutable: a
    new array a level);
  * per level: gather the known terms of L, R and O (coefficient ids, wire
    ids), evaluate them with one Montgomery product (B1) and one modular
    segment sum each, derive every unknown at once (in O: w = (l*r -
    o_rest)/k; in L: w = (o/r - l_rest)/k; in R symmetric, with gnark's
    zero-denominator convention w = 0), and scatter them into W;
  * a level's arenas (codes, 1/k, targets, the L/R/O term triples) are put
    on the device once, when the solver is built; tpusnark uploads them at
    every solve and pads them to powers of two to bound its JIT compiles,
    which PyTorch's eager launches do not need;
  * a level inverts r only if one of its instructions has its unknown in
    L, and l only if one has it in R (tpusnark inverts both on every level
    once any level needs one; the lanes that do not use them discard them);
  * an instruction that solves no wire (a pure check) is left to the bulk
    check: tpusnark evaluates it in its level and writes nothing;
  * hints sync to the host once per hint-bearing level: their inputs are
    evaluated on the device, decoded, run in Python, re-encoded and
    scattered;
  * satisfaction is checked in one bulk pass at the end (A_i * B_i == C_i
    for every constraint, through the port's ABCEvaluator), whose A/B/C the
    Groth16 prover takes as they are.

The chain (one instruction a level) stays on the host solver
(``solver.solve``): ``solve_any`` picks by the level shape, before anything
runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..fields.tfield import Field, compute_device, get_field
from .eval_torch import abc_evaluator
from .hints import hint_name
from .solver import UnsatisfiedConstraintError
from .system import ConstraintSystem

CODE_O, CODE_L, CODE_R = 1, 2, 3


def _terms(rows, cids, vids, device):
    """(rows, cids, vids, max_segment) of a segment sum, as int64 tensors on
    `device`; max_segment is the most terms of any row (at least 1)."""
    r = np.asarray(rows, dtype=np.int64)
    max_seg = int(np.bincount(r).max()) if r.size else 1
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device) for a in (r, cids, vids)) + (max_seg,)


class _LevelPlan:
    """One dependency level's arenas, on the solver's device: the
    instructions that solve a wire (codes, 1/k in Montgomery form, target
    wires, a term triple per side) and the hints with theirs."""

    __slots__ = ("nI", "terms", "is_l", "is_r", "kinv", "targets", "hints", "hint_terms", "n_hint_inputs")


class LevelSolver:
    """Device solver bound to (ConstraintSystem, Field, device): the card
    unless the caller names the CPU. Build once, reuse."""

    def __init__(self, cs: ConstraintSystem, field: Field, device="cuda"):
        cs.finalize()
        self.cs = cs
        self.f = field
        self.device = device = compute_device(device)
        p = cs.modulus
        self.coeffs = field.encode(cs.coeffs, mont=True, device=device)
        self.plans: list[_LevelPlan] = []
        for insts in cs.compute_levels():
            plan = _LevelPlan()
            rows = {s: [] for s in "LRO"}
            cids = {s: [] for s in "LRO"}
            vids = {s: [] for s in "LRO"}
            code, kinv, targets, hints = [], [], [], []
            for ii in insts:
                inst = cs.instructions[ii]
                if inst[0] == "hint":
                    hints.append(inst[1])
                    continue
                _, cidx, solved = inst
                if solved is None:
                    continue  # a pure check: the bulk check holds it
                c = cs.constraints[cidx]
                li = len(code)
                k, where = 0, None
                for side, e in (("L", c.L), ("R", c.R), ("O", c.O)):
                    for cid, vid in e:
                        if vid == solved:
                            k = (k + cs.coeffs[cid]) % p
                            if where is not None and where != side:
                                raise RuntimeError(f"constraint #{cidx}: solved wire in multiple expressions")
                            where = side
                        else:
                            rows[side].append(li)
                            cids[side].append(cid)
                            vids[side].append(vid)
                code.append({"O": CODE_O, "L": CODE_L, "R": CODE_R}[where])
                kinv.append(pow(k, -1, p))
                targets.append(solved)
            plan.nI = len(code)
            code_t = torch.tensor(code, dtype=torch.int64, device=device)
            plan.is_l = code_t == CODE_L if CODE_L in code else None
            plan.is_r = code_t == CODE_R if CODE_R in code else None
            plan.kinv = field.encode(kinv, mont=True, device=device)
            plan.targets = torch.tensor(targets, dtype=torch.int64, device=device)
            plan.terms = {s: _terms(rows[s], cids[s], vids[s], device) for s in "LRO"}
            plan.hints = hints
            h_rows, h_cids, h_vids = [], [], []
            n_in = 0
            for h in hints:
                for e in h.inputs:
                    for cid, vid in e:
                        h_rows.append(n_in)
                        h_cids.append(cid)
                        h_vids.append(vid)
                    n_in += 1
            plan.n_hint_inputs = n_in
            plan.hint_terms = _terms(h_rows, h_cids, h_vids, device)
            self.plans.append(plan)

    def _eval(self, W, n, rows, cids, vids, max_seg):
        """(words, n) Montgomery values of n linear expressions given as a
        term triple."""
        f = self.f
        if rows.shape[0] == 0:
            return f.zeros((n,), device=W.device)
        return f.segment_sum(f.mul(self.coeffs[:, cids], W[:, vids]), rows, n, max_seg)

    def _run_level(self, W, plan):
        f, n = self.f, plan.nI
        l, r, o = (self._eval(W, n, *plan.terms[s]) for s in "LRO")
        # in O: w = (l*r - o_rest) / k
        w = f.mul(f.sub(f.mul(l, r), o), plan.kinv)
        if plan.is_l is not None:
            # in L: (l_rest + k*w) * r = o  ->  w = (o/r - l_rest) / k; 0 where r = 0
            w_l = f.mul(f.sub(f.mul(o, f.inv(r)), l), plan.kinv)
            w = torch.where(plan.is_l, torch.where(f.is_zero(r), 0, w_l), w)
        if plan.is_r is not None:
            w_r = f.mul(f.sub(f.mul(o, f.inv(l)), r), plan.kinv)
            w = torch.where(plan.is_r, torch.where(f.is_zero(l), 0, w_r), w)
        W[:, plan.targets] = w

    def _run_hints(self, W, plan, overrides):
        """One host sync for all of a level's hints."""
        f, p = self.f, self.cs.modulus
        vals = f.decode(self._eval(W, plan.n_hint_inputs, *plan.hint_terms))
        out_wires, out_vals = [], []
        off = 0
        for h in plan.hints:
            fn = overrides.get(hint_name(h.fn), h.fn) if overrides else h.fn
            n_in = len(h.inputs)
            outs = fn(p, vals[off : off + n_in])
            off += n_in
            if len(outs) != len(h.outputs):
                raise RuntimeError(f"hint {hint_name(h.fn)}: {len(outs)} outputs, want {len(h.outputs)}")
            out_wires.extend(h.outputs)
            out_vals.extend(int(v) % p for v in outs)
        idx = torch.tensor(out_wires, dtype=torch.int64, device=W.device)
        W[:, idx] = f.encode(out_vals, mont=True, device=W.device)

    def solve_with_abc(self, assignment: dict, hint_overrides: dict | None = None):
        """-> (W, (A, B, C)): W the (words, n_wires) Montgomery wire vector
        on the device, and the per-constraint evaluations of the bulk check,
        each (words, n_constraints) Montgomery (the Groth16 prover's input,
        as the reference fills a/b/c during its solve,
        gnark/constraint/bn254/solver.go:532). Raises
        UnsatisfiedConstraintError at the first unsatisfied constraint.

        hint_overrides: {hint fn or name -> replacement}, the prover's
        OverrideHint seam (same contract as solver.solve): BSB22 needs it."""
        cs, f = self.cs, self.f
        p = cs.modulus
        n_in = cs.n_public + len(cs.secret_names)
        init = [0] * n_in
        init[0] = 1
        for i, name in enumerate(cs.public_names[1:], start=1):
            if name not in assignment:
                raise KeyError(f"missing public input {name!r}")
            init[i] = int(assignment[name]) % p
        for j, name in enumerate(cs.secret_names):
            if name not in assignment:
                raise KeyError(f"missing secret input {name!r}")
            init[cs.n_public + j] = int(assignment[name]) % p
        W = f.zeros((cs.n_wires,), device=self.device)
        W[:, :n_in] = f.encode(init, mont=True, device=self.device)
        overrides = {k if isinstance(k, str) else hint_name(k): v for k, v in (hint_overrides or {}).items()}
        for plan in self.plans:
            if plan.nI:
                self._run_level(W, plan)
            if plan.hints:
                self._run_hints(W, plan, overrides)
        return W, self._check(W)

    def solve(self, assignment: dict, hint_overrides: dict | None = None):
        """The (words, n_wires) Montgomery wire vector on the device."""
        return self.solve_with_abc(assignment, hint_overrides)[0]

    def _check(self, W):
        """Bulk satisfaction check: A_i * B_i == C_i for every constraint;
        returns (A, B, C)."""
        f = self.f
        A, B, C = abc_evaluator(self.cs, f, self.device)(W)
        bad = ~f.eq(f.mul(A, B), C)
        if bool(bad.any()):
            idx = int(bad.nonzero()[0, 0])
            raise UnsatisfiedConstraintError(idx, self.cs.debug_str(idx))
        return A, B, C


def get_level_solver(cs: ConstraintSystem, spec: FieldSpec, device="cuda") -> LevelSolver:
    """The solver of `cs` over `spec` on `device` (the card unless the caller
    names the CPU), cached on the constraint system as abc_evaluator caches
    its evaluator: a collected system cannot alias a new one."""
    device = compute_device(device)
    cache = cs.__dict__.setdefault("_torch_level_solvers", {})
    key = (spec.name, str(device))
    s = cache.get(key)
    if s is None:
        s = cache[key] = LevelSolver(cs, get_field(spec), device)
    return s


def solve_torch(cs: ConstraintSystem, assignment: dict, spec: FieldSpec, device="cuda"):
    """Device solve; returns the (words, n_wires) Montgomery wire vector."""
    return get_level_solver(cs, spec, device).solve(assignment)


def solve_torch_ints(cs: ConstraintSystem, assignment: dict, spec: FieldSpec, device="cuda") -> list[int]:
    """Device solve, decoded to Python ints (the oracle-comparison form)."""
    return get_field(spec).decode(solve_torch(cs, assignment, spec, device))


# ---- host/device picker ------------------------------------------------------
# tpusnark's thresholds (solver_jax.py:340-341), like gnark's minWorkPerCPU
# split (gnark/constraint/bn254/solver.go:422): below this mean level width
# the per-level launches and host syncs outweigh the work of a level, and
# the serial host solver wins.
MIN_MEAN_LEVEL_WIDTH = 64
MIN_TOTAL_INSTRUCTIONS = 4096


def prefer_device(cs: ConstraintSystem) -> bool:
    """Device-solve iff the level structure is wide enough to amortise the
    per-level launches (the chain, one instruction a level, stays on the
    host). The level shape (instructions, levels) is cached on the finalized
    system: grouping a 2^17 chain into levels takes longer than its solve."""
    cs.finalize()
    shape = cs.__dict__.get("_torch_level_shape")
    if shape is None:
        levels = cs.compute_levels()
        shape = cs._torch_level_shape = (sum(len(lv) for lv in levels), len(levels))
    n_inst, n_levels = shape
    if n_inst < MIN_TOTAL_INSTRUCTIONS or not n_levels:
        return False
    return n_inst / n_levels >= MIN_MEAN_LEVEL_WIDTH


def solve_any(
    cs: ConstraintSystem,
    assignment: dict,
    spec: FieldSpec,
    hint_overrides: dict | None = None,
    force_host: bool = False,
    logs: bool = True,
    device="cuda",
):
    """Solve on `device` (the card unless the caller names the CPU) when the
    level shape favours it, else on the host; the choice is made before
    anything runs, and a failure of either raises.

    Returns (W_mont, abc, W_ints): W_mont (words, n_wires) on the device and
    abc = (A, B, C) from its bulk check, or W_ints (Python ints) from the
    host solver. force_host pins the host solver (ProverConfig
    accelerator="host")."""
    device = compute_device(device)
    if not force_host and prefer_device(cs):
        W, abc = get_level_solver(cs, spec, device).solve_with_abc(assignment, hint_overrides)
        return W, abc, None
    from .solver import solve as solve_host

    return None, None, solve_host(cs, assignment, hint_overrides=hint_overrides, logs=logs)
