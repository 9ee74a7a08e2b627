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
  * a narrow level (at most DENSE_LANES term slots once padded) keeps its
    L, R and O terms as one dense grid instead: slot (s, m) holds row m's
    s-th term, its coefficient gathered once at build time, rows padded
    with a zero coefficient to a power-of-two count S. Its three sums are
    then one gather of W, one product (B1) and log2(S) lazy adds, where
    the segment sum takes some thirty operations a side: a deep circuit's
    levels are bound by the host's launches, not by the card;
  * a level inverts r only if one of its instructions has its unknown in
    L, and l only if one has it in R (tpusnark inverts both on every level
    once any level needs one; the lanes that do not use them discard them);
  * an instruction that solves no wire (a pure check) is left to the bulk
    check: tpusnark evaluates it in its level and writes nothing;
  * hints sync to the host once per hint-bearing level: their inputs are
    evaluated on the device, decoded, run in Python, re-encoded and
    scattered (the spans ``solver.hints.{wait,decode,run,encode}`` of
    ``tpusnark_torch.trace``); a level's inverse and div_unchecked hints
    share one modular inverse (Montgomery's trick, ``BATCHED``), where a
    twisted Edwards addition's two divisions cost a Python ``pow`` each;
  * satisfaction is checked in one bulk pass at the end (A_i * B_i == C_i
    for every constraint, through the port's ABCEvaluator), whose A/B/C the
    Groth16 prover takes as they are.

The chain (one instruction a level) stays on the host solver
(``solver.solve``): ``solve_any`` picks by the level shape, before anything
runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace
from ..fields.spec import FieldSpec
from ..fields.tfield import Field, compute_device, get_field
from .eval_torch import abc_evaluator
from .hints import div_unchecked_hint, hint_name, inv_hint
from .solver import UnsatisfiedConstraintError
from .system import ConstraintSystem

CODE_O, CODE_L, CODE_R = 1, 2, 3
# a level's term grid (rows x padded terms a row) is dense up to this many
# slots: below it a launch costs about the same at any width
DENSE_LANES = 1 << 18


def _terms(rows, cids, vids, device):
    """(rows, cids, vids, max_segment) of a segment sum, as int64 tensors on
    `device`; max_segment is the most terms of any row (at least 1)."""
    r = np.asarray(rows, dtype=np.int64)
    max_seg = int(np.bincount(r).max()) if r.size else 1
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device) for a in (r, cids, vids)) + (max_seg,)


def _inverses(p, xs):
    """1/x mod p for each x, 0 for x = 0 mod p: one pow for all."""
    xs = [x % p for x in xs]
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        if x:
            acc = acc * x % p
    inv, out = pow(acc, -1, p), [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i]:
            out[i] = inv * prefix[i] % p
            inv = inv * xs[i] % p
    return out


# hint function -> (its calls' input lists -> their output lists), the
# calls of one level at once; the same outputs as the function's
BATCHED = {
    inv_hint: lambda p, ins: [[v] for v in _inverses(p, [x for (x,) in ins])],
    div_unchecked_hint: lambda p, ins: [[a * v % p] for (a, _), v in zip(ins, _inverses(p, [b for _, b in ins]))],
}


class _LevelPlan:
    """One dependency level's arenas, on the solver's device: the
    instructions that solve a wire (codes, 1/k in Montgomery form, target
    wires, a dense grid or else a term triple per side) and the hints with
    theirs."""

    __slots__ = ("nI", "terms", "dense", "is_l", "is_r", "kinv", "targets", "hints", "hint_terms", "hint_dense",
                 "n_hint_inputs")


class LevelSolver:
    """Device solver bound to (ConstraintSystem, Field, device): the card
    unless the caller names the CPU. Build once, reuse."""

    def __init__(self, cs: ConstraintSystem, field: Field, device="cuda"):
        cs.finalize()
        self.cs = cs
        self.f = field
        self.device = device = compute_device(device)
        p = cs.modulus
        # one zero past the table: the coefficient of a dense grid's padding
        self.coeffs = field.encode(list(cs.coeffs) + [0], mont=True, device=device)
        self.zero_cid = len(cs.coeffs)
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
            plan.dense = self._dense([(rows[s], cids[s], vids[s]) for s in "LRO"], plan.nI)
            if plan.dense is None:
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
            plan.hint_dense = self._dense([(h_rows, h_cids, h_vids)], n_in)
            if plan.hint_dense is None:
                plan.hint_terms = _terms(h_rows, h_cids, h_vids, device)
            self.plans.append(plan)

    def _dense(self, sides, n):
        """The dense grid of len(sides) groups of n linear expressions, each
        a term triple with its rows ascending: (coefficients (words, S*M)
        Montgomery, wire ids (S*M,), S, M) with M = n*len(sides) and S the
        most terms of any row rounded up to a power of two; None where
        S*M passes DENSE_LANES (the segment sum then does it)."""
        m = n * len(sides)
        if not m:
            return None
        counts = np.zeros(m, dtype=np.int64)
        for g, (rows, _, _) in enumerate(sides):
            if rows:
                counts[g * n : (g + 1) * n] = np.bincount(np.asarray(rows, dtype=np.int64), minlength=n)
        s = 1 << (max(int(counts.max()), 1) - 1).bit_length()
        if s * m > DENSE_LANES:
            return None
        cid = np.full(s * m, self.zero_cid, dtype=np.int64)
        vid = np.zeros(s * m, dtype=np.int64)
        for g, (rows, cids, vids) in enumerate(sides):
            if not rows:
                continue
            r = np.asarray(rows, dtype=np.int64)
            pos = np.arange(r.size) - np.searchsorted(r, r)  # the term's place in its row
            slot = pos * m + g * n + r
            cid[slot] = cids
            vid[slot] = vids
        dev = self.device
        coef = self.coeffs[:, torch.from_numpy(cid).to(dev)]
        return coef, torch.from_numpy(vid).to(dev), s, m

    def _sums(self, W, dense):
        """(words, M) Montgomery values of a dense grid's M expressions: the
        grid's products, then halves added until one row is left."""
        f = self.f
        coef, vids, s, m = dense
        x = f.mul(coef, W[:, vids])
        while s > 1:
            s //= 2
            x = f.add(x[:, : s * m], x[:, s * m :])
        return x

    def _eval(self, W, n, rows, cids, vids, max_seg):
        """(words, n) Montgomery values of n linear expressions given as a
        term triple."""
        f = self.f
        if rows.shape[0] == 0:
            return f.zeros((n,), device=W.device)
        return f.segment_sum(f.mul(self.coeffs[:, cids], W[:, vids]), rows, n, max_seg)

    def _run_level(self, W, plan):
        f, n = self.f, plan.nI
        if plan.dense is not None:
            x = self._sums(W, plan.dense)
            l, r, o = x[:, :n], x[:, n : 2 * n], x[:, 2 * n :]
        else:
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
        if plan.hint_dense is not None:
            ins = self._sums(W, plan.hint_dense)
        else:
            ins = self._eval(W, plan.n_hint_inputs, *plan.hint_terms)
        with trace.span("solver.hints.wait"):
            trace.wait(W.device)
        with trace.span("solver.hints.decode"):
            vals = f.decode(ins)
        rec = trace.current()
        out_wires, out_vals = [], []
        off = 0
        batches: dict = {}
        with trace.span("solver.hints.run"):
            for h in plan.hints:
                fn = overrides.get(hint_name(h.fn), h.fn) if overrides else h.fn
                n_in = len(h.inputs)
                args = vals[off : off + n_in]
                off += n_in
                if any(fn is b for b in BATCHED):
                    batches.setdefault((fn, hint_name(h.fn)), []).append((h, args))
                    continue
                t0 = time.perf_counter_ns() if rec is not None else 0
                outs = fn(p, args)
                if rec is not None:
                    rec.add_hint(hint_name(h.fn), time.perf_counter_ns() - t0)
                self._take(h, outs, out_wires, out_vals)
            for (fn, name), calls in batches.items():
                t0 = time.perf_counter_ns() if rec is not None else 0
                outs = BATCHED[fn](p, [args for _, args in calls])
                if rec is not None:
                    rec.add_hint(name, time.perf_counter_ns() - t0, len(calls))
                for (h, _), o in zip(calls, outs):
                    self._take(h, o, out_wires, out_vals)
        with trace.span("solver.hints.encode"):
            trace.count("h2d_bytes", 8 * len(out_wires))
            idx = torch.tensor(out_wires, dtype=torch.int64, device=W.device)
            W[:, idx] = f.encode(out_vals, mont=True, device=W.device)

    def _take(self, h, outs, out_wires, out_vals):
        """A hint call's outputs, checked against its output wires."""
        if len(outs) != len(h.outputs):
            raise RuntimeError(f"hint {hint_name(h.fn)}: {len(outs)} outputs, want {len(h.outputs)}")
        p = self.cs.modulus
        out_wires.extend(h.outputs)
        out_vals.extend(int(v) % p for v in outs)

    def solve_with_abc(self, assignment: dict, hint_overrides: dict | None = None, timings: dict | None = None):
        """-> (W, (A, B, C)): W the (words, n_wires) Montgomery wire vector
        on the device, and the per-constraint evaluations of the bulk check,
        each (words, n_constraints) Montgomery (the Groth16 prover's input,
        as the reference fills a/b/c during its solve,
        gnark/constraint/bn254/solver.go:532). Raises
        UnsatisfiedConstraintError at the first unsatisfied constraint.

        hint_overrides: {hint fn or name -> replacement}, the prover's
        OverrideHint seam (same contract as solver.solve): BSB22 needs it.

        timings: optional dict; host seconds are added under
        ``solve_levels`` (the ``_run_level`` calls: the levels' launches,
        not waited for) and ``solve_hints`` (the ``_run_hints`` calls: the
        inputs' launches, wait, decode, run and encode). The clock is read
        around what runs anyway, with no synchronise of its own; without
        `timings` it is not read."""
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
        levels_s = hints_s = 0.0
        for plan in self.plans:
            if plan.nI:
                with trace.span("solver.level"):
                    t0 = time.perf_counter() if timings is not None else 0.0
                    self._run_level(W, plan)
                    if timings is not None:
                        levels_s += time.perf_counter() - t0
            if plan.hints:
                with trace.span("solver.hints"):
                    t0 = time.perf_counter() if timings is not None else 0.0
                    self._run_hints(W, plan, overrides)
                    if timings is not None:
                        hints_s += time.perf_counter() - t0
        if timings is not None:
            timings["solve_levels"] = timings.get("solve_levels", 0.0) + levels_s
            timings["solve_hints"] = timings.get("solve_hints", 0.0) + hints_s
        with trace.span("solver.check"):
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
        trace.count("sync")
        trace.count("d2h_bytes", 1)
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
    timings: dict | None = None,
):
    """Solve on `device` (the card unless the caller names the CPU) when the
    level shape favours it, else on the host; the choice is made before
    anything runs, and a failure of either raises.

    Returns (W_mont, abc, W_ints): W_mont (words, n_wires) on the device and
    abc = (A, B, C) from its bulk check, or W_ints (Python ints) from the
    host solver. force_host pins the host solver (ProverConfig
    accelerator="host"). timings: the device branch adds its split to it
    (``LevelSolver.solve_with_abc``); the host branch writes nothing."""
    device = compute_device(device)
    if not force_host and prefer_device(cs):
        W, abc = get_level_solver(cs, spec, device).solve_with_abc(assignment, hint_overrides, timings)
        return W, abc, None
    from .solver import solve as solve_host

    return None, None, solve_host(cs, assignment, hint_overrides=hint_overrides, logs=logs)
