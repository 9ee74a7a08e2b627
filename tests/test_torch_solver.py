"""The port's device witness solver (tpusnark_torch/constraint/solver_torch.py,
plain versions on the CPU) against tpusnark's: its device solver
(``solve_jax_ints``, JAX on the CPU) on the cheap circuits of
tests/test_solver_jax.py, and both packages' host solvers on the circuits
whose JAX compile takes half a minute on a CPU (division and inverse, a wide
level, MiMC, the wide circuit of chip_smoke.py at 64 chains); those against
``solve_jax`` are ``slow``. Compared as decoded ints (the port's Montgomery R
differs from tpusnark's for BLS12-381 fr, 2^288 against 2^272); unsatisfied
circuits by error type and constraint index. Also: the host/device shape
rule against tpusnark's, no inversion on a level without an L/R unknown,
one solver per constraint system, the branch solve_any takes, the
accelerator option, the narrow levels' dense term grids (their layout,
and their solve against the segment sums'), a level's inverse and
division hints run as one batch, the segments between two hint syncs
(the card's CUDA graphs, run eagerly here), and two solves in a row on
one solver. The graphs themselves: tests/test_torch_solver_graphs.py. The card as the default device: tests/
test_torch_groth16.py:test_layer_entry_points_run_on_the_card_unless_the_caller_names_the_cpu."""

import gc
import random

import pytest
import torch

import chip_smoke
import tpusnark.constraint.solver as jsolver
import tpusnark.constraint.solver_jax as jsolver_jax
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.constraint.solver_torch as st
from tpusnark.fields.spec import BLS12_381_FR, BN254_FR
from tpusnark.frontend.builder import Builder
from tpusnark.hashes.mimc import MiMCGadget, mimc_hash
from tpusnark_torch.backend.config import ProverConfig
from tpusnark_torch.fields import spec as tspec
from tpusnark_torch.fields.tfield import Field
from tpusnark_torch.frontend.builder import Builder as TBuilder

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
TSPECS = {BN254_FR.name: tspec.BN254_FR, BLS12_381_FR.name: tspec.BLS12_381_FR}


# ---- the circuits of tests/test_solver_jax.py, from either builder ----------
def mul_chain(builder, p=P):
    b = builder(p)
    x, y = b.secret("x"), b.public("y")
    acc = x
    for _ in range(10):
        acc = b.mul(acc, x)
    b.assert_is_equal(b.add(acc, x, 5), y)
    return b.compile(), [{"x": 3, "y": (pow(3, 11, p) + 3 + 5) % p}]


def hints_and_bits(builder, p=P):
    b = builder(p)
    x = b.secret("x")
    bits = b.to_binary(x, 16)
    b.assert_is_equal(b.from_binary(bits[:8]), b.public("y"))
    return b.compile(), [{"x": 0xABCD, "y": 0xCD}]


def is_zero_branches(builder, p=P):
    b = builder(p)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.is_zero(x), y)
    return b.compile(), [{"x": 0, "y": 1}, {"x": 5, "y": 0}]


def wide_level(builder, p=P):
    b = builder(p)
    xs = [b.secret(f"x{i}") for i in range(32)]
    outs = [b.mul(xs[i], xs[(i + 1) % 32]) for i in range(32)]
    b.assert_is_equal(b.add(outs[0], outs[1], *outs[2:]), b.public("y"))
    tot = sum((i + 2) * ((i + 1) % 32 + 2) for i in range(32)) % p
    return b.compile(), [dict({f"x{i}": i + 2 for i in range(32)}, y=tot)]


def division_and_inverse(builder, p=P):
    b = builder(p)
    x, z = b.secret("x"), b.secret("z")
    d = b.div(x, z)
    inv = b.inverse(b.add(x, 1))
    b.assert_is_equal(b.add(d, inv), b.public("y"))
    return b.compile(), [{"x": 10, "z": 7, "y": (10 * pow(7, -1, p) + pow(11, -1, p)) % p}]


def mimc(builder, p=P):
    """MiMC gadget (it only uses add and mul, so it runs on either
    builder): 110 sequential rounds of four parallel instances."""
    b = builder(p)
    xs = [b.secret(f"x{i}") for i in range(4)]
    digs = []
    for x in xs:
        g = MiMCGadget(b)
        g.write(x)
        digs.append(g.sum())
    b.assert_is_equal(b.add(digs[0], digs[1], *digs[2:]), b.public("y"))
    yv = sum(mimc_hash([100 + i]) for i in range(4)) % p
    return b.compile(), [dict({f"x{i}": 100 + i for i in range(4)}, y=yv)]


def wide(builder, p=P):
    """chip_smoke.py's wide circuit cut to 64 chains (~450 constraints, 7
    levels): a division, an inverse, a to_binary hint and a BSB22
    commitment (its placeholder hint, as a solver-only run leaves it)."""
    cs, assign = chip_smoke.wide_circuit(9, p, chains=64, commit=True, builder=builder)
    return cs, [assign]


class Pair:
    """The same circuit from tpusnark's builder and the port's."""

    def __init__(self, make, p=P):
        (self.jax, self.assigns), (self.port, _) = make(Builder, p), make(TBuilder, p)


JAX_CHEAP = {
    "mul_chain": (mul_chain, BN254_FR),
    "hints_and_bits": (hints_and_bits, BN254_FR),
    "is_zero_branches": (is_zero_branches, BN254_FR),
    "mul_chain_bls12_381": (mul_chain, BLS12_381_FR),
}
HOST_PRICED = {"division_and_inverse": division_and_inverse, "wide_level": wide_level, "mimc": mimc, "wide": wide}


@pytest.fixture(scope="module")
def cheap():
    """One pair per cheap circuit, kept for the module: tpusnark's device
    solver compiles once per constraint system (four compiles in this file)."""
    return {name: Pair(make, spec.modulus) for name, (make, spec) in JAX_CHEAP.items()}


@pytest.fixture(scope="module")
def priced():
    return {name: Pair(make) for name, make in HOST_PRICED.items()}


@pytest.mark.parametrize("name", sorted(JAX_CHEAP))
def test_device_solver_equals_tpusnark_device_solver(cheap, name):
    pair, spec = cheap[name], JAX_CHEAP[name][1]
    for assign in pair.assigns:
        want = jsolver_jax.solve_jax_ints(pair.jax, assign, spec)
        assert st.solve_torch_ints(pair.port, assign, TSPECS[spec.name], "cpu") == want
        assert want == jsolver.solve(pair.jax, assign)


def test_unsatisfied_constraint_is_reported_like_tpusnark_device_solver(cheap):
    """The same error type at the same (first) constraint index."""
    pair = cheap["mul_chain"]
    bad = {**pair.assigns[0], "y": 10}
    with pytest.raises(jsolver.UnsatisfiedConstraintError) as theirs:
        jsolver_jax.solve_jax_ints(pair.jax, bad, BN254_FR)
    with pytest.raises(tsolver.UnsatisfiedConstraintError) as ours:
        st.solve_torch_ints(pair.port, bad, tspec.BN254_FR, "cpu")
    assert type(ours.value).__name__ == type(theirs.value).__name__
    with pytest.raises(jsolver.UnsatisfiedConstraintError) as host:
        jsolver.solve(pair.jax, bad)
    assert ours.value.idx == theirs.value.idx == host.value.idx == len(pair.port.constraints) - 1


@pytest.mark.parametrize("name", sorted(HOST_PRICED))
def test_device_solver_equals_both_host_solvers(priced, name):
    pair = priced[name]
    for assign in pair.assigns:
        want = jsolver.solve(pair.jax, assign)
        assert tsolver.solve(pair.port, assign) == want
        assert st.solve_torch_ints(pair.port, assign, tspec.BN254_FR, "cpu") == want


@pytest.mark.slow
@pytest.mark.parametrize("name", ("division_and_inverse", "wide_level", "mimc"))
def test_device_solver_equals_tpusnark_device_solver_on_priced_circuits(priced, name):
    pair = priced[name]
    for assign in pair.assigns:
        want = jsolver_jax.solve_jax_ints(pair.jax, assign, BN254_FR)
        assert st.solve_torch_ints(pair.port, assign, tspec.BN254_FR, "cpu") == want


def above_thresholds(builder, p=P):
    """chip_smoke.py's wide circuit at 2^13 constraints, 128 chains."""
    cs, assign = chip_smoke.wide_circuit(13, p, chains=128, builder=builder)
    return cs, [assign]


def test_prefer_device_equals_tpusnark(cheap, priced):
    pairs = list(cheap.values()) + list(priced.values())
    above = Pair(above_thresholds)
    assert (st.MIN_MEAN_LEVEL_WIDTH, st.MIN_TOTAL_INSTRUCTIONS) == (
        jsolver_jax.MIN_MEAN_LEVEL_WIDTH,
        jsolver_jax.MIN_TOTAL_INSTRUCTIONS,
    )
    for pair in pairs + [above]:
        assert st.prefer_device(pair.port) == jsolver_jax.prefer_device(pair.jax)
    assert st.prefer_device(above.port) and not any(st.prefer_device(q.port) for q in pairs)


def unknown_sides(cs):
    """Per level, the sides that hold a solved wire, read off the
    constraints."""
    out = []
    for insts in cs.compute_levels():
        sides = set()
        for ii in insts:
            inst = cs.instructions[ii]
            if inst[0] == "r1c" and inst[2] is not None:
                c = cs.constraints[inst[1]]
                sides |= {s for s, e in (("L", c.L), ("R", c.R), ("O", c.O)) if any(v == inst[2] for _, v in e)}
        out.append(sides)
    return out


@pytest.mark.parametrize("name", ("wide", "division_and_inverse"))
def test_a_level_without_an_l_or_r_unknown_computes_no_inverse(priced, name, monkeypatch):
    pair = priced[name]
    calls = []
    inv = Field.inv
    monkeypatch.setattr(Field, "inv", lambda self, a: calls.append(a.shape[1]) or inv(self, a))
    want = tsolver.solve(pair.port, pair.assigns[0])
    assert st.solve_torch_ints(pair.port, pair.assigns[0], tspec.BN254_FR, "cpu") == want
    sides = unknown_sides(pair.port)
    assert len(calls) == sum(("L" in s) + ("R" in s) for s in sides)
    assert sum(1 for s in sides if s) > len(calls) >= 1  # the other levels invert nothing
    assert jsolver_jax.get_level_solver(pair.jax, BN254_FR).has_any_inv  # tpusnark inverts on every level


@pytest.mark.parametrize("name", sorted(HOST_PRICED))
def test_dense_grids_and_segment_sums_solve_alike(priced, name, monkeypatch):
    """Every level of these circuits is narrow, so each takes the dense
    grid (its hint inputs too); with DENSE_LANES at 0 each takes the
    segment sum. Both solve as the host solver."""
    pair = priced[name]
    cs, assign = pair.port, pair.assigns[0]
    want = tsolver.solve(cs, assign)
    f = st.get_field(tspec.BN254_FR)
    dense = st.LevelSolver(cs, f, "cpu")
    assert all(p.dense is not None for p in dense.plans if p.nI)
    assert all(p.hint_dense is not None for p in dense.plans if p.n_hint_inputs)
    monkeypatch.setattr(st, "DENSE_LANES", 0)
    sparse = st.LevelSolver(cs, f, "cpu")
    assert all(p.dense is None and p.hint_dense is None for p in sparse.plans)
    assert f.decode(dense.solve(assign)) == want == f.decode(sparse.solve(assign))


def test_a_dense_grid_puts_each_term_in_its_row_and_pads_with_zero(monkeypatch):
    """Two groups of three rows: group 0's row 0 has three terms, row 1
    none, row 2 one; group 1's row 0 one. Slot (s, m) holds row m's s-th
    term, m = group * 3 + row; the rows are padded to S = 4 with the zero
    coefficient, and the sums are the rows' linear combinations."""
    cs, _ = mimc(TBuilder)
    f = st.get_field(tspec.BN254_FR)
    s = st.LevelSolver(cs, f, "cpu")
    sides = [([0, 0, 0, 2], [3, 4, 5, 6], [7, 8, 9, 10]), ([0], [11], [12])]
    coef, vids, S, M = s._dense(sides, 3)
    assert (S, M) == (4, 6) and coef.shape == (f.n, 24)
    want_cid, want_vid = [s.zero_cid] * 24, [0] * 24
    for slot, cid, vid in ((0, 3, 7), (6, 4, 8), (12, 5, 9), (2, 6, 10), (3, 11, 12)):
        want_cid[slot], want_vid[slot] = cid, vid
    coeffs = list(cs.coeffs) + [0]
    assert vids.tolist() == want_vid
    assert f.decode(coef) == [coeffs[c] for c in want_cid]
    vals = [(7 * i + 1) % P for i in range(cs.n_wires)]
    W = f.encode(vals, mont=True)
    got = f.decode(s._sums(W, (coef, vids, S, M)))
    c, w = cs.coeffs, vals
    assert got == [
        (c[3] * w[7] + c[4] * w[8] + c[5] * w[9]) % P, 0, c[6] * w[10] % P, c[11] * w[12] % P, 0, 0,
    ]
    # the grid holds 4 * 6 slots: one fewer allowed, and the segment sum takes it
    monkeypatch.setattr(st, "DENSE_LANES", 23)
    assert s._dense(sides, 3) is None


@pytest.mark.parametrize("fn", sorted(st.BATCHED, key=lambda f: f.__name__), ids=lambda f: f.__name__)
def test_a_batch_of_hint_calls_gives_each_calls_outputs(fn):
    """One inverse for a level's calls (Montgomery's trick) gives what each
    call gives alone, zeros (0/0 -> 0, 1/0 -> 0) and p itself included."""
    rng = random.Random(7)
    n_in = 1 if fn is st.inv_hint else 2
    calls = [[rng.randrange(P) for _ in range(n_in)] for _ in range(40)]
    for k in (0, 5, 17, 39):
        calls[k][-1] = 0
    calls[9][-1] = P
    calls[11][0] = 0
    for ins in ([], calls[:1], calls[:2], [calls[0]] * 3, calls):
        assert st.BATCHED[fn](P, ins) == [fn(P, list(x)) for x in ins]


def test_two_circuits_get_their_own_solver():
    """Cached on the constraint system, per field and device: a system
    built after another was collected never sees the other's solver (an
    id() key could alias it)."""
    cs1, a1 = mul_chain(TBuilder)
    s1 = st.get_level_solver(cs1, tspec.BN254_FR, "cpu")
    assert st.get_level_solver(cs1, tspec.BN254_FR, "cpu") is s1 and s1.cs is cs1
    del cs1, s1
    gc.collect()
    for make in (hints_and_bits, is_zero_branches):
        cs, assigns = make(TBuilder)
        s = st.get_level_solver(cs, tspec.BN254_FR, "cpu")
        assert s.cs is cs
        assert st.solve_torch_ints(cs, assigns[0], tspec.BN254_FR, "cpu") == tsolver.solve(cs, assigns[0])


def test_solve_any_takes_the_branch_of_the_shape_rule(priced, monkeypatch):
    """The host branch returns ints, the device branch Montgomery words and
    the bulk check's A/B/C; force_host pins the host solver."""
    pair = priced["wide"]
    cs, assign = pair.port, pair.assigns[0]
    want = tsolver.solve(cs, assign)
    w, abc, ints = st.solve_any(cs, assign, tspec.BN254_FR, device="cpu")
    assert (w, abc, ints) == (None, None, want)
    monkeypatch.setattr(st, "MIN_TOTAL_INSTRUCTIONS", 1)
    monkeypatch.setattr(st, "MIN_MEAN_LEVEL_WIDTH", 1)
    w, abc, ints = st.solve_any(cs, assign, tspec.BN254_FR, device="cpu")
    f = st.get_field(tspec.BN254_FR)
    assert ints is None and f.decode(w) == want and len(abc) == 3
    A, B, C = tsolver.compute_abc(cs, want)
    assert [f.decode(x) for x in abc] == [A, B, C]
    assert st.solve_any(cs, assign, tspec.BN254_FR, force_host=True, device="cpu")[2] == want


@pytest.mark.parametrize("name", sorted(HOST_PRICED) + ["hints_and_bits"])
def test_segments_partition_the_plans_in_order(priced, name):
    """The segments hold the plans in order, each up to and including a
    hint-bearing plan, the last one those after the last hint sync (left
    out where none of them solves a wire); a segment may hold no solving
    level (a hint level right after another)."""
    cs = hints_and_bits(TBuilder)[0] if name == "hints_and_bits" else priced[name].port
    s = st.LevelSolver(cs, st.get_field(tspec.BN254_FR), "cpu")
    flat = [p for seg in s.segments for p in seg.plans]
    assert all(a is b for a, b in zip(flat, s.plans)) and len(flat) <= len(s.plans)
    assert not any(p.nI or p.hints for p in s.plans[len(flat) :])
    for seg in s.segments:
        assert seg.plans and not any(p.hints for p in seg.plans[:-1])
        assert seg.hint_plan is (seg.plans[-1] if seg.plans[-1].hints else None)
        assert seg.n_levels == sum(1 for p in seg.plans if p.nI)
    assert all(seg.hint_plan is not None for seg in s.segments[:-1])
    hint_plans = sum(1 for p in s.plans if p.hints)
    assert sum(seg.hint_plan is not None for seg in s.segments) == hint_plans
    assert hint_plans >= (name in ("hints_and_bits", "wide"))


TWO_ASSIGNMENTS = {
    "hints_and_bits": (hints_and_bits, [{"x": 0xABCD, "y": 0xCD}, {"x": 0x1234, "y": 0x34}]),
    "is_zero_branches": (is_zero_branches, [{"x": 0, "y": 1}, {"x": 5, "y": 0}]),
}


@pytest.mark.parametrize("name", sorted(TWO_ASSIGNMENTS))
def test_two_solves_in_a_row_on_one_solver_equal_the_host_solver(name):
    """One solver, two assignments: each solve equals the host solver, and
    the W the first solve handed out is the same after the second (a solve
    hands out a copy of the solver's own wire vector)."""
    make, assigns = TWO_ASSIGNMENTS[name]
    cs, _ = make(TBuilder)
    f = st.get_field(tspec.BN254_FR)
    s = st.LevelSolver(cs, f, "cpu")
    first = s.solve(assigns[0])
    kept = first.clone()
    second = s.solve(assigns[1])
    assert f.decode(first) == tsolver.solve(cs, assigns[0])
    assert f.decode(second) == tsolver.solve(cs, assigns[1]) != f.decode(first)
    assert torch.equal(first, kept) and first.data_ptr() != s.W.data_ptr()


def test_accelerator_option():
    assert ProverConfig().accelerator == "gpu"
    assert ProverConfig().with_accelerator("host").accelerator == "host"
    for name in ("tpu", "cpu"):
        with pytest.raises(ValueError, match="accelerator"):
            ProverConfig().with_accelerator(name)
