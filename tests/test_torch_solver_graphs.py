"""The device solver's CUDA graphs (tpusnark_torch/constraint/solver_torch.py):
on the card each segment of levels between two hint syncs is captured as
one graph at the solver's first solve and replayed after. On circuits with
hints, dense grids and segment sums (``DENSE_LANES`` at 0): the capture
solve, a replay solve and a solve of a new assignment each equal the host
solver wire for wire; a capture solve and a replay solve add the same
kernel launches; the graph counters; an op that waits for the card fails
the capture.

Every test needs an NVIDIA card and skips without one. This file imports
neither JAX nor tpusnark, so that it runs where the card is:

    python -m pytest tests/test_torch_solver_graphs.py --noconftest -o addopts= -p no:cacheprovider -q

(``--noconftest``: the suite's conftest imports JAX.) The segments
themselves, run eagerly on the CPU: tests/test_torch_solver.py."""

import pytest
import torch

import chip_smoke
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.constraint.solver_torch as st
from tpusnark_torch import kernels, trace
from tpusnark_torch.fields import spec as tspec
from tpusnark_torch.frontend.builder import Builder
from tpusnark_torch.hashes.mimc import MiMCGadget, mimc_hash

pytestmark = pytest.mark.cuda

P = tspec.BN254_FR.modulus
GRAPH_COUNTS = ("graph_captures", "graph_replays", "graph_levels")


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the solver captures CUDA graphs only there")


# ---- circuits and two assignments each, from the port's builder -------------
def hints_and_bits():
    b = Builder(P)
    x = b.secret("x")
    bits = b.to_binary(x, 16)
    b.assert_is_equal(b.from_binary(bits[:8]), b.public("y"))
    return b.compile(), [{"x": 0xABCD, "y": 0xCD}, {"x": 0x1234, "y": 0x34}]


def division_and_inverse():
    b = Builder(P)
    x, z = b.secret("x"), b.secret("z")
    b.assert_is_equal(b.add(b.div(x, z), b.inverse(b.add(x, 1))), b.public("y"))
    return b.compile(), [
        {"x": x, "z": z, "y": (x * pow(z, -1, P) + pow(x + 1, -1, P)) % P} for x, z in ((10, 7), (3, 1 << 70))
    ]


def mimc():
    """110 sequential rounds of four parallel MiMC instances."""
    b = Builder(P)
    digs = []
    for i in range(4):
        g = MiMCGadget(b)
        g.write(b.secret(f"x{i}"))
        digs.append(g.sum())
    b.assert_is_equal(b.add(digs[0], digs[1], *digs[2:]), b.public("y"))
    return b.compile(), [
        dict({f"x{i}": v + i for i in range(4)}, y=sum(mimc_hash([v + i]) for i in range(4)) % P) for v in (100, 7)
    ]


def wide(monkeypatch):
    """chip_smoke.py's wide circuit at 64 chains: a division, an inverse, a
    to_binary hint and a BSB22 commitment (its placeholder hint); its
    second assignment is the same circuit's under another seed."""
    cs, first = chip_smoke.wide_circuit(9, P, chains=64, commit=True, builder=Builder)
    monkeypatch.setattr(chip_smoke, "SEED", chip_smoke.SEED + 1)
    _, second = chip_smoke.wide_circuit(9, P, chains=64, commit=True, builder=Builder)
    return cs, [first, second]


CIRCUITS = {"hints_and_bits": hints_and_bits, "division_and_inverse": division_and_inverse, "mimc": mimc}


def build(name, grid, monkeypatch):
    """(cs, assignments, a fresh solver on the card), its narrow levels on
    dense grids or, with DENSE_LANES at 0, on segment sums."""
    cs, assigns = wide(monkeypatch) if name == "wide" else CIRCUITS[name]()
    if grid == "segment_sums":
        monkeypatch.setattr(st, "DENSE_LANES", 0)
    s = st.LevelSolver(cs, st.get_field(tspec.BN254_FR), "cuda")
    dense = [p.dense is not None for p in s.plans if p.nI]
    assert all(dense) if grid == "dense" else not any(dense)
    st.abc_evaluator(cs, s.f, s.device)  # the bulk check's tables, made before the counts
    return cs, assigns, s


def added(before, now, keys):
    return {k: now[k] - before.get(k, 0) for k in keys if now[k] != before.get(k, 0)}


NAMES = sorted(CIRCUITS) + ["wide"]
GRIDS = ("dense", "segment_sums")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_capture_replay_and_a_new_assignment_equal_the_host_solver(name, grid, monkeypatch):
    cs, (a1, a2), s = build(name, grid, monkeypatch)
    f = s.f
    first = s.solve(a1)
    kept = first.clone()
    for a, W in ((a1, first), (a1, s.solve(a1)), (a2, s.solve(a2))):
        assert f.decode(W) == tsolver.solve(cs, a)
    assert torch.equal(first, kept)  # a solve hands out a copy


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_a_replay_launches_what_its_capture_launched_and_counts_its_graphs(name, grid, monkeypatch):
    _, (a1, a2), s = build(name, grid, monkeypatch)
    n, levels = len(s.segments), sum(seg.n_levels for seg in s.segments)
    runs = []
    for a in (a1, a1, a2):
        launches, counts = dict(kernels.LAUNCHES), dict(trace.COUNTS)
        s.solve(a)
        torch.cuda.synchronize()
        runs.append((added(launches, kernels.LAUNCHES, kernels.LAUNCHES), added(counts, trace.COUNTS, GRAPH_COUNTS)))
    (l1, c1), (l2, c2), (l3, c3) = runs
    assert l1 and l1 == l2 == l3
    assert c1 == {"graph_captures": n, "graph_replays": n, **({"graph_levels": levels} if levels else {})}
    assert c2 == c3 == {k: v for k, v in c1.items() if k != "graph_captures"}


def test_a_sync_inside_a_segment_fails_the_capture(monkeypatch):
    """No eager fallback: a level that reads the card back raises."""
    _, (a1, _), s = build("mimc", "dense", monkeypatch)
    run_level = st.LevelSolver._run_level
    monkeypatch.setattr(st.LevelSolver, "_run_level", lambda self, W, plan: run_level(self, W, plan) or W[0, 0].item())
    with pytest.raises(RuntimeError):
        s.solve(a1)
