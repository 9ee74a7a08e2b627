"""The port's spans and counters (tpusnark_torch/trace.py) on a Groth16 prove
on the CPU: a test-size circuit with two hint-bearing levels, taken
through the device solver's branch (the shape rule's thresholds lowered),
proved once with no recording open and twice inside one. The spans nest as
the module documents and carry their proof's id; the self times add up;
the counters equal what the circuit's sizes give; the span names reach
``torch.profiler`` only while a recording is open; ``timings=`` keeps its
keys.

The key is made on the host (every point a generator) and each MSM's
arithmetic returns the identity: on one CPU thread the plain MSMs take
~25 s a prove and setup ~8 s, and neither is what these tests hold. The
MSM's span and the read-back and assembly of its sums still run."""

import ast
import json
import random
from pathlib import Path

import pytest
import torch

import tpusnark_torch.constraint.solver_torch as st
import tpusnark_torch.trace as trace
from tpusnark_torch.backend.groth16 import keys as g16keys
from tpusnark_torch.backend.groth16 import prove
from tpusnark_torch.backend.groth16.setup import k_pk_wires_for
from tpusnark_torch.constraint.hints import hint_name
from tpusnark_torch.curves.config import get_curve
from tpusnark_torch.frontend.builder import Builder
from tpusnark_torch.msm import pippenger
from tpusnark_torch.msm.pippenger import tree_map

torch.set_num_threads(1)  # the suite's workers fill the cores already

CFG = get_curve("bn254")
R = CFG.host.R
PHASES = {"solve", "encode", "h", "msm", "assemble"}
PARENT = {
    "groth16.prove": None,
    "groth16.solve": "groth16.prove",
    "solver.level": "groth16.solve",
    "solver.hints": "groth16.solve",
    "solver.hints.wait": "solver.hints",
    "solver.hints.decode": "solver.hints",
    "solver.hints.run": "solver.hints",
    "solver.hints.encode": "solver.hints",
    "solver.check": "groth16.solve",
    "groth16.encode": "groth16.prove",
    "groth16.h": "groth16.prove",
    "groth16.msm": "groth16.prove",
    "groth16.msm.index": "groth16.msm",
    "pippenger.msm": "groth16.msm",
    "groth16.assemble": "groth16.prove",
    "groth16.assemble.decode": "groth16.assemble",
    "groth16.assemble.host": "groth16.assemble",
}
ASSIGN = {"x": 3, "z": 2, "y": 6}  # bits of 6, and 6 - 5 is not zero
FP_BYTES = 32  # a BN254 coordinate: 8 int32 words


def circuit():
    """Bit decompositions at two depths and an is-zero (an inverse hint)."""
    b = Builder(R)
    x, z = b.secret("x"), b.secret("z")
    b.to_binary(x, 8)
    xz = b.mul(x, z)
    bits = b.to_binary(xz, 16)
    b.assert_is_equal(b.add(b.from_binary(bits[:4]), b.is_zero(b.sub(xz, 5))), b.public("y"))
    return b.compile()


def host_key(cs):
    """A key of the circuit's shapes, every point a generator."""
    g1, g2 = CFG.host.G1.generator(), CFG.host.G2.generator()
    n = 1 << max(1, (len(cs.constraints) - 1).bit_length())
    kw = k_pk_wires_for(cs)
    return g16keys.ProvingKey(
        alpha_g1=g1, beta_g1=g1, delta_g1=g1, beta_g2=g2, delta_g2=g2,
        a=[g1] * cs.n_wires, b1=[g1] * cs.n_wires, b2=[g2] * cs.n_wires, k=[g1] * len(kw), z=[g1] * (n - 1),
        domain_n=n, k_wires=kw,
    )


def msm_identity(engine, points, scalars):
    """The MSM's core replaced: the identity, batch k, on the points' device."""
    x = tree_map(lambda a: a[:, :1].repeat(1, scalars.shape[1]), points[0])
    return engine.ops.identity_like(x)


class Raises:
    """Stands for a clock or profiler entry that the off path must not call."""

    def __init__(self, real=None):
        self.real = real

    def __getattr__(self, name):
        if name in ("perf_counter_ns",):
            raise AssertionError(f"{name} called with no recording open")
        return getattr(self.real, name)

    def __call__(self, *a, **k):
        raise AssertionError("record_function entered with no recording open")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cs = circuit()
    pk = host_key(cs)
    rng = random.Random(7)

    def go(**kw):
        return prove(cs, pk, ASSIGN, rng=lambda: rng.randrange(R), device="cpu", **kw)

    out = {"cs": cs}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(st, "MIN_TOTAL_INSTRUCTIONS", 1)
        mp.setattr(st, "MIN_MEAN_LEVEL_WIDTH", 1)
        mp.setattr(pippenger.MSM, "_msm_core", msm_identity)
        assert st.prefer_device(cs)
        with pytest.MonkeyPatch.context() as off:  # the off path: no clock, no record_function
            off.setattr(trace, "record_function", Raises())
            off.setattr(trace, "time", Raises(trace.time))
            off.setattr(st, "time", Raises(st.time))
            counts0 = dict(trace.COUNTS)
            go()  # also builds the solver, tables and constants once
            out["off_counts"] = {k: v - counts0.get(k, 0) for k, v in trace.COUNTS.items()}
        with trace.recording() as rec:
            go()
            go()
        out["rec"] = rec
        out["timings"] = {}
        go(timings=out["timings"])
        from torch.profiler import ProfilerActivity, profile

        for key, recorded in (("prof_off", False), ("prof_on", True)):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                if recorded:
                    with trace.recording():
                        go()
                else:
                    go()
            path = tmp_path_factory.mktemp("prof") / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            out[key] = {ev["name"] for ev in events if ev.get("cat") == "user_annotation"}
    return out


def test_spans_nest_as_documented_and_carry_their_proofs_id(run):
    rec = run["rec"]
    assert rec.proofs == 2
    assert {r.name for r in rec.records} == set(PARENT)
    for r in rec.records:
        assert r.start_ns <= r.end_ns
        if r.parent is None:
            assert r.name == "groth16.prove"
            continue
        up = rec.records[r.parent]
        assert up.name == PARENT[r.name] and up.proof == r.proof
        assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    roots = [r for r in rec.records if r.parent is None]
    assert [r.proof for r in roots] == [1, 2]
    assert {r.proof for r in rec.records} == {1, 2}


def test_levels_hints_and_msms_have_one_span_each(run):
    cs, totals = run["cs"], run["rec"].totals()
    levels = cs.compute_levels()
    hint_levels = sum(any(cs.instructions[i][0] == "hint" for i in lv) for lv in levels)
    solving = sum(any(cs.instructions[i][0] != "hint" and cs.instructions[i][2] is not None for i in lv)
                  for lv in levels)
    assert hint_levels == 2
    for name in ("solver.hints", "solver.hints.wait", "solver.hints.decode", "solver.hints.run", "solver.hints.encode"):
        assert totals[name].count == 2 * hint_levels
    assert totals["solver.level"].count == 2 * solving
    assert totals["pippenger.msm"].count == 2 * 5
    assert all(totals[name].count == 2 for name in PARENT if name.startswith("groth16."))


def test_self_time_plus_the_childrens_totals_is_the_duration(run):
    rec = run["rec"]
    totals = rec.totals()
    for name, parent in PARENT.items():
        kids = [k for k, up in PARENT.items() if up == name]
        t = totals[name]
        assert t.self_seconds >= 0
        assert t.self_seconds + sum(totals[k].seconds for k in kids) == pytest.approx(t.seconds, abs=1e-9)
    roots = [r for r in rec.records if r.parent is None]
    assert totals["groth16.prove"].seconds == pytest.approx(sum(r.end_ns - r.start_ns for r in roots) / 1e9)


def expected_counts(cs):
    """Per proof: one sync a hint level (its inputs decoded), the bulk
    check's flag, and 18 coordinates of the five MSM sums (four G1 points of
    3, one G2 point of 6); uploads: the inputs, each hint level's outputs
    with their wire ids, and k_wires. The MSM's core is replaced here, so
    no strip pass counts records."""
    hint_in = hint_out = hint_levels = 0
    for lv in cs.compute_levels():
        hs = [cs.instructions[i][1] for i in lv if cs.instructions[i][0] == "hint"]
        hint_levels += bool(hs)
        hint_in += sum(len(h.inputs) for h in hs)
        hint_out += sum(len(h.outputs) for h in hs)
    n_in = cs.n_public + len(cs.secret_names)
    return {
        "sync": hint_levels + 1 + 18,
        "d2h_bytes": FP_BYTES * hint_in + 1 + FP_BYTES * 18,
        "h2d_bytes": FP_BYTES * n_in + (FP_BYTES + 8) * hint_out + 8 * len(k_pk_wires_for(cs)),
        "msm_records": 0,
        "msm_dead_records": 0,
    }


def test_counters_equal_what_the_circuits_sizes_give(run):
    want = expected_counts(run["cs"])
    assert run["rec"].counters == {k: 2 * v for k, v in want.items()}
    # outside a recording they count all the same (the first prove also
    # uploads the solver's arenas and the key tables once)
    off = run["off_counts"]
    assert off["sync"] == want["sync"] and off["d2h_bytes"] == want["d2h_bytes"]
    assert off["h2d_bytes"] > want["h2d_bytes"]


def test_hint_totals_count_each_hint_function(run):
    cs = run["cs"]
    want: dict = {}
    for inst in cs.instructions:
        if inst[0] == "hint":
            want[hint_name(inst[1].fn)] = want.get(hint_name(inst[1].fn), 0) + 2
    got = run["rec"].hint_totals()
    assert {k: n for k, (n, _) in got.items()} == want
    assert all(s >= 0 for _, s in got.values())


def test_span_names_reach_the_profiler_only_inside_a_recording(run):
    assert set(PARENT) <= run["prof_on"]
    assert not set(PARENT) & run["prof_off"]


def test_no_recording_no_record(run):
    assert trace.current() is None
    assert trace.span("groth16.prove") is trace.span("solver.level")
    with trace.span("x") as s:
        assert s is trace.span("y")
    rec = run["rec"]
    n = len(rec.records)
    with trace.span("after"):
        pass
    assert len(rec.records) == n


def test_wait_and_nesting_outside_a_recording(monkeypatch):
    def sync(*_):
        raise AssertionError("synchronised with no recording open")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    trace.wait(torch.device("cuda"))
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass


def test_timings_keep_their_phase_keys(run):
    assert set(run["timings"]) == PHASES | {"solve_levels", "solve_hints"}
    assert all(v >= 0 for v in run["timings"].values())


def test_trace_module_imports_neither_jax_nor_tpusnark():
    tree = ast.parse(Path(trace.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "time", "dataclasses", "typing", "torch"}
