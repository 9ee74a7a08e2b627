"""The harness on the CPU: names resolved to files, runs of the test-size
configuration (``tests/data``) through the whole harness with the port's
plain versions, every fault planted under the timed path caught, and a
configuration, a mix and a metric added as new files picked up with no
existing file edited. The cells themselves run on the card (``card``)."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from snarkbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CELLS = ("ecadd64-bn254.serial", "sha256-32B-bn254.serial")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_root(dst: Path) -> Path:
    shutil.copytree(ROOT / "snarkbench", dst / "snarkbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "data" / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _copy_root(tmp_path_factory.mktemp("tiny"))


def _run(root, trace=False, fault=None, workload="chain-tiny.serial", seconds=0.01):
    from snarkbench.faults import Fault

    return harness.run_cell(workload, 2**31 + 12345, seconds, trace, "cpu", Fault(fault) if fault else None, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_names_resolve_to_files(cell):
    spec = harness.Spec(cell)
    assert spec.config["name"] == spec.cell["config"]
    assert callable(spec.circuit.define) and callable(spec.circuit.inputs)
    assert callable(spec.system.prove) and spec.traffic["loop"] == "closed"
    names = {m["name"] for m in spec.end_to_end + spec.per_layer}
    assert "setup_s" in names and set(spec.readers) == names
    assert all(callable(r.read) for r in spec.readers.values())


@pytest.mark.parametrize("base", ["prove_s", "prove_p90_s", "solve_s", "launches_per_proof", "device_idle"])
def test_a_device_timed_metric_reads_as_its_base_does(base):
    metrics = ROOT / "snarkbench" / "metrics"
    run = {
        "window": {"seconds": 3.0, "latencies": [0.9, 1.0, 1.1], "launches": 30, "phases": {"solve": 2.4}},
        "trace": {"window_s": 2.0, "busy_s": 0.2},
    }
    variant = harness.load_file(metrics / f"{base}.device_timed.py", "metric").read(run)
    assert variant is not None and variant == harness.load_file(metrics / f"{base}.py", "metric").read(run)


def test_benchmark_file_keeps_to_the_contract_limits():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_run_through_the_harness_is_correct(tiny_root):
    res = _run(tiny_root)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    # one proof in the window: no 90th percentile to read
    assert set(res["metrics"]) == {"setup_s", "prove_s"}
    assert list(res)[-1] == "check" and res["check"]["rejected"] == {"value": 0, "limit": 0, "of": 1}
    assert res["check"]["r1cs_differs"]["value"] == 0 and res["check"]["repeated"]["value"] == 0
    assert res["device"]["platform"] == "cpu"


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root):
    res = _run(tiny_root, trace=True)
    assert res["correct"]
    assert {"compile_s", "solve_s", "launches_per_proof"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0


def test_window_busy_merges_the_device_intervals_of_the_run(monkeypatch):
    from snarkbench import trace

    events = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "ts": 0, "dur": 100},
    ]
    monkeypatch.setattr(trace, "_events", lambda prof: events)
    out, busy, n = trace.window_busy(lambda: None, False, lambda: "done")
    assert out == "done" and busy == pytest.approx(20e-6) and n == 3


def test_a_device_trace_metric_profiles_the_whole_window(tmp_path, monkeypatch):
    from snarkbench import trace

    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append(
        {"name": "prove_device_s", "unit": "s", "better": "lower", "bound": 0.01, "source": "device_trace"}
    )
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "snarkbench" / "metrics" / "prove_device_s.py", root / "snarkbench" / "metrics")
    profiled = []

    def window_busy(sync, cuda, run):
        profiled.append(cuda)
        return run(), 0.25, 7

    monkeypatch.setattr(trace, "window_busy", window_busy)
    res = _run(root)
    assert res["correct"] and profiled == [False]
    assert res["metrics"]["prove_device_s"]["value"] == pytest.approx(0.25 / res["attempted"])
    # without a card the real profile of the window reads no device time: no number
    monkeypatch.undo()
    res = _run(root)
    assert res["correct"] and "prove_device_s" not in res["metrics"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "truncate", "weakened"])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(tiny_root, fault):
    res = _run(tiny_root, fault=fault)
    assert not res["correct"] and res["failed"] >= 1
    # a weakened compile still proves the public statement: only the digest sees it
    caught = "r1cs_differs" if fault == "weakened" else "rejected"
    assert res["check"][caught]["value"] >= 1


def test_a_repeated_proof_makes_the_run_incorrect(tiny_root, monkeypatch):
    from tpusnark_torch.backend import groth16

    first = []

    def prove(*args, **kwargs):
        first[:] = first or [real(*args, **kwargs)]
        return first[0]

    real = groth16.prove
    monkeypatch.setattr(groth16, "prove", prove)
    res = _run(tiny_root, seconds=0.05)
    assert not res["correct"] and res["check"]["repeated"]["value"] >= 1


@pytest.mark.parametrize("params", [{"loop": "open"}, {"loop": "closed", "outstanding": 4}, {}])
def test_the_generator_refuses_a_mix_it_cannot_serve(params):
    from snarkbench.traffic import Traffic

    with pytest.raises(ValueError):
        Traffic(params)


def test_the_closed_loop_hands_over_each_input_once():
    from snarkbench.traffic import Traffic

    ticks = iter(range(100))
    records, window = Traffic({"loop": "closed"}).run(lambda x: -x, iter(range(100)), 5, clock=lambda: next(ticks))
    assert [x for x, _, _ in records] == list(range(len(records)))
    assert all(out == -x and lat == 1 for x, lat, out in records) and window >= 5


def _digests(root: Path) -> dict:
    return {
        p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def test_added_config_mix_and_metric_are_picked_up_without_editing_a_file(tmp_path):
    root = _copy_root(tmp_path)
    before = _digests(root)
    base = root / "snarkbench"
    data = base / "tests" / "data" / "configs"
    for ext in ("json", "py"):
        text = (data / f"chain-tiny.{ext}").read_text().replace('"chain-tiny"', '"chain-tiny-added"')
        (base / "configs" / f"chain-tiny-added.{ext}").write_text(text)
    (base / "traffic" / "serial-added.json").write_text(json.dumps({"loop": "closed", "why": "test"}))
    (base / "metrics" / "proofs_done_added.py").write_text(
        '"""proofs_done_added: proofs completed in the window."""\n\n\n'
        "def read(run):\n    return float(len(run['window']['latencies']))\n"
    )
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(
        dict(bench["configs"][0], name="chain-tiny-added", file="snarkbench/configs/chain-tiny-added.json")
    )
    bench["workloads"].append(
        {"name": "chain-tiny-added.serial-added", "config": "chain-tiny-added", "traffic": "serial-added", "chips": 1,
         "why": "test"}
    )
    bench["end_to_end"].append(
        {"name": "proofs_done_added", "unit": "proofs", "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": ["chain-tiny-added.serial-added"]}
    )
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(root, workload="chain-tiny-added.serial-added")
    assert res["correct"] and res["metrics"]["proofs_done_added"]["value"] >= 1
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before and k != Path("BENCHMARK.json")} == {
        k: v for k, v in before.items() if k != Path("BENCHMARK.json")
    }


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct_and_its_control_is_not(card, cell):
    def run(*extra):
        out = subprocess.run(
            [sys.executable, "snarkbench/run.py", "--workload", cell, "--seed", str(2**31 + 99), "--seconds", "5",
             "--trace", "0", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
        )
        assert out.returncode == 0, out.stderr[-4000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    assert run()["correct"]
    control = run("--fault", "truncate")
    assert not control["correct"] and control["check"]["rejected"]["value"] >= 1
