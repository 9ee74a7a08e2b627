"""snarkbench's harness: one cell (a configuration under a traffic mix),
run on one device and judged.

Everything that belongs to one configuration, mix or metric sits in files of
its own, found by the names in ``BENCHMARK.json``:

- ``configs/<name>.json`` (sizes, source, guarantees) and
  ``configs/<name>.py`` (``define``: the circuit over a builder and a gadget
  module; ``inputs``: the requests' inputs without end from a seeded rng,
  no two alike, made with the reference's arithmetic; ``PROGRAM_GADGETS``
  and ``REFERENCE_GADGETS``: the gadget modules of each side);
- ``systems/<proof_system>.py``: the program's set-up and prove entries, the
  digest of a compile, and the reference's judge of an answer;
- ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
- ``metrics/<name>.py``: ``read(run)``, the metric's value from the run's
  record, or None where the run has nothing to read.

A run: set-up (library load, compile, levels, keygen, one warm-up prove),
the window (under the profiler where an end-to-end metric of the cell is
read from the device trace), with ``--trace 1`` the window's phase times
and launches and a few proofs under the profiler, then, with the program's state freed, the
reference's check: its own compile against the digest of the program's, no
proof repeated, and a sample of the proofs drawn from the seed judged.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKED = 4  # proofs of a run that the reference checks, drawn from the seed
TRACE_PROOFS = 3  # proofs profiled in a traced run
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusnark")
# keygen's draws, the proofs' draws, the inputs and the sample come from
# the seed through these offsets
_KEYGEN, _PROVE, _INPUTS, _SAMPLE = 1, 2, 3, 4


def say(msg: str) -> None:
    print(f"[snarkbench] {msg}", flush=True)


def load_file(path: Path, kind: str):
    """The module in `path` (a name of the benchmark may hold dashes and
    dots, so modules are loaded by path)."""
    tag = "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(f"snarkbench_{kind}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spec:
    """A cell of BENCHMARK.json with its names resolved to files."""

    def __init__(self, workload: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.cell["config"]]
        cfg_path = root / entry["file"]
        self.config = json.loads(cfg_path.read_text())
        self.circuit = load_file(cfg_path.with_suffix(".py"), "config")
        base = root / HERE.name
        self.system = load_file(base / "systems" / f"{self.config['proof_system']}.py", "system")
        self.traffic = json.loads((base / "traffic" / f"{self.cell['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])
        self.readers = {
            m["name"]: load_file(base / "metrics" / f"{m['name']}.py", "metric")
            for m in self.end_to_end + self.per_layer
        }


def builder_class(side: str):
    if side == "program":
        from tpusnark_torch.frontend.builder import Builder
    else:
        from snarkbench.reference.frontend.r1cs import Builder
    return Builder


def compile_circuit(spec: Spec, side: str, modulus: int):
    """The configuration's circuit compiled by the program's builder and
    gadgets, or by the reference's frozen copies."""
    circuit = spec.circuit
    name = circuit.PROGRAM_GADGETS if side == "program" else circuit.REFERENCE_GADGETS
    gadgets = importlib.import_module(name) if name else None
    b = builder_class(side)(modulus)
    circuit.define(b, gadgets, spec.config)
    return b.compile()


class Draws:
    """A seeded draw in [1, r) (or [0, r)) that keeps what it drew."""

    def __init__(self, seed: int, modulus: int, low: int = 1):
        self._rng = random.Random(seed)
        self.modulus, self.low, self.drawn = modulus, low, []

    def __call__(self) -> int:
        x = self._rng.randrange(self.low, self.modulus)
        self.drawn.append(x)
        return x


def _seed(seed: int, stream: int) -> int:
    return seed * 8 + stream


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", fault=None,
             t_start: float | None = None, root: Path = ROOT) -> dict:
    """Run one cell and return its result (the contract's JSON object). On
    "cuda" the caller has checked for the card. `fault` (``faults.py``)
    breaks the timed path, for the tests and the control."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(workload, root)
    cfg, system = spec.config, spec.system
    parts = {}

    t0 = time.perf_counter()
    import torch

    from tpusnark_torch import kernels
    from tpusnark_torch.constraint.solver_torch import prefer_device
    from tpusnark_torch.curves.config import get_curve

    dev = torch.device(device)
    parts["imports_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kernels.build()
        parts["library_s"] = time.perf_counter() - t0
        parts["nvcc_built"] = bool(kernels.BUILD_INFO.get("compiled"))  # a checkout's first run
    modulus = get_curve(cfg["curve"]).host.R

    t0 = time.perf_counter()
    cs = compile_circuit(spec, "program", modulus)
    if fault is not None and fault.edit_cs is not None:
        fault.edit_cs(cs)
    parts["compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    branch = "device" if prefer_device(cs) else "host"
    parts["levels_s"] = time.perf_counter() - t0
    n_inst, n_levels = cs.__dict__.get("_torch_level_shape", (0, 0))
    say(
        f"{workload}: {len(cs.constraints)} constraints, {cs.n_wires} wires, {cs.n_public - 1} public, "
        f"{n_levels} levels, solver branch {branch}"
    )

    keygen_draws = Draws(_seed(seed, _KEYGEN), modulus)
    t0 = time.perf_counter()
    pk = system.keygen(cs, cfg, keygen_draws, dev)
    _sync(torch, dev)
    parts["keygen_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    requests = spec.circuit.inputs(cfg, random.Random(_seed(seed, _INPUTS)))
    warm = next(requests)
    parts["inputs_s"] = time.perf_counter() - t0

    prove_draws = Draws(_seed(seed, _PROVE), modulus, low=0)

    def serve(statement, timings=None):
        return system.prove(cs, pk, dict(statement), prove_draws, dev, timings=timings)

    if fault is not None:
        serve = fault.wrap_serve(serve)
    t0 = time.perf_counter()
    serve(warm)
    _sync(torch, dev)
    parts["warmup_s"] = time.perf_counter() - t0
    # a checkout's first run builds the kernel library with nvcc: recorded
    # apart, since a restarted prover does not pay it
    build_s = parts["library_s"] if parts.get("nvcc_built") else 0.0
    parts["setup_s"] = time.perf_counter() - t_start - build_s
    say("setup: " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in parts.items()))
    if build_s:
        say(f"build: the kernel library built by nvcc in {build_s:.4f} s, not counted in setup_s")

    from snarkbench.traffic import Traffic

    phases: dict = {}
    launches0 = sum(kernels.LAUNCHES.values())

    def window():
        return Traffic(spec.traffic).run((lambda x: serve(x, phases)) if trace else serve, requests, seconds)

    # a cell with an end-to-end metric read from the device trace profiles
    # its whole untraced window, the card's activity alone
    busy_s = None
    if not trace and any(m["source"] == "device_trace" for m in spec.end_to_end):
        from snarkbench import trace as tr

        (records, window_s), busy_s, n_ops = tr.window_busy(lambda: _sync(torch, dev), dev.type == "cuda", window)
    else:
        records, window_s = window()
    launches = sum(kernels.LAUNCHES.values()) - launches0
    raised = [r for r in records if isinstance(r[2], Exception)]
    say(f"window: {len(records)} proofs handed over, {len(raised)} raised, {window_s:.4f} s"
        + ("" if busy_s is None else f"; profiled: device busy {busy_s:.6f} s in {n_ops} operations"))
    for _, _, e in raised[:3]:
        say(f"raised: {type(e).__name__}: {e}")

    traced = None
    if trace:
        from snarkbench import trace as tr

        capture = tr.MSMCapture()

        def run_proofs(prove_span):
            for _ in range(TRACE_PROOFS):
                prove_span(serve)(next(requests))
            return TRACE_PROOFS

        traced = tr.profiled(lambda: _sync(torch, dev), dev.type == "cuda", run_proofs, system.SPANS, capture)
        from snarkbench.roofline import msm_least_seconds

        bound, binds = 0.0, set()
        for scalars, degree, fp_words, bits in capture.calls:
            s, by = msm_least_seconds(scalars, degree, fp_words, bits)
            bound += s
            binds.add(by)
        traced["msm_least_s"] = bound
        traced["msm_calls"] = len(capture.calls)
        traced["msm_bound_by"] = "+".join(sorted(binds))
        del capture, run_proofs
        say(
            f"traced: {traced['proofs']} proofs in {traced['window_s']:.4f} s, device busy {traced['busy_s']:.6f} s, "
            f"{traced['device_events']} device operations; {traced['msm_calls']} MSMs: least {bound:.6f} s "
            f"({traced['msm_bound_by']}), device {traced['msm_device_s']:.6f} s"
        )

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    latencies = [lat for _, lat, out in records if not isinstance(out, Exception)]
    answers = [(x, system.answer(out)) for x, _, out in records if not isinstance(out, Exception)]
    handed = len(records)
    t0 = time.perf_counter()
    program_digest = system.r1cs_digest(cs, "program")
    del pk, cs, serve, records, requests
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference compiles the circuit itself and holds the
    # program's compile to it; no two proofs may be alike (each draws fresh
    # randomness); a sample of the answers, drawn from the seed, is judged
    rcs = compile_circuit(spec, "reference", modulus)
    judge = system.Judge(rcs, keygen_draws.drawn)
    del rcs
    r1cs_differs = int(judge.digest != program_digest)
    if r1cs_differs:
        say(f"the program's compile differs from the reference's: digest {program_digest} against {judge.digest}")
    seen: set = set()
    repeated = 0
    for _, ans in answers:
        key = repr(ans)
        repeated += key in seen
        seen.add(key)
    sample = sorted(random.Random(_seed(seed, _SAMPLE)).sample(range(len(answers)), min(CHECKED, len(answers))))
    rejected = 0
    for k in sample:
        statement, ans = answers[k]
        why = judge.check(ans, statement)
        if why is not None:
            rejected += 1
            say(f"proof {k} rejected: {why}")
    say(f"check: {len(sample)} of {len(answers)} proofs judged by the reference, {repeated} repeated, "
        f"compile {'differs' if r1cs_differs else 'equal'}, in {time.perf_counter() - t0:.4f} s")

    run = {
        "setup": parts,
        "window": {
            "seconds": window_s,
            "latencies": latencies,
            "busy_s": busy_s,
            "phases": phases if trace else None,
            "launches": launches if trace else None,
        },
        "trace": traced,
    }
    metrics = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        value = spec.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    say(f"{len(latencies)} proofs completed in the window; latencies (s): " + " ".join(f"{x:.4f}" for x in latencies))
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": kind,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(sample) and rejected == 0 and not raised and not repeated and not r1cs_differs,
        "attempted": handed,
        # under a compile that differs, every judged proof proves another statement
        "failed": (len(sample) if r1cs_differs else rejected) + len(raised) + repeated,
        "metrics": metrics,
        "device": device_info,
    }
    if traced is not None:
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {
            "device_ops": [[n, v] for n, v in traced["device_ops"]],
            "idle_gaps": [[n, v] for n, v in traced["idle_gaps"]],
        }
    result["check"] = {
        "r1cs_differs": {"value": r1cs_differs, "limit": 0, "of": 1},
        "repeated": {"value": repeated, "limit": 0, "of": len(answers)},
        "rejected": {"value": rejected, "limit": 0, "of": len(sample)},
        "raised": {"value": len(raised), "limit": 0, "of": handed},
    }
    return result
