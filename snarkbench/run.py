#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tpusnark_torch`` on the card of this
machine and print its result as the last line of standard output.

    python3 snarkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration and a traffic
mix in ``BENCHMARK.json``; ``--trace 1`` reports the per-layer metrics in
place of the end-to-end ones. ``--fault <name>`` plants one of
``faults.py``'s faults under the timed path (the control and its tests).
Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 3 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# this folder's module names (trace, traffic, ...) must not shadow the
# standard library's: import the benchmark as the package it is
sys.path[0] = str(ROOT)
CACHE = ROOT / ".snarkbench_cache"


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    # one process on a fixed half of the cores it may use, with as many
    # threads: the prove is host-bound, and a process that the scheduler
    # moves between cores spread by 20-30 % from run to run on the card's
    # shared 8-core host, where runs held to four cores agreed within 2 %
    cores = sorted(os.sched_getaffinity(0))
    cores = cores[: max(1, len(cores) // 2)]
    os.sched_setaffinity(0, cores)
    os.environ["OMP_NUM_THREADS"] = str(len(cores))
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own nvcc build sits in tpusnark_torch/csrc/_build/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from snarkbench.faults import Fault
    from snarkbench.harness import forbidden_modules, run_cell

    fault = Fault(args.fault) if args.fault else None
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", fault, T_START)
    # read after the window, so that its subprocess is no part of set-up
    print(f"[snarkbench] card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["check"].items():
        print(f"check {name}={c['value']} limit={c['limit']} (of {c['of']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
