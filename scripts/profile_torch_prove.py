#!/usr/bin/env python3
"""Phase times and device busy share of the port's Groth16 prove on one GPU.

    python3 scripts/profile_torch_prove.py [--curves bw6-761,bls12-377] [--proves 4] [--circuit wide]

Per curve, on chip_smoke.py's 2^17 multiplication chain (or, with
``--circuit wide``, its wide circuit, with a BSB22 commitment over BN254):
one setup, then `--proves` proves with phase timing (the first builds the
NTT tables and the A/B/C index arrays, the others are warm), then one warm
prove under ``torch.profiler``. On the wide circuit each prove runs twice in
turns, through the default device branch and with accelerator="host" (the
host witness solver), and one of each is profiled. From the profile it prints the device time by kernel, the
device busy time (kernel intervals merged, so that overlapping kernels count
once) and the idle share of that prove's wall time. Every line of numbers
stands after the card's name and power limit. Needs a CUDA device; imports
neither JAX nor tpusnark.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def merged_busy_us(events) -> float:
    """Total length of the union of (start, duration) intervals."""
    busy, end = 0.0, -1.0
    for ts, dur in sorted(events):
        if ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy


def profile_one(torch, prove_once):
    """(wall seconds, busy seconds, {kernel name: (launches, ms)}) of one
    prove under torch.profiler, from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    kernels, spans = {}, []
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((ev["ts"], ev["dur"]))
        name = ev["name"].split("<")[0].split("(")[0][:60] if ev["cat"] == "kernel" else ev["cat"]
        m = re.search(r"ts::(k_\w+)<ts::(G[12]F)", ev["name"])
        if m:  # the curve and MSM kernels: keep the group, and which strip pass
            kind = m.group(1)
            if kind == "k_strip" and ev["name"].split("(")[0].endswith("true>"):
                kind = "k_strip_mixed"
            name = f"{kind}<{m.group(2)}>"
        n, ms = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, ms + ev["dur"] / 1e3)
    return wall, merged_busy_us(spans) / 1e6, kernels


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--curves", default="bls24-315,bls24-317,bw6-761,bw6-633,bls12-377,bls12-381,bn254")
    ap.add_argument("--proves", type=int, default=4)
    ap.add_argument("--log2n", type=int, default=chip_smoke.LOG2_CONSTRAINTS)
    ap.add_argument("--circuit", choices=("chain", "wide"), default="chain")
    args = ap.parse_args()
    torch, card = chip_smoke.phase_card()
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.config import get_curve

    chip_smoke.phase_build()
    dev = torch.device("cuda")
    # the solver branches each prove runs through, in turns
    branches = {"": None} if args.circuit == "chain" else {" device": None, " host": ProverConfig().with_accelerator("host")}
    for curve in args.curves.split(","):
        p = get_curve(curve).host.R
        t0 = time.perf_counter()
        if args.circuit == "chain":
            cs, assign = chip_smoke.mul_chain(args.log2n, p)
        else:
            cs, assign = chip_smoke.wide_circuit(args.log2n, p, commit=curve == "bn254")
        print(f"[{card}] {curve} {args.circuit} circuit: {len(cs.constraints)} constraints, compiled in "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
        rng = random.Random(chip_smoke.SEED)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pk, _ = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve)
        print(f"[{card}] {curve} setup {time.perf_counter() - t0:.4f} s", flush=True)
        prng = random.Random(chip_smoke.SEED + 1)

        def prove_once(timings=None, config=None):
            return prove(
                cs, pk, assign, rng=lambda: prng.randrange(cs.modulus), config=config, timings=timings, device=dev
            )

        for i in range(args.proves):
            for label, config in branches.items():
                phases: dict = {}
                t0 = time.perf_counter()
                prove_once(phases, config)
                total = time.perf_counter() - t0
                print(
                    f"[{card}] {curve}{label} prove {i + 1} total={total:.4f} "
                    + " ".join(f"{k}={v:.4f}" for k, v in phases.items()),
                    flush=True,
                )
        for label, config in branches.items():
            kernels.reset_launches()
            wall, busy, by_kernel = profile_one(torch, lambda: prove_once(None, config))
            launched = sum(kernels.LAUNCHES.values())
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(
                f"[{card}] {curve}{label} profiled prove wall={wall:.4f} s device busy={busy:.4f} s "
                f"idle share={1 - busy / wall:.4f} device events={sum(n for n, _ in by_kernel.values())} "
                f"port kernel launches={launched} peak memory={peak:.3f} GB",
                flush=True,
            )
            for name, (n, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:14]:
                print(f"[{card}] {curve}{label}   {name:60s} launches={n:6d} ms={ms:.3f}", flush=True)
        del pk
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
