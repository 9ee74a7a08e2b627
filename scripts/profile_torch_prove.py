#!/usr/bin/env python3
"""Phase times and device busy share of the port's Groth16 or PLONK prove, or
of an MPC ceremony contribution, on one GPU.

    python3 scripts/profile_torch_prove.py [--curves bw6-761,bls12-377] [--proves 4] [--circuit wide|plonk|ceremony|rollup|recursion|rangecheck|ecadd]

Per curve, on chip_smoke.py's 2^17 multiplication chain (or, with
``--circuit wide``, its wide circuit, with a BSB22 commitment over BN254):
one setup, then `--proves` proves with phase timing (the first builds the
NTT tables and the A/B/C index arrays, the others are warm), then one warm
prove under ``torch.profiler``. On the wide circuit each prove runs twice in
turns, through the default device branch and with accelerator="host" (the
host witness solver), and one of each is profiled. With ``--circuit plonk``
the prove is PLONK over BN254 on chip_smoke.py's PLONK circuit (bench.py's
mul/add chain, a 2^17 domain), its keys from an unsafe SRS made on the card
from a seeded tau. With ``--circuit ceremony`` the work is one phase-1
contribution of the Groth16 MPC ceremony over BN254 at 2^log2n powers of
tau (``mpcsetup.Phase1.contribute`` on the card, its step times), repeated
`--proves` times on one transcript, then once under the profiler. With
``--circuit rollup`` the prove is the port's rollup example over BN254 at
chip_smoke.py's size (31 transfers over 32 accounts: 1,034,160
constraints, a 2^20 domain), its setup's phase times printed, each prove
through both solver branches in turns, one of each profiled. With
``--circuit recursion`` the prove is chip_smoke.py's native 2-chain over
BW6-761 (two BLS12-377 proofs of its 2^17 chain, made and proved here first,
verified in one circuit: 92,902 constraints, a 2^17 domain; the shape rule's
host solver); with ``--circuit rangecheck`` its commit-based range check
over BN254 (1,024 values of 64 bits, a 2^15 domain); with ``--circuit
ecadd`` its batch of 32 EIP-196 ECADD calls over BN254 (emulated Fp in
64-bit limbs: 852,416 constraints in 17 levels, a 2^20 domain); each of
these two through both solver branches in turns. From the
profile it prints the device time by kernel, the
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


def profile_ceremony(torch, card, args) -> None:
    """Phase-1 contributions at 2^log2n powers of tau: step times, then one
    profiled."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import mpcsetup

    chip_smoke.phase_build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase1 = mpcsetup.init_phase1(args.log2n)
    print(f"[{card}] ceremony init_phase1({args.log2n}) {time.perf_counter() - t0:.4f} s", flush=True)
    rng = chip_smoke.ceremony_rng(chip_smoke.SEED, [])
    for i in range(args.proves):
        timings: dict = {}
        t0 = time.perf_counter()
        phase1.contribute(rng, device=dev, timings=timings)
        total = time.perf_counter() - t0
        print(
            f"[{card}] ceremony contribution {i + 1} total={total:.4f} "
            + " ".join(f"{k}={v:.4f}" for k, v in timings.items()),
            flush=True,
        )
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    wall, busy, by_kernel = profile_one(torch, lambda: phase1.contribute(rng, device=dev))
    print(
        f"[{card}] ceremony profiled contribution wall={wall:.4f} s device busy={busy:.4f} s "
        f"idle share={1 - busy / wall:.4f} device events={sum(n for n, _ in by_kernel.values())} "
        f"port kernel launches={sum(kernels.LAUNCHES.values())} "
        f"peak memory={torch.cuda.max_memory_allocated() / 1e9:.3f} GB",
        flush=True,
    )
    for name, (n, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"[{card}] ceremony   {name:60s} launches={n:6d} ms={ms:.3f}", flush=True)


def inner_proofs(dev):
    """chip_smoke's inner proofs of the 2-chain: its 2^17 chain over
    BLS12-377, set up and proved on `dev`, and a second proof of it."""
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.config import get_curve

    curve = chip_smoke.RECURSION_INNER
    cs, assign = chip_smoke.mul_chain(chip_smoke.LOG2_CONSTRAINTS, get_curve(curve).host.R)
    rng, prng = random.Random(chip_smoke.SEED), random.Random(chip_smoke.SEED + 1)
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve)
    proof = prove(cs, pk, assign, rng=lambda: prng.randrange(cs.modulus), device=dev)
    return chip_smoke.inner_proofs(dev, chip_smoke.Proved(cs, pk, vk, assign, proof, chip_smoke.SEED + 1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--curves", default="bls24-315,bls24-317,bw6-761,bw6-633,bls12-377,bls12-381,bn254")
    ap.add_argument("--proves", type=int, default=4)
    ap.add_argument("--log2n", type=int, default=chip_smoke.LOG2_CONSTRAINTS)
    ap.add_argument(
        "--circuit", choices=("chain", "wide", "plonk", "ceremony", "rollup", "recursion", "rangecheck", "ecadd"),
        default="chain",
    )
    args = ap.parse_args()
    torch, card = chip_smoke.phase_card()
    if args.circuit == "ceremony":
        return profile_ceremony(torch, card, args)
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend import plonk
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.poly import kzg

    chip_smoke.phase_build()
    dev = torch.device("cuda")
    # the solver branches each prove runs through, in turns
    both = {" device": None, " host": ProverConfig().with_accelerator("host")}
    branches = both if args.circuit in ("wide", "rollup", "rangecheck", "ecadd") else {"": None}
    if args.circuit in ("plonk", "rollup", "rangecheck", "ecadd"):
        args.curves = "bn254"  # PLONK, the rollup, BSB22 and the EVM's ECADD are BN254-only, as in tpusnark
    elif args.circuit == "recursion":
        args.curves = chip_smoke.RECURSION_OUTER
    for curve in args.curves.split(","):
        p = get_curve(curve).host.R
        t0 = time.perf_counter()
        if args.circuit == "chain":
            cs, assign = chip_smoke.mul_chain(args.log2n, p)
        elif args.circuit == "plonk":
            cs, assign = chip_smoke.plonk_chain(args.log2n, p)
        elif args.circuit == "rollup":
            from tpusnark_torch.examples import rollup
            from tpusnark_torch.frontend.builder import Builder

            b = Builder(p)
            batch, accounts = chip_smoke.ROLLUP_BATCH, chip_smoke.ROLLUP_ACCOUNTS
            rollup.define_batch(b, batch, depth=accounts.bit_length() - 1)
            cs = b.compile()
            assign = rollup.batch_assignment(rollup.make_batch(batch, accounts)[1])
        elif args.circuit == "recursion":
            vk, proofs, y = inner_proofs(dev)
            t0 = time.perf_counter()  # the compile alone
            cs = chip_smoke.recursion_circuit(vk, len(proofs))
            assign = chip_smoke.recursion_assignment(proofs, [y] * len(proofs))
        elif args.circuit == "rangecheck":
            cs, assign = chip_smoke.rangecheck_circuit(
                chip_smoke.RANGE_VALUES, chip_smoke.RANGE_BITS, p, chip_smoke.SEED + 90
            )
        elif args.circuit == "ecadd":
            cs = chip_smoke.ecadd_circuit(chip_smoke.ECADD_CALLS)
            assign, _ = chip_smoke.ecadd_inputs(chip_smoke.ECADD_CALLS, chip_smoke.SEED + 100)
        else:
            cs, assign = chip_smoke.wide_circuit(args.log2n, p, commit=curve == "bn254")
        size = f"{cs.n_gates} gates" if args.circuit == "plonk" else f"{len(cs.constraints)} constraints"
        print(f"[{card}] {curve} {args.circuit} circuit: {size}, compiled in "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
        rng = random.Random(chip_smoke.SEED)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        setup_t: dict = {}  # Groth16 setup's phases
        if args.circuit == "plonk":
            n = 1 << (cs.n_gates - 1).bit_length()
            srs = kzg.new_srs_unsafe(n + 3, tau=rng.randrange(2, p), device=dev)
            pk, _ = plonk.setup(cs, srs=srs, device=dev)
        else:
            pk, _ = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve, timings=setup_t)
        print(f"[{card}] {curve} setup {time.perf_counter() - t0:.4f} s "
              + " ".join(f"{k}={v:.4f}" for k, v in setup_t.items())
              + f" peak memory={torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
        prng = random.Random(chip_smoke.SEED + 1)

        def prove_once(timings=None, config=None):
            if args.circuit == "plonk":
                return plonk.prove(cs, pk, assign, rng=lambda: prng.randrange(1, p), timings=timings)
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
