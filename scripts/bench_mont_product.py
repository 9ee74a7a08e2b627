#!/usr/bin/env python3
"""The Montgomery product (csrc/mont.cuh) on one GPU: the product alone, and
every kernel of the port with the old product against the new, in turns.

    python3 scripts/bench_mont_product.py [--curves bn254,bw6-761] [--no-kernels] [--out FILE]

1. Product microbenchmark (csrc/bench_mont.cu): each lane runs chained
   products in registers at every word count (8, 9, 10, 12, 20, 24; inlined
   and called), and the Fp2 and Fp4 products, so memory traffic is
   negligible. Prints products a second and the share of the card's 16.75e12
   32-bit multiply-adds a second they reach (4N^2 + N a product, 3 products
   an Fp2 product, 9 an Fp4 one), built with the earlier C product (old,
   -DTS_MONT_CIOS_C) and the port's (new), in turns old, new, new, old. The
   two must agree word for word.
2. Every kernel instance of a curve's setup and prove (the kernel table of
   PERF.md), with real inputs: one setup and one prove of chip_smoke.py's
   2^17 multiplication chain run with the wrappers recording, per instance,
   the launch with the most input elements (its inputs copied). Each recorded
   launch is then run through the wrapper from every build in turns
   (variant, new, new, variant) and timed (CUDA events, 20 launches; 3 for
   the strip passes, 5 for the Horner); its outputs must agree word for word
   across builds. Variants: the old product (every curve) and a build with
   products above 10 words called (INLINE_MUL_WORDS = 10; the curves with a
   12-word field), which tests the 12-word threshold.
3. ptxas registers and spills of every kernel in each build.

Every line of numbers stands after the card's name and power limit. Builds
only from tpusnark_torch/csrc/ into csrc/_build/. Needs a CUDA device and
nvcc; imports neither JAX nor tpusnark.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

OLD = ("-DTS_MONT_CIOS_C",)
INLINE10 = ("-DTS_INLINE_MUL_WORDS=10",)
# the builds of part 2 beside the port's, and the curves each is run on
VARIANTS = {
    "old": (OLD, tuple(chip_smoke.CURVES)),
    "inline10": (INLINE10, ("bls12-381", "bls12-377", "bw6-761")),
}
# csrc/bench_mont.cu's cases, in its order: (field, components, called?)
CASES = [
    (f, 1, called)
    for f in ("bn254_fr", "bls12_381_fr", "bls24_315_fp", "bls12_381_fp", "bw6_633_fp", "bw6_761_fp")
    for called in (False, True)
] + [("bn254_fp", 2, False), ("bls12_381_fp", 2, False), ("bls12_381_fp", 2, True)]
CASES += [("bls24_315_fp", 4, True), ("bls24_317_fp", 4, True)]
LANES = 1 << 20


def say_numbers(card, line):
    print(card, flush=True)
    print(line, flush=True)


# ---------------------------------------------------------------- part 1
def build_bench(kernels, defines):
    """csrc/bench_mont.cu built with `defines`, bound with ctypes."""
    flags = kernels.NVCC_FLAGS + tuple(defines)
    out = kernels.CSRC / "_build" / f"bench_mont_{kernels._source_hash(flags)}"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "bench_mont.so"
    if not so.exists():
        cmd = [kernels._nvcc(), *flags, "-shared", "-o", str(so), str(kernels.CSRC / "bench_mont.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for bench_mont.cu {defines}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).ts_bench_mont
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, ctypes.c_long, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


def microbench(torch, card, kernels, results):
    import numpy as np

    from tpusnark_torch.fields import spec as specs

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        old, new = pool.map(lambda d: build_bench(kernels, d), (OLD, ()))
    print(f"[1 build] bench_mont.cu, old and new product, {time.perf_counter() - t0:.1f} s", flush=True)
    np_rng = np.random.default_rng(chip_smoke.SEED)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for case, (field, deg, called) in enumerate(CASES):
        p, words = getattr(specs, field.upper()).modulus, kernels.SPECS[field][1]
        a, b = (
            torch.cat([torch.from_numpy(chip_smoke._lazy_words(np_rng, LANES, p, words)) for _ in range(deg)]).to(dev)
            for _ in range(2)
        )
        products = chip_smoke.PRODUCTS_PER_MUL[deg]
        imads = products * chip_smoke.mont_imads(words)
        # about 2 ms a launch at the card's rate
        reps = max(4, int(2e-3 * chip_smoke.IMAD_PER_S / (LANES * imads)))
        outs = {}

        def run(fn, out):
            rc = fn(case, a.data_ptr(), b.data_ptr(), out.data_ptr(), LANES, reps, stream)
            if rc:
                raise RuntimeError(f"bench_mont case {case} failed to launch: CUDA error {rc}")

        ms = {"old": [], "new": []}
        for label in ("old", "new", "new", "old"):
            fn = old if label == "old" else new
            out = outs.setdefault(label, torch.empty_like(a))
            ms[label].append(chip_smoke._time_cuda(torch, lambda: run(fn, out), 5))
        if not torch.equal(outs["old"], outs["new"]):
            chip_smoke.fail(f"bench_mont case {case} ({field}): the old and new products disagree")
        row = dict(field=field, words=words, components=deg, called=called, reps=reps, lanes=LANES)
        for label in ("old", "new"):
            t = sum(ms[label]) / 2
            rate = LANES * reps / (t * 1e-3)
            row[label] = dict(ms=ms[label], products_per_s=rate, imad_share=rate * imads / chip_smoke.IMAD_PER_S)
        results.append(row)
        kind = {1: "Fp", 2: "Fp2", 4: "Fp4"}[deg]
        say_numbers(
            card,
            f"[1 product] {kind} {field} {words} words {'called' if called else 'inline'}: "
            f"old {row['old']['ms'][0]:.4f}/{row['old']['ms'][1]:.4f} ms {row['old']['products_per_s']:.4e}/s "
            f"({row['old']['imad_share']:.3f} of the multiply-add rate) | new {row['new']['ms'][0]:.4f}/"
            f"{row['new']['ms'][1]:.4f} ms {row['new']['products_per_s']:.4e}/s ({row['new']['imad_share']:.3f}) | "
            f"new/old time {sum(ms['new']) / sum(ms['old']):.3f}",
        )
        del a, b, outs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- part 2
def _tensors(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return [x] if hasattr(x, "data_ptr") and hasattr(x, "stride") else []


def _copy(torch, x, memo):
    """x with every tensor copied in its own layout (a stride-0 axis stays
    one, a tensor that appears twice stays one tensor)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(torch, v, memo) for v in x)
    if isinstance(x, dict):
        return {k: _copy(torch, v, memo) for k, v in x.items()}
    if not (hasattr(x, "data_ptr") and hasattr(x, "stride")):
        return x
    if id(x) not in memo:
        if 0 in x.stride():
            one = x[tuple(slice(0, 1) if s == 0 else slice(None) for s in x.stride())]
            memo[id(x)] = one.clone().expand(x.shape)
        else:
            memo[id(x)] = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)
    return memo[id(x)]


class Recorder:
    """Wraps the kernel wrappers: per launch-counter name, keeps a copy of the
    inputs of the launch with the most input elements."""

    WRAPPERS = ("field_binary", "field_unary", "ntt_stages", "curve_op")
    MSM_METHODS = ("strip_mixed", "strip", "scan_step", "horner")

    def __init__(self, torch, kernels):
        self.torch, self.kernels, self.calls, self.saved = torch, kernels, {}, []
        self.last = None

    def __enter__(self):
        k = self.kernels
        launch = k._launch

        def note(name, *args):
            self.last = name
            return launch(name, *args)

        self.saved.append((k, "_launch", launch))
        k._launch = note
        for w in self.WRAPPERS:
            self._wrap(k, w)
        for m in self.MSM_METHODS:
            self._wrap(k.MsmKernels, m)
        return self

    def _wrap(self, owner, attr):
        orig = getattr(owner, attr)
        self.saved.append((owner, attr, orig))

        def wrapped(*args, **kwargs):
            size = sum(t.numel() for t in _tensors((args, kwargs)))
            copy = _copy(self.torch, (args, kwargs), {})
            self.last = None
            out = orig(*args, **kwargs)
            name = self.last
            if name is not None and size > self.calls.get(name, (0,))[0]:
                self.calls[name] = (size, orig, copy)
            return out

        setattr(owner, attr, wrapped)

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)


def kernel_rows(torch, card, kernels, curve, libs, variants, results):
    """Record one setup and one prove of `curve`, then run each recorded
    launch under every build in turns."""
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.config import get_curve

    dev = torch.device("cuda")
    cs, assign = chip_smoke.mul_chain(chip_smoke.LOG2_CONSTRAINTS, get_curve(curve).host.R)
    rng = random.Random(chip_smoke.SEED)
    kernels.use_library(libs["new"])
    with Recorder(torch, kernels) as rec:
        pk, _ = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve)
        prove(cs, pk, assign, rng=lambda: rng.randrange(cs.modulus), device=dev)
    del pk
    calls = rec.calls
    order = [k for k in kernels.instances(curve) if k in calls]
    reps = {"strip": 3, "horner": 5}
    for name in order:
        _, fn, (args, kw) = calls[name]
        outs = {}
        for label in ("new",) + variants:  # outputs from fresh copies of the inputs
            kernels.use_library(libs[label])
            a, k = _copy(torch, (args, kw), {})
            outs[label] = [t.clone() for t in _tensors(fn(*a, **k))]
        for label in variants:
            if any(not torch.equal(x, y) for x, y in zip(outs[label], outs["new"])):
                chip_smoke.fail(f"{curve} {name}: the {label} build's outputs differ from the new build's")
        r = next((v for key, v in reps.items() if name.split("[")[0].endswith(key)), 20)
        row = dict(curve=curve, name=name, inputs=int(calls[name][0]), reps=r)
        for variant in variants:
            ms = {variant: [], "new": []}
            for label in (variant, "new", "new", variant):
                kernels.use_library(libs[label])
                a, k = _copy(torch, (args, kw), {})
                ms[label].append(chip_smoke._time_cuda(torch, lambda: fn(*a, **k), r))
            row[variant] = ms
            say_numbers(
                card,
                f"[2 kernel] {name:28s} {variant} {ms[variant][0]:.4f}/{ms[variant][1]:.4f} ms | new "
                f"{ms['new'][0]:.4f}/{ms['new'][1]:.4f} ms | new/{variant} {sum(ms['new']) / sum(ms[variant]):.3f}",
            )
        results.append(row)
    kernels.use_library(libs["new"])
    del calls, rec
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--curves", default=",".join(chip_smoke.CURVES))
    ap.add_argument("--no-kernels", action="store_true", help="part 1 only")
    ap.add_argument("--out", help="write every number as JSON to this file")
    args = ap.parse_args()
    torch, card = chip_smoke.phase_card()
    from tpusnark_torch import kernels

    report = {"card": card, "torch": torch.__version__, "products": [], "kernels": [], "ptxas": {}}
    microbench(torch, card, kernels, report["products"])
    if not args.no_kernels:
        t0 = time.perf_counter()
        builds = {"new": ()} | {k: v[0] for k, v in VARIANTS.items()}
        with ThreadPoolExecutor(len(builds)) as pool:
            loaded = dict(zip(builds, pool.map(kernels.build_variant, builds.values())))
        print(f"[2 build] the library, {len(builds)} builds, {time.perf_counter() - t0:.1f} s", flush=True)
        libs = {k: lib for k, (lib, _) in loaded.items()}
        kernels.BUILD_INFO.update(loaded["new"][1])
        for label, (_, info) in loaded.items():
            rows = chip_smoke.ptxas_summary(info["ptxas"])
            report["ptxas"][label] = rows
            spills = [r for r in rows if r[2] or r[3]]
            say_numbers(
                card,
                f"[3 ptxas] {label}: {len(rows)} kernels, registers max {max(r[1] or 0 for r in rows)}, "
                f"{len(spills)} spill, spill stores {sum(r[2] for r in rows)} bytes in all",
            )
        for curve in args.curves.split(","):
            variants = tuple(v for v, (_, curves) in VARIANTS.items() if curve in curves)
            kernel_rows(torch, card, kernels, curve, libs, variants, report["kernels"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh)
    print(card, flush=True)


if __name__ == "__main__":
    main()
