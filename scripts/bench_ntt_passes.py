#!/usr/bin/env python3
"""The block size of the NTT's pass kernel (csrc/ntt.cu, k_ntt_stages),
measured on one GPU.

    python3 scripts/bench_ntt_passes.py [--fields bn254_fr,bw6_761_fr] [--log2n 17,20,22] [--reps 20]

Builds ntt.cu three times, with 24 (the port's), 48 and 96 KB of shared
memory a block (TS_NTT_STAGE_BYTES: 512, 1024 and 2048 elements at 8 to 12
words), one nvcc each, in parallel. Per field and size it
runs one forward transform's passes (bit-reversed input, random lazy words
and a random twiddle table: the kernel's work does not depend on the values)
through each build, with the plan each block size allows (a pass of at most
log2(elements) - 1 stages), in turns (24, 48, 96, 96, 48, 24 KB), and
prints the time of each run beside the transform's bound. The builds must
agree word for word. Every line of numbers stands after the card's name and
power limit. Needs a CUDA device and nvcc; imports neither JAX nor tpusnark.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

KB = (24, 48, 96)


def build(kernels, kb):
    """ntt.cu built with `kb` KB of shared memory a block, bound with ctypes."""
    out = kernels.CSRC / "_build" / f"bench_ntt_{kernels._source_hash()}"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"ntt_{kb}kb.so"
    if not so.exists():
        flag = f"-DTS_NTT_STAGE_BYTES={kb * 1024}"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, flag, "-shared", "-o", str(so), str(kernels.CSRC / "ntt.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {kb} KB a block:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).ts_ntt_stages
    fn.argtypes = list(kernels._SIGNATURES["ts_ntt_stages"])
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fields", default="bn254_fr,bls12_381_fr,bw6_633_fr,bw6_761_fr")
    ap.add_argument("--log2n", default="17,20,22")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    torch, card = chip_smoke.phase_card()
    import numpy as np

    from tpusnark_torch import kernels
    from tpusnark_torch.fields import spec as specs
    from tpusnark_torch.poly.ntt import pass_plan

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KB)) as pool:
        fns = dict(zip(KB, pool.map(lambda kb: build(kernels, kb), KB)))
    print(f"[{card}] built ntt.cu at {KB} KB a block in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    np_rng = np.random.default_rng(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for name in args.fields.split(","):
        spec = getattr(specs, name.upper())
        fid, words = kernels.SPECS[name]
        for k in (int(v) for v in args.log2n.split(",")):
            n = 1 << k
            x0 = torch.from_numpy(chip_smoke._lazy_words(np_rng, n, spec.modulus, words)).to(dev)
            table = torch.from_numpy(chip_smoke._lazy_words(np_rng, n - 1, spec.modulus, words)).to(dev)
            x = torch.empty_like(x0)
            elems = {kb: kernels.ntt_block_elems(words, kb * 1024) for kb in KB}
            plans = {kb: pass_plan(k, e.bit_length() - 2) for kb, e in elems.items()}

            def run(kb):
                x.copy_(x0)
                for s0, m in plans[kb]:
                    lg = min(elems[kb] >> m, n >> m).bit_length() - 1
                    rc = fns[kb](fid, x.data_ptr(), x.data_ptr(), table.data_ptr(), n, n - 1, s0, m, lg, stream)
                    if rc:
                        raise RuntimeError(f"{kb} KB a block: CUDA error {rc}")
                return x

            outs = {kb: run(kb).clone() for kb in KB}
            torch.cuda.synchronize()
            if any(not torch.equal(outs[kb], outs[KB[0]]) for kb in KB):
                raise SystemExit(f"FAIL: the block sizes disagree on {name} 2^{k}")
            times = {kb: [] for kb in KB}
            for kb in KB + KB[::-1]:
                times[kb].append(chip_smoke._time_cuda(torch, lambda: run(kb), args.reps))
            bound = chip_smoke.ntt_bound(words, n)
            print(
                f"[{card}] {name} 2^{k}: "
                + " ".join(
                    f"{kb} KB ({elems[kb]} elements) {plans[kb]} {ts[0]:.4f}/{ts[1]:.4f} ms"
                    for kb, ts in times.items()
                )
                + f" | bound {bound[0]:.4f} ms ({bound[1]}); each run copies the input in ({8 * words * n / 3.35e9:.4f} ms at the memory rate)",
                flush=True,
            )


if __name__ == "__main__":
    main()
