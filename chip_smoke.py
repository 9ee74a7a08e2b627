#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnark_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ``tpusnark_torch/csrc`` (one nvcc per source,
     in parallel) and print the time and each kernel's registers and spills;
then per curve (BW6-761, BLS12-377, BLS12-381, BN254):
  3. check every kernel instance of the curve against its plain PyTorch
     version (run on a CPU copy of the same seeded inputs) at the prove's
     widths (the curve kernels over a strip row of its MSMs, windows x
     strips lanes): exact equality mod p, with both times and the bound;
  4. MSM with c = 16 on the strip path against a host sum from the curve's
     host module: G1 at N = 1024, G2 at N = 256;
  5. Groth16 on a 2^17 - 8 constraint multiplication chain over the curve's
     r: compile, setup (seeded), prove, with phase times. The port's host
     verifier must accept the proof and reject a wrong public input (for
     BLS12-381 also the bellman-checked ``bls381.verify``). The verifiers
     run in worker processes beside the later phases, because a BW6-761
     pairing check is minutes of Python integers; all verdicts are collected
     before the result;
  6. every kernel instance of the prove path was launched by that prove
     (counts zeroed just before ``prove`` and read just after), and every
     setup-only instance by that curve's setup.
Then one JSON line with every kernel instance, the card line, and the result
line. Any failure exits non-zero before the result line. Imports neither
JAX nor the JAX package ``tpusnark``: the port stands on its own host layer.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG2_CONSTRAINTS = 17
SEED = 20261016
# BW6-761 first: its verdicts take longest and are computed beside the rest
CURVES = ("bw6-761", "bls12-377", "bls12-381", "bn254")
VERIFY_WORKERS = 4

# The card's peaks for the kernels' bounds. Device memory: 3.35 TB/s (NVIDIA's
# H100 SXM data sheet). 32-bit integer multiply-adds: the data sheet's 67
# TFLOP/s of float32 are 33.5e12 fused multiply-adds a second on 128 lanes
# per SM; an SM has 64 int32 lanes, so 16.75e12 integer multiply-adds.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12

CSRC = "tpusnark_torch/csrc"
JFIELD, JNTT, JCURVE = "tpusnark/fields/jfield.py", "tpusnark/poly/ntt.py", "tpusnark/curves/jcurve.py"
# the tpusnark function each op replaces; add, sub and neg were XLA ops
# there, the others reach the TPU kernel through fuse()
REPLACES = {
    "mul": f"{JFIELD}:468",
    "from_mont": f"{JFIELD}:510",
    "add": f"{JFIELD}:278",
    "sub": f"{JFIELD}:283",
    "neg": f"{JFIELD}:292",
    "butterfly": f"{JNTT}:177",
    "butterfly4": f"{JNTT}:200",
    "g1_add": f"{JCURVE}:466",
    "g2_add": f"{JCURVE}:466",
    "g1_add_mixed": f"{JCURVE}:470",
    "g2_add_mixed": f"{JCURVE}:470",
}
# base-field ops the prove never launches: setup's Fermat inversion and key
# decode (to_affine, to_host) are the only base-field muls, add/subs and
# from_monts outside the curve kernels. Checked in phase 3, launched by setup.
SETUP_ONLY_OPS = ("mul", "add", "sub", "from_mont")
# (the add and sub come from the Fp2 inversion of to_affine: BW6-761, whose G2
# lies over Fp, has no such instances).


_POOL = None  # the verifier processes, once started


def stop_workers() -> None:
    global _POOL
    if _POOL is not None:
        _POOL.terminate()
        _POOL.join()
        _POOL = None


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    stop_workers()
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def kernel_table():
    """instance -> (source, replaces), per curve; and the setup-only ones."""
    from tpusnark_torch import kernels

    table, setup_only = {}, set()
    for curve, (_, fp) in kernels.CURVES.items():
        for name in kernels.instances(curve):
            op, arg = name[:-1].split("[")
            if op.startswith("g"):
                src = f"{CSRC}/curve_{kernels._tag(fp)}.cu"
            else:
                src = f"{CSRC}/{'ntt' if op.startswith('butterfly') else 'field'}.cu"
            table[name] = (src, REPLACES[op])
            if arg == fp and op in SETUP_ONLY_OPS:
                setup_only.add(name)
    return table, setup_only


# ---------------------------------------------------------------- phase 1
def phase_card():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "tpusnark_torch")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        card = ""
    if not card:
        fail("nvidia-smi did not report the card")
    say(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    return torch, card


# ---------------------------------------------------------------- phase 2
def ptxas_summary(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function of an `nvcc -Xptxas -v` report."""
    rows, name, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)  # the entry, or a device function it calls
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and props == name:
            rows.append([name, None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    return rows


def phase_build():
    from tpusnark_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    say(
        f"[2 build] {time.perf_counter() - t0:.2f} s "
        f"(compiled={kernels.BUILD_INFO['compiled']}) {kernels.BUILD_INFO['path']}"
    )
    for src, sec in kernels.BUILD_INFO.get("source_seconds", {}).items():
        say(f"[2 build] {src} {sec:.2f} s")
    for name, regs, st, ld in ptxas_summary(kernels.BUILD_INFO["ptxas"]):
        say(f"[2 regs] {name} registers={regs} spill_stores={st} spill_loads={ld}")


# ---------------------------------------------------------------- phase 3
def _lazy_words(np_rng, n, p, words):
    """(words, n) uint32 words of values in [0, 2p), edge cases first."""
    import numpy as np

    top = ((2 * p).bit_length() - 1) // 32  # the highest nonzero word of 2p
    w = np_rng.integers(0, 1 << 32, size=(words, n), dtype=np.uint64)
    w[top] = np_rng.integers(0, (2 * p) >> (32 * top), size=n, dtype=np.uint64)
    w[top + 1 :] = 0
    for i, v in enumerate((0, 1, p - 1, p, p + 1, 2 * p - 1)):
        for k in range(words):
            w[k, i] = (v >> (32 * k)) & 0xFFFFFFFF
    return w.astype(np.uint32).view(np.int32)


def _time_cuda(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_host(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _compare(torch, field, got, want):
    """Mismatching lanes and max |difference| of the values mod p."""
    g, w = field.canon(got.cpu()), field.canon(want)
    bad = (g != w).any(dim=0)
    n_bad = int(bad.sum())
    err = 0.0
    if n_bad:
        idx = torch.nonzero(bad).flatten()[:64]
        gi = field.decode(g[:, idx], mont=False)
        wi = field.decode(w[:, idx], mont=False)
        err = float(max(abs(a - b) for a, b in zip(gi, wi)))
    return n_bad, err


def mont_imads(words: int) -> int:
    """32-bit integer multiply-add instructions of one Montgomery product of
    `words` words (CIOS, csrc/mont.cuh): 2 words^2 word products (a*b and
    m*p), each a low and a high half, and the low half of the `words`
    products m = t0 * inv."""
    return 4 * words * words + words


def kernel_bound(words, lanes, rows_in, rows_out, products, extra_bytes=0, active=None):
    """(bound_ms, bound_by) of one launch: the larger of its bytes over the
    card's memory rate and its integer multiply-adds over the card's rate.
    rows_in / rows_out: element rows read and written per lane, each read or
    written once; products: Montgomery products per active lane (for REDC
    alone half a product); active: the lanes that do the arithmetic in this
    run's data (add_mixed's infinity lanes only copy)."""
    byts = (rows_in + rows_out) * 4 * words * lanes + extra_bytes
    ops = products * mont_imads(words) * (lanes if active is None else active)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, curve, np_rng, n_wires):
    """Every kernel instance of one curve against its plain version, at the
    widths that a prove over `n_wires` wires gives it."""
    from tpusnark_torch import kernels
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.tcurve import CurveOps, Fp2Arith, curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import get_msm_for
    from tpusnark_torch.poly.ntt import get_ntt

    dev = torch.device("cuda")
    results = {}

    def record(name, field, run_kernel, run_plain, lanes, bound):
        """run_kernel() -> CUDA outputs; run_plain() -> the CPU outputs of
        the plain version on the same inputs."""
        got = run_kernel()
        torch.cuda.synchronize()
        want, plain_ms = _time_host(run_plain)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        n_bad, err = 0, 0.0
        for g, w in zip(got, want):
            b, e = _compare(torch, field, g, w)
            n_bad += b
            err = max(err, e)
        ms = _time_cuda(torch, run_kernel)
        results[name] = dict(
            lanes=lanes,
            mismatches=n_bad,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound[0],
            bound_by=bound[1],
        )
        if n_bad:
            fail(f"kernel {name} disagrees with its plain version on {n_bad} lanes")

    n = 1 << LOG2_CONSTRAINTS  # compute_h's pointwise products
    cfg = get_curve(curve)
    fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
    # (element rows read, rows written, Montgomery products) per lane
    field_shape = {"mul": (2, 1, 1), "add": (2, 1, 0), "sub": (2, 1, 0), "from_mont": (1, 1, 0.5), "neg": (1, 1, 0)}
    for field in (fr, fp):
        p, words, name = field.modulus, field.n, field.spec.name
        a_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
        b_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
        a, b = a_c.to(dev), b_c.to(dev)
        for op in kernels.BASE_FIELDS.get(name, kernels.FIELD_OPS):
            binary = op in ("mul", "add", "sub")
            record(
                f"{op}[{name}]",
                field,
                (lambda: getattr(field, op)(a, b)) if binary else (lambda: getattr(field, op)(a)),
                (lambda: getattr(field, op)(a_c, b_c)) if binary else (lambda: getattr(field, op)(a_c)),
                n,
                kernel_bound(words, n, *field_shape[op]),
            )

    # NTT butterflies over fr, at the flat widths of a 2^17 transform
    p, words, tag = fr.modulus, fr.n, fr.spec.name
    ntt_c, ntt_g = get_ntt(cfg.fr_spec, 2), get_ntt(cfg.fr_spec, 2, dev)
    n2, n4 = n // 2, n // 4
    xs_c = [torch.from_numpy(_lazy_words(np_rng, n2, p, words)) for _ in range(7)]
    xs = [x.to(dev) for x in xs_c]
    record(
        f"butterfly[{tag}]",
        fr,
        lambda: ntt_g.butterfly(*xs[:3]),
        lambda: ntt_c.butterfly(*xs_c[:3]),
        n2,
        kernel_bound(words, n2, 3, 2, 1),
    )
    xs4_c = [x[:, :n4].contiguous() for x in xs_c]
    xs4 = [x.to(dev) for x in xs4_c]
    record(
        f"butterfly4[{tag}]",
        fr,
        lambda: ntt_g.butterfly4(*xs4),
        lambda: ntt_c.butterfly4(*xs4_c),
        n4,
        kernel_bound(words, n4, 7, 4, 4),
    )

    # curve kernels on arbitrary coordinates (the formulas are polynomial
    # identities), with identity lanes, P + P lanes and infinity lanes, over
    # one strip row of the prove's MSMs: windows x strips lanes (16 x 2048 for
    # scalars up to 255 bits, 24 x 2048 for BW6-761's 377)
    p = fp.modulus
    for group, ops in zip(("g1", "g2"), curve_ops(curve)):
        msm = get_msm_for(group, n_wires, curve)
        nc = msm.n_windows * msm.strip_shape(n_wires)[0]
        plain = CurveOps(ops.fa)
        fp2 = isinstance(ops.fa, Fp2Arith)
        d = 2 if fp2 else 1
        # Fp products per point add: 12 (add) or 11 (add_mixed) products and
        # two by 3b (none where 3b = 9 is an add chain); an Fp2 product is 3
        b3_products = 0 if (not fp2 and ops.fa.b3 == 9) else 2
        per = 3 if fp2 else 1

        def coords(k):
            return [torch.from_numpy(_lazy_words(np_rng, nc, p, fp.n)) for _ in range(k * d)]

        P1 = coords(3)
        Q = coords(3)
        one = fp.encode([1] * 8)
        for c in range(d):  # lanes 0..7: P1 = identity (0 : 1 : 0)
            P1[c][:, :8] = 0
            P1[d + c][:, :8] = one if c == 0 else 0
            P1[2 * d + c][:, :8] = 0
        for k in range(3 * d):  # lanes 8..15: Q = P1 (doubling)
            Q[k][:, 8:16] = P1[k][:, 8:16]
        inf_c = torch.from_numpy(np_rng.random(nc) < 0.1)

        def pt(cs):
            if not fp2:
                return tuple(cs)
            return tuple((cs[2 * i], cs[2 * i + 1]) for i in range(3))

        def flat(out):
            return [c for x in out for c in ops.fa.components(x)]

        Pg = [x.to(dev) for x in P1]
        Qg = [x.to(dev) for x in Q]
        inf_g = inf_c.to(dev)
        record(
            f"{group}_add[{curve}]",
            fp,
            lambda: flat(ops.add(pt(Pg), pt(Qg))),
            lambda: flat(plain.add(pt(P1), pt(Q))),
            nc,
            kernel_bound(fp.n, nc, 6 * d, 3 * d, per * (12 + b3_products)),
        )
        aff_g = pt(Qg)[:2] + (inf_g,)
        aff_c = pt(Q)[:2] + (inf_c,)
        record(
            f"{group}_add_mixed[{curve}]",
            fp,
            lambda: flat(ops.add_mixed(pt(Pg), aff_g)),
            lambda: flat(plain.add_mixed(pt(P1), aff_c)),
            nc,
            kernel_bound(
                fp.n, nc, 5 * d, 3 * d, per * (11 + b3_products), extra_bytes=nc, active=nc - int(inf_c.sum())
            ),
        )

    for name, r in results.items():
        say(
            f"[3 check] {name:26s} lanes={r['lanes']:6d} mismatches={r['mismatches']} "
            f"kernel={r['ms']:.4f} ms bound={r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"plain(cpu)={r['plain_ms']:.1f} ms"
        )
    missing = sorted(set(kernels.instances(curve)) - set(results))
    if missing:
        fail(f"kernels not checked: {missing}")
    return results


# ---------------------------------------------------------------- phase 4
def phase_msm(torch, dev, curve, sizes=(1024, 256)):
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.encoding import (
        g1_from_device_proj,
        g1_to_device,
        g2_from_device_proj,
        g2_to_device,
    )
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import MSM

    cfg = get_curve(curve)
    host, R = cfg.host, cfg.host.R
    rng = random.Random(SEED)
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    g1, g2 = curve_ops(curve)

    def dec2(out, fp):
        return g2_from_device_proj(out, fp, host.Fp2, cfg.fp2_q)

    # a G2 over Fp (BW6-761) has plain int points: the G1 encoders
    g2_codec = (g1_to_device, g1_from_device_proj) if cfg.g2_over_fp else (g2_to_device, dec2)
    for label, G, ops, n, enc, dec in (
        ("G1", host.G1, g1, sizes[0], g1_to_device, g1_from_device_proj),
        ("G2", host.G2, g2, sizes[1], *g2_codec),
    ):
        # points i*g with known discrete logs, plus an infinity, duplicates
        # and a negation; zero scalars included
        g = G.generator()
        logs, pts, P = [], [], None
        for i in range(1, n - 3):
            P = G.add(P, g)
            logs.append(i)
            pts.append(P)
        logs += [0, logs[0], logs[0], (-logs[1]) % R]
        pts += [None, pts[0], pts[0], G.neg(pts[1])]
        scs = [rng.randrange(R) for _ in range(n - 4)] + [7, 0, 5, 1]
        scs[3] = 0
        want = G.mul(g, sum(s * d for s, d in zip(scs, logs)) % R)
        msm = MSM(ops, fr, c=16, strip_threshold=128)
        t0 = time.perf_counter()
        out = msm(enc(pts, fp, device=dev), fr.encode(scs, mont=False, device=dev))
        got = dec(out, fp)[0]
        dt = time.perf_counter() - t0
        if got != want:
            fail(f"MSM {curve} {label} N={n} c=16 strip path disagrees with the host sum")
        say(f"[4 msm] {curve} {label} N={n} c=16 strip path matches the host sum ({dt:.2f} s)")


# ---------------------------------------------------------------- phase 5
def mul_chain(log2n: int, p: int):
    """bench.py's Groth16 circuit over the field of p: x^n + x + 5 == y,
    n = 2^log2n - 8."""
    from tpusnark_torch.frontend.builder import Builder

    n = (1 << log2n) - 8
    b = Builder(p)
    x = b.secret("x")
    y = b.public("y")
    acc = x
    for _ in range(n - 1):
        acc = b.mul(acc, x)
    b.assert_is_equal(b.add(acc, x, 5), y)
    cs = b.compile()
    return cs, {"x": 3, "y": (pow(3, n, p) + 3 + 5) % p}


def verifier_names(curve):
    return ("verify", "bls381.verify") if curve == "bls12-381" else ("verify",)


def verdict(curve, name, proof, vk, pubs):
    """(accepted?, seconds) of the port's host verifier `name` for `curve`.
    Top level, so that a worker process can run it."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    if name == "verify":
        from tpusnark_torch.backend.groth16 import verify

        ok = verify(proof, vk, pubs, curve=curve)
    else:
        from tpusnark_torch.backend.groth16 import bls381 as B

        vkb = B.VerifyingKeyBLS(
            alpha_g1=vk.alpha_g1,
            beta_g1=vk.beta_g1,
            beta_g2=vk.beta_g2,
            gamma_g2=vk.gamma_g2,
            delta_g1=vk.delta_g1,
            delta_g2=vk.delta_g2,
            k=vk.k,
        )
        ok = B.verify(B.ProofBLS(ar=proof.ar, bs=proof.bs, krs=proof.krs), vkb, pubs)
    return bool(ok), time.perf_counter() - t0


def start_workers():
    """The verifier processes (spawned: the parent holds a CUDA context)."""
    global _POOL
    if _POOL is None:
        _POOL = multiprocessing.get_context("spawn").Pool(VERIFY_WORKERS)
    return _POOL


def submit_verdicts(pool, curve, proof, vk, good, wrong):
    """Ask the workers for the verdicts on the proof with the right and a
    wrong public input: [(verifier, expected verdict, pending result)]."""
    return [
        (name, expect, pool.apply_async(verdict, (curve, name, proof, vk, pubs)))
        for name in verifier_names(curve)
        for pubs, expect in ((good, True), (wrong, False))
    ]


def collect_verdicts(curve, log2n, pending):
    """Wait for the verdicts of one curve; fail unless the proof was
    accepted and the wrong public input rejected by every verifier."""
    times = []
    for name, expect, res in pending:
        ok, dt = res.get()
        times.append(f"{name}({'good' if expect else 'wrong'} input)={dt:.3f}s")
        if expect and not ok:
            fail(f"{name} rejected the port's {curve} 2^{log2n} proof")
        if ok and not expect:
            fail(f"{name} accepted the {curve} proof with a wrong public input")
    say(
        f"[5 verify] {curve}: proof accepted ({', '.join(verifier_names(curve))}), "
        f"wrong public input rejected | " + " ".join(times)
    )


def phase_groth16(torch, dev, curve, pool, cs, assign, compile_s):
    """Setup and one prove of the circuit `cs` (compiled in `compile_s`
    seconds) on `dev`; the verdicts are asked of the worker `pool` and
    returned pending."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import prove, setup

    times = {"compile": compile_s}
    rng = random.Random(SEED)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    # setup and prove return host points, so each has finished on the card
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve)
    times["setup"] = time.perf_counter() - t0
    setup_launches = dict(kernels.LAUNCHES)
    prng = random.Random(SEED + 1)
    phases: dict = {}
    kernels.reset_launches()  # the main path: one prove
    t0 = time.perf_counter()
    proof = prove(
        cs, pk, assign, rng=lambda: prng.randrange(cs.modulus), timings=phases, device=dev
    )
    times["prove"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    times.update(phases)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    wrong = [(assign["y"] + 1) % cs.modulus]
    pending = submit_verdicts(pool, curve, proof, vk, [assign["y"]], wrong)
    say(
        f"[5 groth16] {curve}: {len(cs.constraints)} constraints, {cs.n_wires} wires, domain "
        f"2^{pk.domain_n.bit_length() - 1}: proved | "
        + " ".join(f"{k}={v:.3f}s" for k, v in times.items())
        + f" | peak device memory {peak:.3f} GB"
    )
    return setup_launches, launches, pending


def check_launches(curve, setup_only, setup_launches, launches):
    """Every instance of the curve's path ran in its run: the prove path's
    in the prove, the setup-only ones in the setup and not in the prove."""
    from tpusnark_torch import kernels

    names = kernels.instances(curve)
    idle = [k for k in names if k not in setup_only and launches[k] <= 0]
    if idle:
        fail(f"{curve}: kernels of the prove path never launched by the prove: {idle}")
    stale = [k for k in names if k in setup_only and launches[k] > 0]
    if stale:
        fail(f"{curve}: kernels listed as setup-only were launched by the prove: {stale}")
    idle = [k for k in names if k in setup_only and setup_launches[k] <= 0]
    if idle:
        fail(f"{curve}: setup-only kernels never launched by the setup: {idle}")
    other = [k for k in kernels.LAUNCHES if k not in names and launches[k] + setup_launches[k] > 0]
    if other:
        fail(f"{curve}: kernels of another curve ran in its path: {other}")
    say(f"[6 launches] {curve} prove: " + " ".join(f"{k}={launches[k]}" for k in names if k not in setup_only))
    say(f"[6 launches] {curve} setup: " + " ".join(f"{k}={setup_launches[k]}" for k in names))
    say(f"[6 launches] {curve} setup only (not in the prove): " + " ".join(k for k in names if k in setup_only))


# ---------------------------------------------------------------- main
def main() -> None:
    try:
        run()
    finally:
        stop_workers()  # also when a phase raised


def run() -> None:
    t_start = time.perf_counter()
    torch, card = phase_card()
    import numpy as np

    from tpusnark_torch import kernels
    from tpusnark_torch.curves.config import get_curve

    pool = start_workers()
    phase_build()
    table, setup_only = kernel_table()
    dev = torch.device("cuda")
    np_rng = np.random.default_rng(SEED)
    checks, runs, pending = {}, {}, {}
    for curve in CURVES:
        t0 = time.perf_counter()
        cs, assign = mul_chain(LOG2_CONSTRAINTS, get_curve(curve).host.R)
        compile_s = time.perf_counter() - t0
        checks.update(phase_kernels(torch, curve, np_rng, cs.n_wires))
        phase_msm(torch, dev, curve)
        setup_launches, launches, pending[curve] = phase_groth16(torch, dev, curve, pool, cs, assign, compile_s)
        runs[curve] = (setup_launches, launches)
        check_launches(curve, setup_only, setup_launches, launches)
    missing = sorted(set(kernels.LAUNCHES) - set(checks))
    if missing:
        fail(f"kernels not checked: {missing}")
    for curve in CURVES:
        collect_verdicts(curve, LOG2_CONSTRAINTS, pending[curve])
    stop_workers()
    for mod in ("jax", "tpusnark"):
        if mod in sys.modules:
            fail(f"{mod} was imported: the port and this script must run without it")
    rows = []
    for curve, (setup_launches, launches) in runs.items():
        for name in kernels.instances(curve):
            source, replaces = table[name]
            run = "setup" if name in setup_only else "prove"
            c = checks[name]
            rows.append(
                dict(
                    name=name,
                    route="cuda",
                    source=source,
                    replaces=replaces,
                    launches=(setup_launches if run == "setup" else launches)[name],
                    run=run,
                    lanes=c["lanes"],
                    max_abs_err=c["max_abs_err"],
                    ms=c["ms"],
                    plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"],
                    bound_by=c["bound_by"],
                    library_ms=None,  # no PyTorch call computes a multi-word modular product
                )
            )
    say(f"[7 done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
