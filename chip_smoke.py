#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnark_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ``tpusnark_torch/csrc`` (one nvcc per source,
     in parallel) and print the time and each kernel's registers and spills;
  3. check every kernel instance of both curves (BN254, BLS12-381) against
     its plain PyTorch version (run on a CPU copy of the same seeded inputs)
     at the prove's widths: exact equality mod p, with both times;
  4. MSM with c = 16 on the strip path against a host sum from the curve's
     host module, per curve: G1 at N = 1024, G2 at N = 256;
  5. Groth16 per curve (BN254, then BLS12-381) on a 2^17 - 8 constraint
     multiplication chain over the curve's r: compile, port setup (seeded),
     port prove, tpusnark's host verifier (accepts the proof, rejects a wrong
     public input; for BLS12-381 also the bellman-checked ``bls381.verify``),
     with phase times;
  6. per curve, every kernel instance of the prove path was launched by that
     prove (counts zeroed just before ``prove`` and read just after), and
     every setup-only instance by that curve's setup.
Then one JSON line with every kernel instance, the card line, and the result
line. Any failure exits non-zero before the result line. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG2_CONSTRAINTS = 17
SEED = 20261016
CURVES = ("bn254", "bls12-381")
CURVE_LANES = 1 << 15  # a strip row of the prove's MSMs

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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def kernel_table():
    """instance -> (source, replaces), per curve, and the setup-only ones."""
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
    if not os.path.isdir(os.path.join(HERE, "tpusnark_torch")) or not os.path.isdir(
        os.path.join(HERE, "tpusnark")
    ):
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


def phase_kernels(torch):
    import numpy as np

    from tpusnark.curves.config import get_curve
    from tpusnark_torch import kernels
    from tpusnark_torch.curves.tcurve import CurveOps, curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.poly.ntt import get_ntt

    np_rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    results = {}

    def record(name, field, run_kernel, run_plain, lanes):
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
        results[name] = dict(lanes=lanes, mismatches=n_bad, max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if n_bad:
            fail(f"kernel {name} disagrees with its plain version on {n_bad} lanes")

    n = 1 << LOG2_CONSTRAINTS  # compute_h's pointwise products
    for curve in CURVES:
        cfg = get_curve(curve)
        fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
        for field in (fr, fp):
            p, words, name = field.modulus, field.n, field.spec.name
            a_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
            b_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
            a, b = a_c.to(dev), b_c.to(dev)
            ops = [op for op in kernels.BASE_FIELD_OPS if f"{op}[{name}]" in kernels.LAUNCHES]
            for op in ops:
                binary = op in ("mul", "add", "sub")
                record(
                    f"{op}[{name}]",
                    field,
                    (lambda: getattr(field, op)(a, b)) if binary else (lambda: getattr(field, op)(a)),
                    (lambda: getattr(field, op)(a_c, b_c)) if binary else (lambda: getattr(field, op)(a_c)),
                    n,
                )

        # NTT butterflies over fr, at the flat widths of a 2^17 transform
        p, words, tag = fr.modulus, fr.n, fr.spec.name
        ntt_c, ntt_g = get_ntt(cfg.fr_spec, 2), get_ntt(cfg.fr_spec, 2, dev)
        n2, n4 = n // 2, n // 4
        xs_c = [torch.from_numpy(_lazy_words(np_rng, n2, p, words)) for _ in range(7)]
        xs = [x.to(dev) for x in xs_c]
        record(
            f"butterfly[{tag}]", fr, lambda: ntt_g.butterfly(*xs[:3]), lambda: ntt_c.butterfly(*xs_c[:3]), n2
        )
        xs4_c = [x[:, :n4].contiguous() for x in xs_c]
        xs4 = [x.to(dev) for x in xs4_c]
        record(
            f"butterfly4[{tag}]", fr, lambda: ntt_g.butterfly4(*xs4), lambda: ntt_c.butterfly4(*xs4_c), n4
        )

        # curve kernels on arbitrary coordinates (the formulas are polynomial
        # identities), with identity lanes, P + P lanes and infinity lanes
        nc = CURVE_LANES
        p = fp.modulus
        for g2, ops in zip((False, True), curve_ops(curve)):
            plain = CurveOps(ops.fa)
            d = 2 if g2 else 1

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
                if not g2:
                    return tuple(cs)
                return tuple((cs[2 * i], cs[2 * i + 1]) for i in range(3))

            def flat(out):
                return [c for x in out for c in ops.fa.components(x)]

            Pg = [x.to(dev) for x in P1]
            Qg = [x.to(dev) for x in Q]
            inf_g = inf_c.to(dev)
            group = "g2" if g2 else "g1"
            record(
                f"{group}_add[{curve}]",
                fp,
                lambda: flat(ops.add(pt(Pg), pt(Qg))),
                lambda: flat(plain.add(pt(P1), pt(Q))),
                nc,
            )
            aff_g = pt(Qg)[:2] + (inf_g,)
            aff_c = pt(Q)[:2] + (inf_c,)
            record(
                f"{group}_add_mixed[{curve}]",
                fp,
                lambda: flat(ops.add_mixed(pt(Pg), aff_g)),
                lambda: flat(plain.add_mixed(pt(P1), aff_c)),
                nc,
            )

    for name, r in results.items():
        say(
            f"[3 check] {name:26s} lanes={r['lanes']:6d} mismatches={r['mismatches']} "
            f"kernel={r['ms']:.4f} ms plain(cpu)={r['plain_ms']:.1f} ms"
        )
    missing = sorted(set(kernels.LAUNCHES) - set(results))
    if missing:
        fail(f"kernels not checked: {missing}")
    return results


# ---------------------------------------------------------------- phase 4
def phase_msm(torch, dev, curve, sizes=(1024, 256)):
    from tpusnark.curves.config import get_curve
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

    for label, G, ops, n, enc, dec in (
        ("G1", host.G1, g1, sizes[0], g1_to_device, g1_from_device_proj),
        ("G2", host.G2, g2, sizes[1], g2_to_device, dec2),
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
    from tpusnark.frontend.builder import Builder

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


def _verifiers(curve):
    """name -> verify(proof, vk, public inputs) -> bool, tpusnark's host
    verifiers for the curve."""
    from tpusnark_torch import _host

    out = {"verify": lambda proof, vk, pubs: _host.verify.verify(proof, vk, pubs, curve=curve)}
    if curve == "bls12-381":
        B = _host.bls381

        def bls(proof, vk, pubs):
            vkb = B.VerifyingKeyBLS(
                alpha_g1=vk.alpha_g1,
                beta_g1=vk.beta_g1,
                beta_g2=vk.beta_g2,
                gamma_g2=vk.gamma_g2,
                delta_g1=vk.delta_g1,
                delta_g2=vk.delta_g2,
                k=vk.k,
            )
            return B.verify(B.ProofBLS(ar=proof.ar, bs=proof.bs, krs=proof.krs), vkb, pubs)

        out["bls381.verify"] = bls
    return out


def phase_groth16(torch, dev, curve, log2n=LOG2_CONSTRAINTS):
    from tpusnark.curves.config import get_curve
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import prove, setup

    times = {}
    t0 = time.perf_counter()
    cs, assign = mul_chain(log2n, get_curve(curve).host.R)
    times["compile"] = time.perf_counter() - t0
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
    for name, verify in _verifiers(curve).items():
        t0 = time.perf_counter()
        ok = verify(proof, vk, [assign["y"]])
        times[name] = time.perf_counter() - t0
        if not ok:
            fail(f"{name} rejected the port's {curve} 2^{log2n} proof")
        if verify(proof, vk, wrong):
            fail(f"{name} accepted the {curve} proof with a wrong public input")
    say(
        f"[5 groth16] {curve}: {len(cs.constraints)} constraints, {cs.n_wires} wires: proof "
        f"verifies ({', '.join(_verifiers(curve))}), wrong public input rejected | "
        + " ".join(f"{k}={v:.3f}s" for k, v in times.items())
        + f" | peak device memory {peak:.3f} GB"
    )
    return setup_launches, launches


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
    torch, card = phase_card()
    from tpusnark_torch import kernels

    phase_build()
    table, setup_only = kernel_table()
    checks = phase_kernels(torch)
    dev = torch.device("cuda")
    for curve in CURVES:
        phase_msm(torch, dev, curve)
    runs = {}
    for curve in CURVES:
        runs[curve] = phase_groth16(torch, dev, curve)
        check_launches(curve, setup_only, *runs[curve])
    if "jax" in sys.modules:
        fail("JAX was imported: the port and this script must run without it")
    rows = []
    for curve, (setup_launches, launches) in runs.items():
        for name in kernels.instances(curve):
            source, replaces = table[name]
            run = "setup" if name in setup_only else "prove"
            rows.append(
                dict(
                    name=name,
                    route="cuda",
                    source=source,
                    replaces=replaces,
                    launches=(setup_launches if run == "setup" else launches)[name],
                    run=run,
                    max_abs_err=checks[name]["max_abs_err"],
                    ms=checks[name]["ms"],
                    plain_ms=checks[name]["plain_ms"],
                )
            )
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
