#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnark_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ``tpusnark_torch/csrc`` and print the time;
  3. check every kernel against its plain PyTorch version (run on a CPU copy
     of the same seeded inputs): exact equality mod p, with both times;
  4. MSM with c = 16 on the strip path against a host sum from
     ``tpusnark.curves.ref``: G1 at N = 1024, G2 at N = 256;
  5. Groth16 over BN254 on a 2^17 - 8 constraint multiplication chain:
     compile, port setup (seeded), port prove, tpusnark's host verifier
     (accepts the proof, rejects a wrong public input), with phase times;
  6. every kernel of the prove path was launched by the prove of phase 5
     (counts zeroed just before ``prove`` and read just after), and every
     setup-only kernel by the setup.
Then one JSON line with the prove's kernels, the card line, and the result line.
Any failure exits non-zero before the result line. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG2_CONSTRAINTS = 17
SEED = 20261016


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


FIELD_CU, NTT_CU, CURVE_CU = (f"tpusnark_torch/csrc/{n}.cu" for n in ("field", "ntt", "curve"))
JFIELD, JNTT, JCURVE = "tpusnark/fields/jfield.py", "tpusnark/poly/ntt.py", "tpusnark/curves/jcurve.py"
# kernel instance -> (source, the tpusnark function it replaces; add, sub and
# neg were XLA ops there, the others reach the TPU kernel through fuse())
KERNELS = {
    **{f"mul[{t}]": (FIELD_CU, f"{JFIELD}:468") for t in ("fr", "fp")},
    **{f"from_mont[{t}]": (FIELD_CU, f"{JFIELD}:510") for t in ("fr", "fp")},
    **{f"add[{t}]": (FIELD_CU, f"{JFIELD}:278") for t in ("fr", "fp")},
    **{f"sub[{t}]": (FIELD_CU, f"{JFIELD}:283") for t in ("fr", "fp")},
    **{f"neg[{t}]": (FIELD_CU, f"{JFIELD}:292") for t in ("fr", "fp")},
    "butterfly": (NTT_CU, f"{JNTT}:177"),
    "butterfly4": (NTT_CU, f"{JNTT}:200"),
    "g1_add": (CURVE_CU, f"{JCURVE}:466"),
    "g1_add_mixed": (CURVE_CU, f"{JCURVE}:470"),
    "g2_add": (CURVE_CU, f"{JCURVE}:466"),
    "g2_add_mixed": (CURVE_CU, f"{JCURVE}:470"),
}
# the kernel instances that the prove does not launch, and where they run
# instead; all are checked in phase 3. Setup's Fermat inversion and host
# decode (to_affine, to_host) are the only base-field muls, add/subs and
# from_monts outside the curve kernels; nothing negates an fr element.
NOT_IN_PROVE = {
    "mul[fp]": "setup",
    "add[fp]": "setup",
    "sub[fp]": "setup",
    "from_mont[fp]": "setup",
    "neg[fr]": "check only",
}


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
def phase_build():
    from tpusnark_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    say(
        f"[2 build] {time.perf_counter() - t0:.2f} s "
        f"(compiled={kernels.BUILD_INFO['compiled']}) {kernels.BUILD_INFO['path']}"
    )


# ---------------------------------------------------------------- phase 3
def _lazy_words(np_rng, n, p):
    """(8, n) uint32 words of values in [0, 2p), edge cases first."""
    import numpy as np

    w = np_rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    w[7] = np_rng.integers(0, (2 * p) >> 224, size=n, dtype=np.uint64)
    for i, v in enumerate((0, 1, p - 1, p, p + 1, 2 * p - 1)):
        for k in range(8):
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

    from tpusnark.fields.spec import BN254_FP, BN254_FR
    from tpusnark_torch.curves.tcurve import CurveOps, g1_ops, g2_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.poly.ntt import get_ntt

    np_rng = np.random.default_rng(SEED)
    fr, fp = get_field(BN254_FR), get_field(BN254_FP)
    dev = torch.device("cuda")
    results = {}

    def record(name, field, run_kernel, run_plain, lanes):
        """run_kernel() -> CUDA outputs; run_plain() -> CPU outputs."""
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
    for field in (fr, fp):
        p = field.modulus
        a_c = torch.from_numpy(_lazy_words(np_rng, n, p))
        b_c = torch.from_numpy(_lazy_words(np_rng, n, p))
        a, b = a_c.to(dev), b_c.to(dev)
        tag = field.spec.name.split("_")[-1]
        for op in ("mul", "add", "sub"):
            record(
                f"{op}[{tag}]",
                field,
                lambda: getattr(field, op)(a, b),
                lambda: getattr(field, op)(a_c, b_c),
                n,
            )
        for op in ("neg", "from_mont"):
            record(
                f"{op}[{tag}]", field, lambda: getattr(field, op)(a), lambda: getattr(field, op)(a_c), n
            )

    # NTT butterflies over fr, at the flat widths of a 2^17 transform
    p = fr.modulus
    ntt_c, ntt_g = get_ntt(BN254_FR, 2), get_ntt(BN254_FR, 2, dev)
    n2, n4 = n // 2, n // 4
    xs_c = [torch.from_numpy(_lazy_words(np_rng, n2, p)) for _ in range(7)]
    xs = [x.to(dev) for x in xs_c]
    record("butterfly", fr, lambda: ntt_g.butterfly(*xs[:3]), lambda: ntt_c.butterfly(*xs_c[:3]), n2)
    xs4_c = [x[:, :n4].contiguous() for x in xs_c]
    xs4 = [x.to(dev) for x in xs4_c]
    record("butterfly4", fr, lambda: ntt_g.butterfly4(*xs4), lambda: ntt_c.butterfly4(*xs4_c), n4)

    # curve kernels on arbitrary coordinates (the formulas are polynomial
    # identities), with identity lanes, P + P lanes and infinity lanes
    nc = 1 << 15
    p = fp.modulus
    for g2, ops in ((False, g1_ops(fp)), (True, g2_ops(fp))):
        plain = CurveOps(ops.fa)
        d = 2 if g2 else 1

        def coords(k):
            return [torch.from_numpy(_lazy_words(np_rng, nc, p)) for _ in range(k * d)]

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
        name = "g2" if g2 else "g1"
        record(
            f"{name}_add",
            fp,
            lambda: flat(ops.add(pt(Pg), pt(Qg))),
            lambda: flat(plain.add(pt(P1), pt(Q))),
            nc,
        )
        aff_g = pt(Qg)[:2] + (inf_g,)
        aff_c = pt(Q)[:2] + (inf_c,)
        record(
            f"{name}_add_mixed",
            fp,
            lambda: flat(ops.add_mixed(pt(Pg), aff_g)),
            lambda: flat(plain.add_mixed(pt(P1), aff_c)),
            nc,
        )

    for name, r in results.items():
        say(
            f"[3 check] {name:14s} lanes={r['lanes']:6d} mismatches={r['mismatches']} "
            f"kernel={r['ms']:.4f} ms plain(cpu)={r['plain_ms']:.1f} ms"
        )
    missing = sorted(set(KERNELS) - set(results))
    if missing:
        fail(f"kernels not checked: {missing}")
    return results


# ---------------------------------------------------------------- phase 4
def phase_msm(torch, dev, sizes=(1024, 256)):
    from tpusnark.curves.ref import G1, G2, R
    from tpusnark.fields.spec import BN254_FP, BN254_FR
    from tpusnark_torch.curves.encoding import (
        g1_from_device_proj,
        g1_to_device,
        g2_from_device_proj,
        g2_to_device,
    )
    from tpusnark_torch.curves.tcurve import g1_ops, g2_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import MSM

    rng = random.Random(SEED)
    fp, fr = get_field(BN254_FP), get_field(BN254_FR)
    for G, ops, n, enc, dec in (
        (G1, g1_ops(fp), sizes[0], g1_to_device, g1_from_device_proj),
        (G2, g2_ops(fp), sizes[1], g2_to_device, g2_from_device_proj),
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
            fail(f"MSM {'G2' if G is G2 else 'G1'} N={n} c=16 strip path disagrees with the host sum")
        say(f"[4 msm] {'G2' if G is G2 else 'G1'} N={n} c=16 strip path matches the host sum ({dt:.2f} s)")


# ---------------------------------------------------------------- phase 5
def mul_chain(log2n: int):
    """bench.py's Groth16 circuit: x^n + x + 5 == y, n = 2^log2n - 8."""
    from tpusnark.fields.spec import BN254_FR
    from tpusnark.frontend.builder import Builder

    p = BN254_FR.modulus
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


def phase_groth16(torch, dev, log2n=LOG2_CONSTRAINTS):
    from tpusnark_torch import _host, kernels
    from tpusnark_torch.backend.groth16 import prove, setup

    times = {}
    t0 = time.perf_counter()
    cs, assign = mul_chain(log2n)
    times["compile"] = time.perf_counter() - t0
    rng = random.Random(SEED)
    kernels.reset_launches()
    t0 = time.perf_counter()
    # setup and prove return host points, so each has finished on the card
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev)
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
    verify = _host.verify.verify
    t0 = time.perf_counter()
    ok = verify(proof, vk, [assign["y"]])
    times["verify"] = time.perf_counter() - t0
    if not ok:
        fail("tpusnark's verifier rejected the port's 2^17 proof")
    if verify(proof, vk, [(assign["y"] + 1) % cs.modulus]):
        fail("tpusnark's verifier accepted the proof with a wrong public input")
    say(
        f"[5 groth16] {len(cs.constraints)} constraints, {cs.n_wires} wires: proof verifies, "
        "wrong public input rejected | "
        + " ".join(f"{k}={v:.3f}s" for k, v in times.items())
    )
    return setup_launches, launches


# ---------------------------------------------------------------- main
def main() -> None:
    torch, card = phase_card()
    phase_build()
    checks = phase_kernels(torch)
    dev = torch.device("cuda")
    phase_msm(torch, dev)
    setup_launches, launches = phase_groth16(torch, dev)
    if "jax" in sys.modules:
        fail("JAX was imported: the port and this script must run without it")
    idle = sorted(k for k in KERNELS if k not in NOT_IN_PROVE and launches[k] <= 0)
    if idle:
        fail(f"kernels of the prove path never launched by the prove: {idle}")
    stale = sorted(k for k in NOT_IN_PROVE if launches[k] > 0)
    if stale:
        fail(f"kernels listed as not in the prove were launched by it: {stale}")
    idle = sorted(k for k, where in NOT_IN_PROVE.items() if where == "setup" and setup_launches[k] <= 0)
    if idle:
        fail(f"setup-only kernels never launched by the setup: {idle}")
    say("[6 launches] prove: " + " ".join(f"{k}={launches[k]}" for k in KERNELS if k not in NOT_IN_PROVE))
    say("[6 launches] setup: " + " ".join(f"{k}={setup_launches[k]}" for k in KERNELS))
    say("[6 launches] not in the prove: " + " ".join(f"{k} ({w})" for k, w in NOT_IN_PROVE.items()))
    rows = [
        dict(
            name=name,
            route="cuda",
            source=source,
            replaces=replaces,
            launches=launches[name],
            max_abs_err=checks[name]["max_abs_err"],
            ms=checks[name]["ms"],
            plain_ms=checks[name]["plain_ms"],
        )
        for name, (source, replaces) in KERNELS.items()
        if name not in NOT_IN_PROVE
    ]
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
