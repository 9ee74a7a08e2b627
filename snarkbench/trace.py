"""The profiled parts of a run. A ``--trace 1`` run ends with a few proofs
under ``torch.profiler``, with spans of the benchmark's own around the program's
layers, and the MSMs' scalars captured where the MSM layer receives them.

From the exported trace it reads: the device's busy time (kernels, copies
and sets, intervals merged so that overlap counts once), the traced wall
time, the device time of the work launched inside the MSM spans, the
operations that took most device time, and the idle gaps of the device by
the innermost span the host was in. A ``--trace 0`` run whose cell reports
an end-to-end metric from the device trace profiles its whole window, the
card's activity alone, for the device's busy time (``window_busy``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MSM_SPAN = "msm"
PROVE_SPAN = "prove"


def merged_busy_us(intervals) -> float:
    """Total length of the union of (start, duration) intervals."""
    busy, end = 0.0, -1.0
    for ts, dur in sorted(intervals):
        if ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy


def _resolve(path: str, attr: str):
    owner = importlib.import_module(path)
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


@contextlib.contextmanager
def wrapped(targets, wrap):
    """Replace each (module, "attr" or "Class.attr", label) target by
    wrap(fn, label) for the duration; targets the program lacks are left
    out (they only name spans)."""
    saved = []
    try:
        for path, attr, label in targets:
            try:
                owner, name = _resolve(path, attr)
                fn = getattr(owner, name)
            except (ImportError, AttributeError):
                continue
            saved.append((owner, name, name in vars(owner), fn))
            setattr(owner, name, wrap(fn, label))
        yield
    finally:
        for owner, name, own, fn in reversed(saved):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def span(fn, label):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return inner


class MSMCapture:
    """Wraps the MSM layer's entries (``MSM.__call__`` and ``MSM.many``) in
    an "msm" span and keeps each call's scalars and the degree of its
    coordinates (1: G1 over Fp, 2: G2 over Fp2) and word counts, for the
    roofline after the traced window. The scalars are referenced, not
    copied: the window does no extra device work."""

    TARGETS = (
        ("tpusnark_torch.msm.pippenger", "MSM.__call__", MSM_SPAN),
        ("tpusnark_torch.msm.pippenger", "MSM.many", MSM_SPAN),
    )

    def __init__(self):
        self.calls = []

    def wrap(self, fn, label):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def inner(engine, points, scalars):
            x = points[0]
            degree = len(x) if isinstance(x, tuple) else 1
            fp_words = (x[0] if isinstance(x, tuple) else x).shape[0]
            flat = scalars if scalars.dim() == 2 else scalars.reshape(scalars.shape[0], -1)
            self.calls.append((flat, degree, fp_words, engine.scalar_bits))
            with record_function(label):
                return fn(engine, points, scalars)

        return inner


def profiled(sync, cuda: bool, run_proofs, spans, capture: MSMCapture):
    """Run run_proofs(prove_span) under the profiler (the card's activity
    too where `cuda`) with the spans and the MSM capture installed, sync()
    waiting for the device; returns the trace summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def prove_span(fn):
        def inner(*a, **k):
            with record_function(PROVE_SPAN):
                return fn(*a, **k)

        return inner

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with wrapped(spans, span), wrapped(capture.TARGETS, capture.wrap):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            n = run_proofs(prove_span)
            sync()
            wall = time.perf_counter() - t0
    return summarize(_events(prof), wall, n)


def window_busy(sync, cuda: bool, run):
    """run() under the profiler, the card's activity alone where `cuda`,
    sync() waiting for the device: (its result, the seconds in which an
    operation ran on the card, the number of those operations)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        out = run()
        sync()
    intervals = [(ev["ts"], ev["dur"]) for ev in _events(prof) if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    return out, merged_busy_us(intervals) / 1e6, len(intervals)


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def _kernel_name(ev) -> str:
    if ev["cat"] != "kernel":
        return ev["cat"]
    name = ev["name"]
    m = re.search(r"ts::(k_\w+)<ts::(G[12]F)", name)
    if m:
        kind = m.group(1)
        if kind == "k_strip" and name.split("(")[0].endswith("true>"):
            kind = "k_strip_mixed"
        return f"{kind}<{m.group(2)}>"
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0][:80]


def summarize(events, wall: float, n_proofs: int) -> dict:
    """The trace summary of `n_proofs` proofs that took `wall` seconds."""
    device, launches, spans = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ev["ts"]
        elif cat == "user_annotation":
            spans.append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
    intervals = [(ev["ts"], ev["dur"]) for ev in device]
    busy = merged_busy_us(intervals) / 1e6
    msm_spans = sorted((a, b) for a, b, name in spans if name == MSM_SPAN)
    msm = []
    by_name: dict[str, float] = {}
    for ev in device:
        by_name[_kernel_name(ev)] = by_name.get(_kernel_name(ev), 0.0) + ev["dur"] / 1e6
        t = launches.get((ev.get("args") or {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in msm_spans):
            msm.append((ev["ts"], ev["dur"]))
    return {
        "proofs": n_proofs,
        "window_s": wall,
        "busy_s": busy,
        "msm_device_s": merged_busy_us(msm) / 1e6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": idle_gaps(intervals, spans)[:10],
        "device_events": len(device),
    }


def idle_gaps(intervals, spans):
    """[(what the host was doing, idle seconds)]: each gap between the
    device's merged busy intervals, named by the innermost span around its
    middle ("outside the spans" where none is), summed by name, longest
    first."""
    merged = []
    for ts, dur in sorted(intervals):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    totals: dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        inner = [(b - a, name) for a, b, name in spans if a <= mid <= b]
        name = min(inner)[1] if inner else "outside the spans"
        totals[name] = totals.get(name, 0.0) + (start - end) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])
