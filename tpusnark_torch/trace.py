"""The port's spans and counters: where a prove spends its host time, how
often the host waits for the device, and how many bytes cross between them.

Spans. ``span(name)`` is a context manager. With no recording open it
returns one shared no-op object: no clock reading, no allocation, no
``torch.profiler.record_function``, no synchronise. Inside ``recording()``
each span appends a ``Record`` (proof id, name, parent record, start and end
from ``time.perf_counter_ns``) and enters ``record_function(name)``, so that
under ``torch.profiler`` it lands in the trace beside the device's events.
A span opened outside any other takes a new proof id; the spans inside it
carry that id. Spans are recorded from one thread at a time.

The spans of the Groth16 prove (parent: children)::

    groth16.prove            the whole prove; a new proof id
      groth16.solve          the witness solve (``solve_any``), either branch
        solver.level         one device level's instructions (device branch)
        solver.hints         one hint-bearing level's host round trip; its
                             self time launches the hints' inputs:
          solver.hints.wait    the wait for the level's device work (an
                               explicit synchronise while recording on CUDA;
                               the decode would wait for it anyway)
          solver.hints.decode  the copy to the host and ``words_to_ints``
          solver.hints.run     the hint functions (totals by hint: below)
          solver.hints.encode  ``ints_to_words``, the index tensor, the
                               upload and the scatter into W
        solver.check         the bulk A*B == C check and its ``.any()`` sync
      groth16.encode         W in normal form (and the host branch's A/B/C)
      groth16.h              the quotient H: NTTs on the device
      groth16.msm            the five MSMs, the key tables and engines
        groth16.msm.index    the k_wires index tensor and its gather
        pippenger.msm        one MSM call (``MSM.__call__`` or ``MSM.many``)
      groth16.assemble       the proof's host assembly
        groth16.assemble.decode  the MSM sums read back and made affine
        groth16.assemble.host    the host group additions and multiplications

``prove(timings=)`` adds each ``groth16.<phase>``'s seconds under its
phase's name (``solve``, ``encode``, ``h``, ``msm``, ``assemble``;
synchronised at each phase's end), and the device solver two keys of its
own inside ``solve``: ``solve_levels``, the host seconds of the
``solver.level`` calls (the launches, not waited for), and
``solve_hints``, those of the ``solver.hints`` calls (the round trips,
which wait anyway). The host solver writes neither.

No program span is named ``prove`` or ``msm``: those are the benchmark's own.
Inside ``solver.hints.run`` each hint function's calls and host seconds are
added up by ``hint_name`` (``Recording.hints``), with no span per call; a
level's calls that the solver runs as one batch (``solver_torch.BATCHED``)
add their count and the batch's seconds.

Counters. ``count(name, n)`` adds to ``COUNTS``, always (like
``kernels.LAUNCHES``, the kernel wrappers' launch counter of the same
family), at the call site, whatever the device:

    sync       a point where the host waits for the device: each
               ``Field.decode``, and the solver's ``.any()`` check
    h2d_bytes  bytes handed from host ints, lists or arrays to tensors:
               ``Field.encode``, a ``Field.const`` built, and the index
               lists of the prove path (the solver's hint outputs, k_wires,
               the commitment wires)
    d2h_bytes  bytes read back: each ``Field.decode``, the ``.any()`` flag
    msm_records
               the sorted records of the MSMs' strip passes over their
               bases, W windows x M records (padding included) a pass
               (``MSM._strip_mixed``)

and one only while a recording is open, since reading it waits for the
device (a sync of the counter's own, not counted in ``sync``):

    msm_dead_records
               of those records, the ones keyed at or past the first key
               that reaches no bucket (a zero digit, an infinity base, the
               padding): the strip pass neither reads nor adds them

A ``Recording`` holds its spans, the hint totals and the counters' change
while it was open; ``totals()`` gives per span name the count, the seconds
and the self seconds (the duration less its child spans'). Nothing is
written to a file: the caller reads the recording in its own process.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.profiler import record_function

COUNTS: dict[str, int] = {"sync": 0, "h2d_bytes": 0, "d2h_bytes": 0, "msm_records": 0, "msm_dead_records": 0}


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


@dataclass(slots=True)
class Record:
    """One span: its proof id, name, parent (an index into the recording's
    records, None for a root) and perf_counter_ns start and end."""

    proof: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int = 0


class SpanTotal(NamedTuple):
    count: int
    seconds: float
    self_seconds: float


class Recording:
    """The spans, hint totals and counter changes of one ``recording()``."""

    def __init__(self):
        self.records: list[Record] = []
        self.hints: dict[str, list[int]] = {}  # hint name -> [calls, ns]
        self.proofs = 0
        self._stack: list[int] = []
        self._counts0 = dict(COUNTS)
        self._counts1: dict[str, int] | None = None

    def _begin(self, name: str) -> int:
        if self._stack:
            parent = self._stack[-1]
            proof = self.records[parent].proof
        else:
            parent = None
            self.proofs += 1
            proof = self.proofs
        self.records.append(Record(proof, name, parent, time.perf_counter_ns()))
        self._stack.append(len(self.records) - 1)
        return self._stack[-1]

    def _end(self, idx: int) -> None:
        self.records[idx].end_ns = time.perf_counter_ns()
        self._stack.pop()

    def add_hint(self, name: str, ns: int, calls: int = 1) -> None:
        t = self.hints.setdefault(name, [0, 0])
        t[0] += calls
        t[1] += ns

    @property
    def counters(self) -> dict[str, int]:
        """Each counter's change while the recording was (or is) open."""
        now = COUNTS if self._counts1 is None else self._counts1
        return {k: v - self._counts0.get(k, 0) for k, v in now.items()}

    def totals(self) -> dict[str, SpanTotal]:
        """Per span name: (count, seconds, self seconds)."""
        child_ns = [0] * len(self.records)
        for r in self.records:
            if r.parent is not None:
                child_ns[r.parent] += r.end_ns - r.start_ns
        out: dict[str, list] = {}
        for r, kids in zip(self.records, child_ns):
            t = out.setdefault(r.name, [0, 0, 0])
            t[0] += 1
            t[1] += r.end_ns - r.start_ns
            t[2] += r.end_ns - r.start_ns - kids
        return {k: SpanTotal(n, ns / 1e9, own / 1e9) for k, (n, ns, own) in out.items()}

    def hint_totals(self) -> dict[str, tuple[int, float]]:
        """Per hint function: (calls, host seconds)."""
        return {k: (n, ns / 1e9) for k, (n, ns) in self.hints.items()}


class _Off:
    """The span of no recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_REC: Recording | None = None


class _On:
    __slots__ = ("_rec", "_name", "_idx", "_rf")

    def __init__(self, rec: Recording, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._rf = record_function(self._name)
        self._rf.__enter__()
        self._idx = self._rec._begin(self._name)
        return self

    def __exit__(self, *exc):
        self._rec._end(self._idx)
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A span named `name` in the open recording; the shared no-op without one."""
    rec = _REC
    return _OFF if rec is None else _On(rec, name)


def current() -> Recording | None:
    """The open recording, or None."""
    return _REC


def wait(device: torch.device) -> None:
    """While a recording is open, wait for `device`'s queued work (so that the
    span around it holds the wait, and the next one only its own host work);
    else nothing."""
    if _REC is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def recording():
    """Record spans, hint totals and counter changes until the block ends;
    yields the Recording. One at a time."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None
        rec._counts1 = dict(COUNTS)


@contextlib.contextmanager
def phase(name: str, timings: dict | None, key: str, device: torch.device):
    """span(name), and with `timings` its seconds added under `key`: the
    device is synchronised at the phase's end, so pass `timings` only to
    measure."""
    t0 = time.perf_counter() if timings is not None else 0.0
    with span(name):
        yield
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
