"""Circuit-compile profiler: constraints attributed to circuit source lines.

The analog of the reference's pprof-based profile package
(gnark/profile/profile.go:26-60; RecordConstraint hooked from
constraint/core.go:347): while a profiling session is active, every
constraint emitted by any builder records the user's Python call stack
trimmed at the circuit function, with sample unit = constraints.

Usage:
    with profile.start() as p:
        define(builder)
    print(p.top())

The port's copy of tpusnark/profile.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import traceback
from collections import Counter
from contextlib import contextmanager

_ACTIVE: list["Session"] = []

_SKIP_SUBSTRINGS = (
    "tpusnark_torch/frontend/",
    "tpusnark_torch/constraint/",
    "tpusnark_torch/profile",
)


class Session:
    def __init__(self, depth: int = 4):
        self.depth = depth
        self.by_site: Counter = Counter()
        self.by_stack: Counter = Counter()
        self.total = 0

    def record(self, n: int = 1):
        frames = traceback.extract_stack()
        user = [
            f
            for f in frames
            if not any(s in f.filename for s in _SKIP_SUBSTRINGS)
        ]
        user = user[-self.depth :]
        if not user:
            return
        leaf = user[-1]
        self.total += n
        self.by_site[f"{leaf.filename}:{leaf.lineno} ({leaf.name})"] += n
        stack_key = " > ".join(f"{f.name}:{f.lineno}" for f in user)
        self.by_stack[stack_key] += n

    def top(self, k: int = 20) -> str:
        lines = [f"total constraints: {self.total}"]
        for site, cnt in self.by_site.most_common(k):
            pct = 100.0 * cnt / max(1, self.total)
            lines.append(f"{cnt:>10} ({pct:5.1f}%)  {site}")
        return "\n".join(lines)


def record_constraint(n: int = 1):
    """Called by builders on each emitted constraint (no-op when inactive)."""
    if _ACTIVE:
        _ACTIVE[-1].record(n)


def is_active() -> bool:
    return bool(_ACTIVE)


@contextmanager
def start(depth: int = 4):
    s = Session(depth=depth)
    _ACTIVE.append(s)
    try:
        yield s
    finally:
        _ACTIVE.pop()
