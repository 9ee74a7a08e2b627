"""Debug-info capture: the gnark `debug/` package analog.

Reference: gnark/debug/debug.go:10-27 (stack capture trimmed at the
user's `Define`) and debug/symbol_table.go (interned Location/Function
records so N constraints share one copy of each frame).  gnark gates this
behind the `debug` build tag; here the gate is the TPUSNARK_DEBUG=1 env var —
capture costs a Python stack walk per constraint, so it stays off for
production compiles.

When enabled, every constraint/gate added without an explicit `dbg` string
records the USER call stack (frames inside this package are trimmed, the
moral equivalent of gnark cutting at `Define`), and
UnsatisfiedConstraintError/UnsatisfiedGateError messages point at circuit
source lines.

The port's copy of tpusnark/debug.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import os
import sys

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def enabled() -> bool:
    return bool(os.environ.get("TPUSNARK_DEBUG"))


class SymbolTable:
    """Interned (file, line, function) locations + per-constraint stacks.

    Stacks are tuples of location ids — the same dedup shape as gnark's
    SymbolTable (debug/symbol_table.go): repeated gadget call sites cost one
    record, constraints store small id tuples.
    """

    __slots__ = ("locations", "_ids", "stacks")

    def __init__(self):
        self.locations: list[tuple[str, int, str]] = []
        self._ids: dict[tuple[str, int, str], int] = {}
        self.stacks: list[tuple[int, ...]] = []

    def intern(self, loc: tuple[str, int, str]) -> int:
        i = self._ids.get(loc)
        if i is None:
            i = len(self.locations)
            self.locations.append(loc)
            self._ids[loc] = i
        return i

    def add_stack(self, frames: list[tuple[str, int, str]]) -> int:
        sid = len(self.stacks)
        self.stacks.append(tuple(self.intern(f) for f in frames))
        return sid

    def format(self, sid: int) -> str:
        parts = []
        for lid in self.stacks[sid]:
            file, line, func = self.locations[lid]
            parts.append(f"{func} ({os.path.basename(file)}:{line})")
        return " <- ".join(parts) if parts else "(no user frames)"


def capture_stack(table: SymbolTable, max_depth: int = 8) -> int:
    """Walk the interpreter stack, keep only frames OUTSIDE this package (the
    user's circuit code), intern them into `table`, return the stack id."""
    frames: list[tuple[str, int, str]] = []
    f = sys._getframe(1)
    while f is not None and len(frames) < max_depth:
        file = f.f_code.co_filename
        if not file.startswith(_PKG_DIR):
            frames.append((file, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return table.add_stack(frames)


def maybe_capture(table: SymbolTable, dbg):
    """Builders call this on every constraint append: with capture off,
    returns `dbg` unchanged; with capture on, returns a ("stk", id, label)
    reference — the user stack plus any builder-provided label (gnark keeps
    both: the assertion name and the trimmed stack)."""
    if not enabled():
        return dbg
    return ("stk", capture_stack(table), dbg)


def format_dbg(table: SymbolTable | None, dbg) -> str | None:
    """Resolve a debug_info entry (plain string or ("stk", id, label))."""
    if isinstance(dbg, tuple) and dbg and dbg[0] == "stk":
        if table is None:
            return dbg[2] if len(dbg) > 2 else None
        stack = table.format(dbg[1])
        label = dbg[2] if len(dbg) > 2 else None
        return f"{label} at {stack}" if label else stack
    return dbg
