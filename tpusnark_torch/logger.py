"""Structured logger: the zerolog analog
(gnark/logger/logger.go:17-45). Console logging with structured
fields; auto-quiet under pytest like the reference is under `go test`.

The port's copy of tpusnark/logger.py: same code.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_logger: logging.Logger | None = None


def logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("tpusnark")
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        _logger.addHandler(h)
        quiet = "PYTEST_CURRENT_TEST" in os.environ or os.environ.get(
            "TPUSNARK_QUIET"
        )
        _logger.setLevel(logging.WARNING if quiet else logging.INFO)
    return _logger


def set_level(level: int):
    logger().setLevel(level)


def disable():
    logger().setLevel(logging.CRITICAL + 1)


class phase:
    """Context manager logging a phase's wall-clock with structured fields,
    like the reference provers' Dur("took", ...) logs
    (backend/groth16/bn254/prove.go:319)."""

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        dur = time.time() - self.t0
        kv = " ".join(f"{k}={v}" for k, v in self.fields.items())
        logger().info("%s took=%.3fs %s", self.name, dur, kv)
        return False
