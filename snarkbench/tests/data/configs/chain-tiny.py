"""A test-size configuration: y = x^(2^squarings) + x, with x and w = x + 1
secret and y public (w's constraint touches no public wire, so a compile
that drops it still proves the same public statement)."""

from __future__ import annotations

from snarkbench.reference.bn254 import R

PROGRAM_GADGETS = None
REFERENCE_GADGETS = None


def define(b, g, cfg) -> None:
    x = b.secret("x")
    acc = x
    for _ in range(cfg["squarings"]):
        acc = b.mul(acc, acc)
    b.assert_is_equal(b.add(acc, x), b.public("y"))
    b.assert_is_equal(b.secret("w"), b.add(x, 1))


def inputs(cfg, rng):
    while True:
        x = rng.randrange(R)
        yield {"x": x, "w": (x + 1) % R, "y": (pow(x, 1 << cfg["squarings"], R) + x) % R}
