"""Constraint-count regression framework.

The analog of gnark's internal/stats (reference:
gnark/internal/stats/stats.go:46-74 + latest.stats, checked by
stats_test.go:11-44): a table of per-snippet constraint counts, compared
against a checked-in baseline to catch accidental constraint blowups in
builders/gadgets.

The port's copy of tpusnark/stats.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import json
import os

SNIPPETS = {}


def snippet(name):
    def deco(fn):
        SNIPPETS[name] = fn
        return fn

    return deco


def _register_builtin():
    from .fields.spec import BN254_FR
    from .frontend.builder import Builder
    from .frontend.plonk_builder import PlonkBuilder

    p = BN254_FR.modulus

    def both(name, body):
        @snippet(f"{name}/r1cs")
        def _r():
            b = Builder(p)
            body(b)
            return b.compile().stats()["n_constraints"]

        @snippet(f"{name}/scs")
        def _s():
            b = PlonkBuilder(p)
            body(b)
            cs = b.compile()
            return cs.stats()["n_gates"] - cs.n_public

    both("mul", lambda b: b.mul(b.secret("x"), b.secret("y")))
    both("div", lambda b: b.div(b.secret("x"), b.secret("y")))
    both("inverse", lambda b: b.inverse(b.secret("x")))
    both("is_zero", lambda b: b.is_zero(b.secret("x")))
    both("xor", lambda b: b.xor(b.secret("x"), b.secret("y")))
    both("select", lambda b: b.select(b.secret("c"), b.secret("x"), b.secret("y")))
    both("to_binary_64", lambda b: b.to_binary(b.secret("x"), 64))
    both("cmp_le_64", lambda b: b.assert_is_less_or_equal(b.secret("x"), b.secret("y")))

    def mimc_body(b):
        from .hashes.mimc import MiMCGadget

        g = MiMCGadget(b)
        g.write(b.secret("m"))
        g.sum()

    both("mimc", mimc_body)

    def eddsa_body(b):
        from .gadgets.eddsa import verify_eddsa

        verify_eddsa(
            b,
            (b.secret("rx"), b.secret("ry")),
            b.secret("s"),
            b.secret("msg"),
            (b.secret("ax"), b.secret("ay")),
        )

    both("eddsa_verify", eddsa_body)


def collect() -> dict:
    if not SNIPPETS:
        _register_builtin()
    return {name: fn() for name, fn in sorted(SNIPPETS.items())}


LATEST = os.path.join(os.path.dirname(__file__), "latest_stats.json")


def save_baseline(path: str = LATEST):
    with open(path, "w") as f:
        json.dump(collect(), f, indent=1, sort_keys=True)


def check_against_baseline(path: str = LATEST) -> list[str]:
    """Returns a list of regressions (empty = clean)."""
    with open(path) as f:
        base = json.load(f)
    cur = collect()
    problems = []
    for name, want in base.items():
        got = cur.get(name)
        if got != want:
            problems.append(f"{name}: {want} -> {got}")
    for name in cur:
        if name not in base:
            problems.append(f"{name}: new snippet (re-save baseline)")
    return problems


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "save":
        save_baseline()
        print("baseline saved:", LATEST)
    else:
        probs = check_against_baseline()
        print("\n".join(probs) if probs else "stats: clean")
