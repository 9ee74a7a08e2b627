"""Prover and verifier options (the port's copy of tpusnark/backend/config.py):
the gnark backend.ProverConfig and VerifierConfig analogs.

Reference: gnark/backend/backend.go:57-199. gnark threads a `ProverConfig`
built from functional options through every Prove call; here it is a frozen
dataclass with `with_*` helpers returning updated copies:

    cfg = ProverConfig().with_rng(my_rng).with_hints(my_hint)
    proof = groth16.prove(cs, pk, w, config=cfg)

Provers keep accepting bare kwargs (`rng=`) for the common cases; `config=`
is the structured superset. `accelerator` mirrors gnark's
`WithIcicleAcceleration` (gnark/backend/backend.go:132): "gpu" runs the
device path (the witness solver on the card where the circuit's level shape
favours it), "host" pins the host solver, as tpusnark's "host" does.
`challenge_hash` and `kzg_fold_hash` replace PLONK's SHA-256 Fiat-Shamir
hashes (gnark WithProverChallengeHashFunction and
WithProverKZGFoldingHashFunction); a verifier must be given the same ones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

ACCELERATORS = ("gpu", "host")


@dataclass(frozen=True)
class ProverConfig:
    # deterministic-randomness seam (Groth16 r,s; PLONK blinding): () -> int
    rng: Callable[[], int] | None = None
    # extra hint functions available to the solver, keyed by registered name
    # (gnark solver.WithHints, constraint/solver/options.go)
    hints: dict = field(default_factory=dict)
    # prover-side hint overrides, e.g. BSB22 placeholder -> real commit
    # (gnark solver.OverrideHint; reference icicle.go:152-187)
    hint_overrides: dict = field(default_factory=dict)
    # challenge hash override for Fiat-Shamir (gnark
    # WithProverChallengeHashFunction, backend.go:74) — None = SHA-256,
    # the gnark default
    challenge_hash: Any = None
    # KZG batch-fold hash override (WithProverKZGFoldingHashFunction)
    kzg_fold_hash: Any = None
    # "gpu" = the device path; "host" = the host witness solver
    accelerator: str = "gpu"
    # resolve api.Println entries during solving into cs.solve_logs
    solver_logs: bool = True

    # ---------------------------------------------------------- with_* style
    def with_rng(self, rng) -> "ProverConfig":
        return dataclasses.replace(self, rng=rng)

    def with_hints(self, **hints) -> "ProverConfig":
        return dataclasses.replace(self, hints={**self.hints, **hints})

    def with_hint_overrides(self, overrides: dict) -> "ProverConfig":
        return dataclasses.replace(
            self, hint_overrides={**self.hint_overrides, **overrides}
        )

    def with_challenge_hash(self, h) -> "ProverConfig":
        return dataclasses.replace(self, challenge_hash=h)

    def with_kzg_fold_hash(self, h) -> "ProverConfig":
        return dataclasses.replace(self, kzg_fold_hash=h)

    def with_accelerator(self, name: str) -> "ProverConfig":
        return dataclasses.replace(self, accelerator=name)

    def __post_init__(self):
        if self.accelerator not in ACCELERATORS:
            raise ValueError(f"accelerator {self.accelerator!r}: one of {', '.join(ACCELERATORS)}")


@dataclass(frozen=True)
class VerifierConfig:
    """gnark backend.VerifierConfig (backend.go:169-199): hash overrides
    must match the prover's for challenges to line up."""

    challenge_hash: Any = None
    kzg_fold_hash: Any = None

    def with_challenge_hash(self, h) -> "VerifierConfig":
        return dataclasses.replace(self, challenge_hash=h)

    def with_kzg_fold_hash(self, h) -> "VerifierConfig":
        return dataclasses.replace(self, kzg_fold_hash=h)


def resolve(config: ProverConfig | None, rng=None) -> ProverConfig:
    """Merge the legacy bare-kwarg surface into a ProverConfig: an explicit
    `rng=` kwarg wins over the config's (it is the narrower, later option)."""
    cfg = config or ProverConfig()
    if rng is not None:
        cfg = cfg.with_rng(rng)
    if cfg.hints:
        # make named hints resolvable for deserialized constraint systems
        # (gnark solver.WithHints; lookup happens by name at solve time,
        # constraint/hints.get_hint)
        from ..constraint.hints import _REGISTRY, register_hint

        for name, fn in cfg.hints.items():
            if _REGISTRY.get(name) is not fn:
                register_hint(fn, name)
    return cfg
