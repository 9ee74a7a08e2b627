"""Multi-device PLONK prover: the port's prover (prove.py) driven over a
device list (counterpart of tpusnark/backend/plonk/sharded.py), over BN254.

Every KZG commitment (the MSM hot path) runs through
``parallel.sharding.ShardedMSM`` / ``.many``: the SRS points split over the
devices once, each shard the port's MSM on its device, the partials
tree-reduced on devices[0]; grouped commits share one composite-key MSM a
shard, as in the unsharded prover.

tpusnark also pins the domain-sized arrays to its mesh and leaves the split
of each stage's elementwise algebra and the NTTs' reshapes to XLA's SPMD
partitioner. torch has no such partitioner: here ``place`` keeps those
arrays on the key's device, and the stages run there as in the unsharded
prover. The proof and transcript are the same as prove()'s, so the same
rng gives its proof, and it verifies under the standard verifier.
"""

from __future__ import annotations

import torch

from ...constraint.scs import SparseConstraintSystem
from ...curves.encoding import g1_from_device_proj, g1_to_device
from ...fields.spec import BN254_FP
from ...fields.tfield import get_field
from ...msm.pippenger import _pad_last, get_msm_for, tree_map
from ...parallel.sharding import ShardedMSM, mesh_devices
from .keys import PlonkProof, PlonkProvingKey
from .prove import prove as _prove

_fp = get_field(BN254_FP)


class ShardedPlonkEngine:
    """Commit/placement backend for prove(..., engine=...) over a device
    list, with the interface of prove.py's _LocalEngine."""

    def __init__(self, pk: PlonkProvingKey, devices=None):
        self.devices = devs = mesh_devices(devices)
        self.device = pk.device
        n_dev = len(devs)
        n_srs = len(pk.srs.g1)
        # identity-pad the SRS to a length the devices split: identity
        # points contribute nothing whatever the padded scalar tail
        self.m = -(-n_srs // n_dev) * n_dev
        pts = pk.srs.device(pk.device)["g1"]
        if self.m > n_srs:
            pad = g1_to_device([None] * (self.m - n_srs), _fp, pk.device)
            pts = tree_map(lambda a, b: torch.cat([a, b], dim=-1), pts, pad)
        self._smsm = ShardedMSM(get_msm_for("g1", self.m // n_dev, "bn254"), devs)
        self._pts = self._smsm.shard_points(pts)

    # ---- placement: the key's device (no SPMD partitioner to hand it to)
    def place(self, x):
        return tree_map(lambda a: a.to(self.device), x)

    # ---- commits ---------------------------------------------------------
    def commit(self, srs, coeffs_norm):
        (out,) = g1_from_device_proj(self._smsm(self._pts, _pad_last(coeffs_norm, self.m)), _fp)
        return out

    def commit_many(self, srs, stack_norm):
        return g1_from_device_proj(self._smsm.many(self._pts, _pad_last(stack_norm, self.m)), _fp)


def _engine_cache(pk: PlonkProvingKey, devices=None) -> ShardedPlonkEngine:
    """The engine of `devices`, cached ON the proving key."""
    devs = mesh_devices(devices)
    cache = pk.__dict__.setdefault("_sharded_engines", {})
    key = tuple(str(d) for d in devs)
    if key not in cache:
        cache[key] = ShardedPlonkEngine(pk, devs)
    return cache[key]


def prove_sharded(
    cs: SparseConstraintSystem,
    pk: PlonkProvingKey,
    assignment: dict,
    devices=None,
    rng=None,
    config=None,
    timings: dict | None = None,
) -> PlonkProof:
    """PLONK proof over a device list (every card torch sees where `devices`
    is None). The same proof as prove()'s under the same rng."""
    eng = _engine_cache(pk, devices)
    return _prove(cs, pk, assignment, rng=rng, config=config, timings=timings, engine=eng)
