"""Multi-device Groth16 prover core (counterpart of
tpusnark/backend/groth16/sharded.py), over BN254 as tpusnark's.

The proving key's point tables are split over a device list
(``parallel.sharding``: a tuple of torch devices, shard i the contiguous
chunk i), and the prove's device work runs sharded: the A/B/C evaluation on
devices[0], the quotient H through four-step ``ShardedNTT`` transforms, and
the 4+1 MSMs through ``ShardedMSM`` (each shard the port's MSM on its device,
the partials tree-reduced on devices[0]). Host work is the witness solve and
the proof's assembly, as in tpusnark.

All point tables are padded to ONE common length ``m`` with identity points
(the identity lands in the dead bucket whatever the scalar, so any scalar
tail is safe), so that every G1 MSM has the same shards.
"""

from __future__ import annotations

import secrets
import time

import torch

from ...constraint.eval_torch import abc_evaluator
from ...constraint.system import ConstraintSystem
from ...curves.encoding import g1_from_device_proj, g1_to_device, g2_from_device_proj, g2_to_device
from ...curves.config import get_curve
from ...fields.spec import BN254_FP, BN254_FR
from ...fields.tfield import get_field
from ...msm.pippenger import get_msm_for, tree_map
from ...parallel.sharding import ShardedMSM, ShardedNTT, mesh_devices
from .keys import Proof, ProvingKey, device_tables

_bn254 = get_curve("bn254")
_fr = get_field(BN254_FR)
_fp = get_field(BN254_FP)


def _pad_table(table, m: int, encode, device):
    """A device point table (X, Y, inf) padded with identity points to m."""
    extra = m - table[2].shape[0]
    if extra <= 0:
        return table
    pad = encode([None] * extra, _fp, device)
    return tree_map(lambda a, b: torch.cat([a, b], dim=-1), table, pad)


class ShardedProverCore:
    """The prove's device work bound to (cs, pk, devices).

    __call__(w_mont, w_norm) -> (ar, bs1, bs2, krs_k, krs_z) raw projective
    points on devices[0], where w_mont/w_norm are the solved wire vector in
    Montgomery / normal form on devices[0]; w_norm padded to self.m wires."""

    def __init__(self, cs: ConstraintSystem, pk: ProvingKey, devices=None):
        if pk.curve != "bn254":
            raise NotImplementedError("the sharded prover is BN254-only, as tpusnark's")
        self.cs = cs
        self.pk = pk
        self.devices = devs = mesh_devices(devices)
        n_dev = len(devs)
        n = pk.domain_n
        self.n = n
        if n % n_dev:
            raise ValueError(f"a domain of {n} is smaller than {n_dev} devices")
        # ONE padded length for every MSM: all G1 tables share its shards;
        # identity padding is sound for any scalar tail
        self.m = -(-max(cs.n_wires, n) // n_dev) * n_dev

        d0 = devs[0]
        self._ev = abc_evaluator(cs, _fr, d0)
        self._ntt = ShardedNTT(BN254_FR, n, devs)
        n_local = self.m // n_dev
        self._msm1 = ShardedMSM(get_msm_for("g1", n_local, "bn254"), devs)
        self._msm2 = ShardedMSM(get_msm_for("g2", n_local, "bn254"), devs)
        # the tables placed ONCE in their sharded layout (the analog of
        # icicle's setupDevicePointers, icicle.go:31-130), from the key's
        # tables on devices[0] (setup installs them; else encoded once)
        tables = device_tables(pk, d0)
        self._pts = {
            name: msm.shard_points(_pad_table(tables[name], self.m, enc, d0))
            for name, msm, enc in (
                ("a", self._msm1, g1_to_device),
                ("b1", self._msm1, g1_to_device),
                ("b2", self._msm2, g2_to_device),
                ("k", self._msm1, g1_to_device),
                ("z", self._msm1, g1_to_device),
            )
        }
        p = _fr.spec.modulus
        shift = self._ntt.domain.coset_shift
        self._den_mont = _fr.const(pow((pow(shift, n, p) - 1) % p, -1, p), mont=True, device=d0)
        # BSB22: pk.K excludes committed and commitment wires; gather the
        # backing wires explicitly (the same layout rule as the unsharded
        # prover; with no commitment, the private wires)
        from .setup import k_pk_wires_for

        self._k_wires = torch.tensor(k_pk_wires_for(cs), dtype=torch.int64, device=d0)

    # ------------------------------------------------------------------ H
    def compute_h(self, A, B, C):
        """(words, n_constraints) Montgomery solution vectors -> (words, n)
        normal H coefficients (the top coefficient is the zero pad slot),
        with the three polynomials batched through each sharded transform."""
        f, ntt, n = _fr, self._ntt, self.n
        abc = torch.stack([torch.cat([x, f.zeros((n - x.shape[1],), device=x.device)], dim=1) for x in (A, B, C)], 1)
        ev = ntt.ntt_coset(ntt.intt(abc))  # (words, 3, n)
        num = f.sub(f.mul(ev[:, 0], ev[:, 1]), ev[:, 2])
        num = f.mul(num, f.broadcast_const(self._den_mont, num))
        # degree(H) = n - 2: slot n - 1 is zero; kept (it pairs with an
        # identity pad point in the z table)
        return f.from_mont(ntt.intt_coset(num))

    # ------------------------------------------------------------------ core
    def __call__(self, w_mont, w_norm, mark=None):
        """w_mont: (words, n_wires) Montgomery; w_norm: (words, m) normal
        form (zero-padded). Returns 5 raw projective points. `mark(name)`,
        if given, is called after the A/B/C evaluation ("encode", as in the
        unsharded prover), the h and the msm phases."""
        f = _fr
        A, B, C = self._ev(w_mont)
        if mark:
            mark("encode")
        h = self.compute_h(A, B, C)
        h = torch.cat([h, f.zeros((self.m - h.shape[1],), device=h.device)], dim=1)
        # the scalars of pk.K's wires, moved to the front (the k table's
        # layout); the tail pairs with identity padding
        priv = w_norm.index_select(1, self._k_wires)
        priv = torch.cat([priv, f.zeros((self.m - priv.shape[1],), device=priv.device)], dim=1)
        if mark:
            mark("h")
        pts = self._pts
        out = (
            self._msm1(pts["a"], w_norm),
            self._msm1(pts["b1"], w_norm),
            self._msm2(pts["b2"], w_norm),
            self._msm1(pts["k"], priv),
            self._msm1(pts["z"], h),
        )
        if mark:
            mark("msm")
        return out


def prove_sharded(
    cs: ConstraintSystem,
    pk: ProvingKey,
    assignment: dict,
    devices=None,
    rng=None,
    timings: dict | None = None,
) -> Proof:
    """Groth16 proof over a device list (every card torch sees where
    `devices` is None): host solve, ShardedProverCore, host assembly. Draws
    r and s first, as the unsharded prover does, so the same rng gives its
    proof.

    `timings`: optional dict filled with per-phase wall-clock seconds
    (solve / encode / h / msm / assemble); timing synchronises the devices
    between phases, so pass it only to measure."""
    from ...constraint.solver import solve
    from ...curves.pedersen import pedersen_batch_prove
    from .prove import bsb22_prover_state

    G1, G2 = _bn254.host.G1, _bn254.host.G2
    p = cs.modulus
    rand = rng or (lambda: secrets.randbelow(p))
    r, s = rand(), rand()

    core = _core_cache(cs, pk, devices)
    d0 = core.devices[0]
    t_last = [time.perf_counter()]

    def mark(name):
        if timings is None:
            return
        for d in set(core.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        t = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + (t - t_last[0])
        t_last[0] = t

    # BSB22 commitments ride the same hint-override seam as the unsharded
    # prover
    overrides, proof_commitments, private_vals = bsb22_prover_state(cs, pk)
    W = solve(cs, assignment, hint_overrides=overrides)
    pok = None
    if cs.commitments:
        seeds = b"".join(int(W[cm.commitment_index]).to_bytes(32, "big") for cm in cs.commitments)
        pok = pedersen_batch_prove(pk.commitment_keys, private_vals, seeds)
    mark("solve")
    w_mont = _fr.encode(W, mont=True, device=d0)
    w_norm = _fr.encode(W + [0] * (core.m - len(W)), mont=False, device=d0)
    mark("encode")

    ar_raw, bs1_raw, bs2_raw, krs_k_raw, krs_z_raw = core(w_mont, w_norm, mark)
    (ar_sum,) = g1_from_device_proj(ar_raw, _fp)
    (bs1_sum,) = g1_from_device_proj(bs1_raw, _fp)
    (bs2_sum,) = g2_from_device_proj(bs2_raw, _fp, _bn254.host.Fp2, _bn254.fp2_q)
    (krs_k_sum,) = g1_from_device_proj(krs_k_raw, _fp)
    (krs_z_sum,) = g1_from_device_proj(krs_z_raw, _fp)

    ar = G1.add(G1.add(pk.alpha_g1, ar_sum), G1.mul(pk.delta_g1, r))
    bs = G2.add(G2.add(pk.beta_g2, bs2_sum), G2.mul(pk.delta_g2, s))
    bs1 = G1.add(G1.add(pk.beta_g1, bs1_sum), G1.mul(pk.delta_g1, s))
    krs = G1.add(krs_k_sum, krs_z_sum)
    krs = G1.add(krs, G1.mul(ar, s))
    krs = G1.add(krs, G1.mul(bs1, r))
    krs = G1.add(krs, G1.mul(pk.delta_g1, (-r * s) % p))
    mark("assemble")
    return Proof(ar=ar, krs=krs, bs=bs, commitments=proof_commitments, commitment_pok=pok)


def _core_cache(cs, pk, devices=None) -> ShardedProverCore:
    """The sharded core of (cs, devices), cached ON the proving key: that
    ties the cache's lifetime to its owner, and the entry keeps cs alive so
    that its id() key cannot alias another circuit."""
    devs = mesh_devices(devices)
    cache = pk.__dict__.setdefault("_sharded_cores", {})
    key = (id(cs), tuple(str(d) for d in devs))
    entry = cache.get(key)
    if entry is None or entry[1] is not cs:
        cache[key] = entry = (ShardedProverCore(cs, pk, devs), cs)
    return entry[0]
