"""Multi-device sharding for the prover's hot paths, MSM and NTT
(counterpart of tpusnark/parallel/sharding.py).

tpusnark shards from one controlling process over a ``jax.sharding.Mesh``:
its collectives are an ``all_gather`` of the MSM partials and the
all_to_all that XLA inserts for the NTT's transpose. The port does the same
from one process over a device list, the mesh: a tuple of torch devices
(several cards, one card named several times, or the CPU where the caller
names it). Shard i of a length-N axis is the contiguous chunk i of
N / len(devices) lanes, on devices[i]. The all_gather is a copy of each
partial to devices[0], the all_to_all a copy of each shard's slice to its new
owner; copies between shards on one device are views or local copies.

* MSM: the points are placed once, chunk by chunk (``shard_points``: the
  counterpart of icicle's setupDevicePointers); each shard runs the port's
  MSM on its device (the strip, scan and Horner kernels, B5/B6); the
  partials go to devices[0] and are reduced by a tree of complete adds (B6).
* NTT: four-step, n = n1 * n2: per-shard column NTTs of size n1 over the
  j2 shards, the transpose, the twiddle product (B1), per-shard row NTTs of
  size n2 over the k1 shards, in natural order on devices[0]. Every
  transform is the port's ``NTT`` (the pass kernel, B3/B4).

tpusnark's results are replicated on every device; every caller reads them
to the host or goes on on one device, so here they lie on devices[0].
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from ..fields.tfield import compute_device, get_field
from ..msm.pippenger import MSM, _last, tree_map
from ..poly.domain import Domain
from ..poly.ntt import get_ntt


def mesh_devices(devices=None) -> tuple[torch.device, ...]:
    """The devices of a mesh, each as tfield.compute_device gives it. None
    takes every card torch sees, and raises where there is none: the CPU is
    used only where the caller names it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no devices given, and torch sees no CUDA card; pass devices=("cpu",) * k to run the plain versions'
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(compute_device(d) for d in devices)
    if not devs:
        raise ValueError("an empty device list")
    return devs


def _chunks(size: int, devices) -> list[tuple[torch.device, slice]]:
    """The shards of an axis of `size`: chunk i on devices[i] where the
    device count divides it; else the whole axis on devices[0] (tpusnark
    replicates such a stage on every device, and one copy serves)."""
    n_dev = len(devices)
    if size % n_dev:
        return [(devices[0], slice(0, size))]
    step = size // n_dev
    return [(d, slice(i * step, (i + 1) * step)) for i, d in enumerate(devices)]


def tree_add_batch(ops, pts, n: int):
    """Reduce a trailing batch axis of n projective points with log2(n)
    rounds of complete adds (pads odd sizes with the identity)."""
    while n > 1:
        if n % 2:
            ident = ops.identity_like(tree_map(lambda a: a[..., :1], pts)[0])
            pts = tree_map(lambda a, i: torch.cat([a, i], dim=-1), pts, tuple(ident))
            n += 1
        half = n // 2
        lo = tree_map(lambda a: a[..., :half], pts)
        hi = tree_map(lambda a: a[..., half:], pts)
        pts = ops.add(lo, hi)
        n = half
    return pts


class ShardedMSM:
    """MSM over a device list: N points split across the devices, the
    partial sums gathered on devices[0] and tree-reduced there."""

    def __init__(self, msm: MSM, devices=None):
        self.msm = msm
        self.devices = mesh_devices(devices)

    def shard_points(self, points):
        """A point table (X, Y, inf), N divisible by the device count (coords
        may be (c0, c1) tuples for G2), as one contiguous table a shard, chunk
        i on devices[i]. Do this ONCE per table when a prover is built:
        placing it per call would defeat its residency."""
        n_dev, N = len(self.devices), _last(points)
        if N % n_dev:
            raise ValueError(f"{N} points do not split over {n_dev} devices")
        step = N // n_dev
        return tuple(
            tree_map(lambda a: a[..., i * step : (i + 1) * step].to(d).contiguous(), points)
            for i, d in enumerate(self.devices)
        )

    def __call__(self, points, scalars):
        """points: shard_points' tables; scalars: (words, N) normal form, on
        any device. Returns a projective point (batch 1) on devices[0]."""
        return self.many(points, scalars[:, None, :])

    def many(self, points, scalars):
        """k MSMs over the same sharded points: scalars (words, k, N) normal
        form -> a projective point with batch k on devices[0] (the sharded
        face of MSM.many; the sharded PLONK prover's grouped commits)."""
        step = scalars.shape[-1] // len(self.devices)
        parts = [
            self.msm.many(pts, scalars[..., i * step : (i + 1) * step].to(d))
            for i, (d, pts) in enumerate(zip(self.devices, points))
        ]
        # the all_gather: each partial to devices[0], on a new trailing axis
        d0 = self.devices[0]
        allp = tree_map(lambda *xs: torch.stack([x.to(d0) for x in xs], dim=-1), *parts)  # (words, k, n_dev)
        red = tree_add_batch(self.msm.ops, allp, len(self.devices))
        return tree_map(lambda a: a[..., 0], red)


class ShardedNTT:
    """Four-step NTT of size n = n1*n2 over a device list.

    Math (standard Cooley-Tukey decimation): with j = j1*n2 + j2 and
    k = k1 + n1*k2,

        X[k1 + n1*k2] = NTT_n2 over j2 [ w^(j2*k1) * NTT_n1 over j1 [x] ]

    where the inner size-n1 NTT uses root w^n2 and the outer size-n2 NTT
    uses root w^n1: both are the generators Domain() derives for those sizes
    (powers of the same 2-adic root).

    Sharding: stage 1 is batched over j2 (shard j2), stage 2 over k1 (shard
    k1); the copies in between are the distributed transpose. Arrays are
    (words, *batch, n); results lie on devices[0].
    """

    def __init__(self, spec: FieldSpec, n: int, devices=None):
        self.devices = devs = mesh_devices(devices)
        self.spec = spec
        self.n = n
        n_dev = len(devs)
        n1 = n_dev
        if n1 * n1 > n:
            n1 = 1
            while n1 * n1 < n:
                n1 *= 2
        n2 = n // n1
        if n1 * n2 != n:
            raise ValueError(f"a domain of {n} does not split over {n_dev} devices")
        self.n1, self.n2 = n1, n2
        self.field = get_field(spec)
        self.domain = Domain(spec, n)
        # shard a stage only when its batch axis splits over the devices;
        # tiny domains (n < n_dev^2) leave the short one whole
        self._j2 = _chunks(n2, devs)
        self._k1 = _chunks(n1, devs)
        p, w = spec.modulus, self.domain.generator
        # the twiddle rows w^(k1*j2) (and inverse) of each k1 shard, (words,
        # 1, k1 rows, n2) Montgomery, built on its device by doublings (B1)
        self._tw, self._tw_inv = (
            [
                torch.stack(
                    [get_ntt(spec, n2, d).powers(pow(base, k1, p), n2) for k1 in range(rows.start, rows.stop)], dim=1
                )[:, None]
                for d, rows in self._k1
            ]
            for base in (w, self.domain.generator_inv)
        )
        self._coset = None

    def _cosets(self):
        """shift^j and shift^-j for the j of each j2 shard, (words, 1, n1,
        n2 columns), on its device; built once."""
        if self._coset is None:
            ntt, L = get_ntt(self.spec, self.n2, self.devices[0]), self.field.n
            shifts = (self.domain.coset_shift, self.domain.coset_shift_inv)
            tables = [ntt.powers(s, self.n).view(L, 1, self.n1, self.n2) for s in shifts]
            self._coset = [[t[..., cols].to(d) for d, cols in self._j2] for t in tables]
        return self._coset

    def _over_j1(self, d, x, inverse: bool):
        """The size-n1 transform of (words, B, n1, cols) over its j1 axis."""
        ntt = get_ntt(self.spec, self.n1, d)
        y = x.transpose(-1, -2)
        y = ntt.intt(y) if inverse else ntt.ntt(y)
        return y.transpose(-1, -2)

    def _gather(self, parts, dim: int):
        """The shards' results concatenated on devices[0]."""
        d0 = self.devices[0]
        return torch.cat([x.to(d0) for x in parts], dim=dim)

    def _forward(self, x, coset: bool):
        f, L = self.field, self.field.n
        lead = x.shape[1:-1]
        xm = x.reshape(L, -1, self.n1, self.n2)
        ys = []
        for i, (d, cols) in enumerate(self._j2):
            part = xm[..., cols].to(d)
            if coset:
                part = f.mul(part, self._cosets()[0][i])
            ys.append(self._over_j1(d, part, False))  # (words, B, k1, cols)
        zs = []
        for t, (d, rows) in enumerate(self._k1):
            # the transpose: shard t gathers its k1 rows from every j2 shard
            z = torch.cat([y[..., rows, :].to(d) for y in ys], dim=-1)
            z = f.mul(z, self._tw[t])
            zs.append(get_ntt(self.spec, self.n2, d).ntt(z))  # over j2 -> k2
        # z[k1, k2] = X[k1 + n1*k2]: natural order is the transpose, flattened
        return self._gather(zs, -2).transpose(-1, -2).reshape((L, *lead, self.n))

    def _inverse(self, x, coset: bool):
        f, L = self.field, self.field.n
        lead = x.shape[1:-1]
        xm = x.reshape(L, -1, self.n2, self.n1).transpose(-1, -2)  # index (k1, k2)
        ws = []
        for t, (d, rows) in enumerate(self._k1):
            # undo stage 2 over k2 -> (k1, j2); with stage 1's 1/n1 its 1/n2
            # makes the full 1/n
            z = get_ntt(self.spec, self.n2, d).intt(xm[..., rows, :].to(d))
            ws.append(f.mul(z, self._tw_inv[t]))
        outs = []
        for i, (d, cols) in enumerate(self._j2):
            part = torch.cat([w[..., cols].to(d) for w in ws], dim=-2)  # (words, B, k1, cols)
            y = self._over_j1(d, part, True)  # (words, B, j1, cols)
            if coset:
                y = f.mul(y, self._cosets()[1][i])
            outs.append(y)
        return self._gather(outs, -1).reshape((L, *lead, self.n))

    def ntt(self, x):
        """(words, *batch, n) coefficients -> evaluations, natural order."""
        return self._forward(x, False)

    def intt(self, x):
        """(words, *batch, n) evaluations -> coefficients."""
        return self._inverse(x, False)

    def ntt_coset(self, x):
        """coefficients -> evaluations on the coset shift*<w>."""
        return self._forward(x, True)

    def intt_coset(self, x):
        """evaluations on the coset -> coefficients."""
        return self._inverse(x, True)
