"""Pippenger multi-scalar multiplication (counterpart of
tpusnark/msm/pippenger.py).

Same algorithm as tpusnark: signed c-bit window digits, composite bucket
keys ``poly * B' + |digit| - 1`` (zero digits and infinity inputs share the
DEAD key), a stable sort of the keys per window with a gather of the points,
then

* N <= 96: the bit ladder;
* small N: a segmented Hillis-Steele log-scan into buckets;
* large N: strip accumulation (C strips of R rows, one C-wide complete mixed
  add per row, flush records at key boundaries; a record whose key reaches no
  bucket is neither read nor added), then the flush records are reduced by
  ``weighted_from_records`` (c >= 10) or a log-scan;
* bucket weighting by radix split, and Horner over the windows.

PyTorch runs eagerly, so where tpusnark maps a jitted per-window function
over the windows, the port carries the windows as a leading batch axis: every
phase runs once over all windows. The per-window variadic co-sort becomes
``torch.argsort`` plus a gather of keys and signs, and the 16-bit pair
packing of the point image is dropped (32-bit words fill the lanes already).

The loops that tpusnark's jit and ``lax.scan`` hide are kernels on the card
(``csrc/msm.cuh``, through ``KernelCurveOps``): the whole strip pass is one
launch over ``n_windows * C`` lanes (B5 over the affine bases, which the
kernel reads itself through the sort's order; B6 over projective records),
each step of a fold, suffix scan or segmented scan is one launch, and the
window Horner is one launch. ``_strip_mixed``, ``_strip``, ``_scan_step``
and ``_horner`` send CUDA tensors there; on CPU tensors they are the plain
versions, step-by-step loops over ``CurveOps`` whose outputs the kernels
equal coordinate by coordinate.

Coordinates are ``(words, *batch)`` words (G2: ``(c0, c1)`` tuples); a
point is an ``(X, Y, Z)`` tuple of them; scalars are ``(words, ...)`` words
of the scalar field; keys are int64.
"""

from __future__ import annotations

import functools

import torch

from .. import trace
from ..curves.tcurve import CurveOps
from ..fields.tfield import Field

_I64 = torch.int64


def tree_map(fn, *trees):
    """Map over matching nested tuples of tensors (points, Fp2 coordinates)."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *sub) for sub in zip(*trees))
    return fn(*trees)


def _pad_last(a: torch.Tensor, m: int, value=0) -> torch.Tensor:
    """Pad the last axis of a to length m with a constant."""
    extra = m - a.shape[-1]
    if extra <= 0:
        return a
    fill = torch.full(a.shape[:-1] + (extra,), value, dtype=a.dtype, device=a.device)
    return torch.cat([a, fill], dim=-1)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (L, W, M) gathered along the last axis with per-window idx (W, K)."""
    return torch.gather(a, -1, idx.expand(a.shape[:-2] + idx.shape))


@functools.lru_cache(maxsize=None)
def get_msm(group: str, c: int, curve_name: str) -> "MSM":
    """Shared MSM engine per (group "g1" or "g2", window size, curve), with
    the ops of the curve's CurveConfig."""
    from ..curves.config import get_curve
    from ..curves.tcurve import curve_ops
    from ..fields.tfield import get_field

    g1, g2 = curve_ops(curve_name)
    return MSM(g1 if group == "g1" else g2, get_field(get_curve(curve_name).fr_spec), c=c)


def auto_c(n_points: int) -> int:
    """Window size for n points: ~log2(n)+1, clamped to [2, 16] (as tpusnark)."""
    return max(2, min(16, max(1, n_points).bit_length()))


def get_msm_for(group: str, n_points: int, curve_name: str) -> "MSM":
    return get_msm(group, auto_c(n_points), curve_name)


def auto_c_many(n_points: int, k: int, scalar_bits: int = 254) -> int:
    """Window size for a k-polynomial composite MSM, as tpusnark picks it:
    the c that minimises its modeled cost W(c) * [strip mixed adds + the
    flush-record reduction], which pushes c down as k grows (the reduction
    scales with k * 2^(c-1) signed-digit buckets, the strip adds do not)."""
    M0 = k * max(1, n_points)
    best_c, best_cost = 2, float("inf")
    for c in range(4, 17):
        W = -(-(scalar_bits + 1) // c)
        B = 1 << (c - 1)
        C = min(1 << 13, 1 << max(3, (M0 - 1).bit_length() - 6))
        K = k * B + C
        if M0 >= MSM.STRIP_THRESHOLD and c - 1 > 8:
            # hierarchical reduce: two strip passes + tiny scans over K
            reduce_cost = K * 2 * 14 + 2 * k * 512 * 14
        else:
            # flat log-scan into k*B buckets + radix weighting
            m = max(M0, K)
            reduce_cost = m * max(1, (m - 1).bit_length()) * 14 + 2 * k * B * 14
        cost = W * (M0 * 12.5 + reduce_cost)
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def get_msm_many_for(group: str, n_points: int, k: int, curve_name: str) -> "MSM":
    """MSM engine sized for k same-size polynomials over shared points."""
    return get_msm(group, auto_c_many(n_points, k), curve_name)


def window_digits(scalars: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(words, N) normal-form words -> (n_windows, N) int64 c-bit digits;
    windows past the top word read zeros."""
    u = scalars.to(_I64) & 0xFFFFFFFF  # int32 >> would sign-extend
    mask = (1 << c) - 1
    out = []
    for w in range(n_windows):
        k, r = divmod(w * c, 32)
        d = u[k] >> r if k < u.shape[0] else torch.zeros_like(u[0])
        if r + c > 32 and k + 1 < u.shape[0]:
            d = d | (u[k + 1] << (32 - r))
        out.append(d & mask)
    return torch.stack(out, dim=0)


def window_digits_signed(scalars: torch.Tensor, c: int, n_windows: int):
    """Signed-digit recoding: digits in (-2^(c-1), 2^(c-1)] with a carry into
    the next window. Returns (magnitudes int64, signs bool), each
    (n_windows, N); needs scalars < 2^(c*n_windows - 1)."""
    raw = window_digits(scalars, c, n_windows)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(raw[0])
    mags, signs = [], []
    for w in range(n_windows):
        dp = raw[w] + carry
        neg = dp > half
        mags.append(torch.where(neg, full - dp, dp))
        signs.append(neg)
        carry = neg.to(_I64)
    return torch.stack(mags), torch.stack(signs)


class MSM:
    """MSM engine bound to (CurveOps, scalar Field). Works for G1 and G2."""

    STRIP_THRESHOLD = 1 << 15
    ladder_threshold: int = 96

    def __init__(
        self,
        ops: CurveOps,
        fr: Field,
        c: int = 16,
        strips: int = 1 << 13,
        strip_threshold: int = STRIP_THRESHOLD,
    ):
        self.ops = ops
        self.fr = fr
        self.c = c
        self.strips = strips
        self.strip_threshold = strip_threshold
        self.scalar_bits = fr.modulus.bit_length()
        # signed digits need one headroom bit for the final recoding carry
        self.n_windows = -(-(self.scalar_bits + 1) // c)
        self.nbuckets = 1 << (c - 1)

    def strip_shape(self, m0: int) -> tuple[int, int]:
        """(C strips, R rows) of the strip path over m0 records a window:
        each of the R rows is one mixed add over n_windows * C lanes."""
        C = min(self.strips, 1 << max(3, (m0 - 1).bit_length() - 6))
        return C, -(-m0 // C)

    def __call__(self, points_affine, scalars_norm):
        """points: (X, Y, inf), coords (words, N); scalars: (words, N)
        NORMAL-form words. Returns a projective point with batch 1."""
        with trace.span("pippenger.msm"):
            return self._msm_core(points_affine, scalars_norm[:, None, :])

    def many(self, points_affine, scalars_norm_k):
        """k MSMs over shared points: scalars (words, k, N). Returns batch k."""
        with trace.span("pippenger.msm"):
            return self._msm_core(points_affine, scalars_norm_k)

    # ------------------------------------------------------------ tiny N
    def _ladder(self, points_affine, scalars):
        """Bit ladder for tiny N: sum_b 2^b * sum_i(bit_b,i ? P_i : O).

        The same sum as tpusnark's ladder (acc = 2*acc + per-bit sum, one
        scan step per bit), scheduled for eager launches: the per-bit sums of
        all bits are folded over the points at once, then combined by a
        binary tree (level l doubles the odd half 2^l times) in ~scalar_bits
        doublings and log2(scalar_bits) adds instead of one add per bit.
        scalars: (words, k, N); returns a batch-k point."""
        ops = self.ops
        X, Y, inf = points_affine
        u = scalars.to(_I64) & 0xFFFFFFFF
        nb = 1 << (self.scalar_bits - 1).bit_length()
        bits = torch.stack(
            [(u[b // 32] >> (b % 32)) & 1 for b in range(self.scalar_bits)]
            + [torch.zeros_like(u[0])] * (nb - self.scalar_bits)
        )  # (nb, k, N)
        pts = ops.from_affine(tree_map(lambda a: a[:, None, None, :], (X, Y)) + (inf,))
        sel = ops.select(bits == 1, pts, ops.identity_like(pts[0]))  # (words, nb, k, N)

        m = inf.shape[-1]
        while m > 1:  # fold over the points
            if m % 2:
                one = ops.identity_like(tree_map(lambda a: a[..., :1], sel[0]))
                sel = tree_map(lambda a, b: torch.cat([a, b], dim=-1), sel, one)
                m += 1
            half = m // 2
            sel = ops.add(tree_map(lambda a: a[..., :half], sel), tree_map(lambda a: a[..., half:], sel))
            m = half
        acc = tree_map(lambda a: a[..., 0], sel)  # (words, nb, k): per-bit sums
        width = 1
        while nb > 1:  # sum_b 2^b S_b by pairs: S_2j + 2^width S_2j+1
            odd = tree_map(lambda a: a[:, 1::2], acc)
            for _ in range(width):
                odd = ops.double(odd)
            acc = ops.add(tree_map(lambda a: a[:, 0::2], acc), odd)
            width *= 2
            nb //= 2
        return tree_map(lambda a: a[:, 0], acc)

    # ------------------------------------------------------------ pipeline
    def _msm_core(self, points_affine, scalars):
        """MSM of k polynomials over one shared point set; scalars (words, k, N0).
        Returns a projective point with batch dim k."""
        X, Y, inf = points_affine
        N0 = inf.shape[-1]
        if N0 <= self.ladder_threshold:
            return self._ladder(points_affine, scalars)
        ops, c = self.ops, self.c
        k = scalars.shape[1]
        Bp = 1 << (c - 1)  # live buckets per poly (signed digits)
        BK = k * Bp
        M0 = k * N0
        use_strips = M0 >= self.strip_threshold
        if use_strips:
            C, R = self.strip_shape(M0)
            M = C * R
        else:
            M = M0

        skey, order, ssgn = self._sort_records(scalars, inf, M)
        if use_strips:
            fkeys, fpts = self._strip_mixed(skey, order, ssgn, (X, Y), k, C, R, BK, BK + 1)
            if c - 1 > 8 and Bp >= 1024:
                wsums = self._weighted_from_records(fkeys, fpts, k, C)
            else:
                K = min((R + 1) * C, BK + C)
                ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K]
                buckets = self._log_scan_buckets(
                    torch.gather(fkeys, -1, ridx),
                    tree_map(lambda a: _take(a, ridx), fpts),
                    K,
                    BK,
                    BK + 1,
                )
                wsums = self._weighted_buckets(buckets, k)
        else:
            Xg, Yg = self._gather_bases((X, Y), k, M, order)
            inf0 = _pad_last(inf.repeat(k) if k > 1 else inf, M, True)[order]
            pts = ops.from_affine((Xg, Yg, inf0))
            pts = (pts[0], ops.fa.select(ssgn, ops.fa.neg(pts[1]), pts[1]), pts[2])
            buckets = self._log_scan_buckets(skey, pts, M, BK, BK + 1)
            wsums = self._weighted_buckets(buckets, k)
        return self._horner(wsums)

    def _sort_records(self, scalars, inf, M: int):
        """The records of every window, sorted by bucket key. scalars (words,
        k, N0) normal form, inf (N0,): record j = poly * N0 + i is point i
        under poly's scalar, keyed poly * B' + |digit| - 1, or DEAD (k * B')
        for a zero digit, an infinity input and the padding up to M records.
        Returns (skey, order, ssgn), each (W, M): the sorted keys, the record
        each came from, and whether its digit is negative."""
        c = self.c
        k, N0 = scalars.shape[1:]
        M0, Bp = k * N0, 1 << (c - 1)
        BK = k * Bp
        mags, signs = window_digits_signed(scalars.reshape(scalars.shape[0], M0), c, self.n_windows)
        inf_flat = inf.repeat(k) if k > 1 else inf
        poly_off = (torch.arange(M0, device=inf.device) // N0) * Bp
        live = (mags > 0) & ~inf_flat
        digits = _pad_last(torch.where(live, mags - 1 + poly_off, BK), M, BK)  # (W, M)
        signs = _pad_last(signs, M, False)
        order = torch.argsort(digits, dim=-1, stable=True)
        return torch.gather(digits, -1, order), order, torch.gather(signs, -1, order)

    @staticmethod
    def _gather_bases(XY, k: int, M: int, order):
        """The bases (words, N0), tiled over the k polys and zero-padded to M
        records, gathered by each window's order: (words, W, M)."""
        return tree_map(lambda a: _pad_last(a.repeat(1, k) if k > 1 else a, M)[:, order], XY)

    def _horner(self, wsums):
        """sum_w 2^(c w) wsums[:, w] from the top window down: acc = 2^c *
        acc + wsums[:, w]. wsums: (words, W, k); returns a batch-k point."""
        ops = self.ops
        if _on_card(wsums):
            return ops.horner(tree_map(lambda a: a.contiguous(), wsums), self.c)
        acc = tree_map(lambda a: a[:, -1], wsums)
        for w in range(_leaf(wsums).shape[1] - 2, -1, -1):
            for _ in range(self.c):
                acc = ops.double(acc)
            acc = ops.add(acc, tree_map(lambda a: a[:, w], wsums))
        return acc

    # ------------------------------------------------------------ phases
    def _scan_step(self, vals, shift: int, width: int, key=None):
        """One step of a log-step reduction along the last axis: position i
        becomes vals[i] + vals[i + shift] where 0 <= i + shift < width and
        (with key, of the batch shape) key[i + shift] == key[i], and stays
        vals[i] elsewhere. One launch on the card."""
        ops = self.ops
        if _on_card(vals):
            return ops.scan_step(vals, shift, width, key)
        j = torch.arange(_last(vals)) + shift
        keep = (j >= 0) & (j < width)
        if key is not None:
            keep = keep & (torch.roll(key, -shift, dims=-1) == key)
        shifted = tree_map(lambda a: torch.roll(a, -shift, dims=-1), vals)
        return ops.select(keep, ops.add(vals, shifted), vals)

    def _fold_sum(self, vals, m: int):
        """Sum m points along the last axis by halving; result in [..., :1]."""
        width = m
        for _ in range((m - 1).bit_length()):
            half = (width + 1) // 2
            vals = self._scan_step(vals, half, width)
            width = half
        return tree_map(lambda a: a[..., :1], vals)

    def _log_scan_buckets(self, skey, pts, m: int, nbuckets: int, sent: int):
        """Segmented Hillis-Steele scan over m sorted records per window, then
        a scatter of the segment-end sums into nbuckets slots (keys >=
        nbuckets land in dropped overflow slots). skey: (W, m)."""
        ops = self.ops
        for r in range(max((m - 1).bit_length(), 0)):
            pts = self._scan_step(pts, -(1 << r), m, skey)
        last = torch.ones_like(skey[..., :1], dtype=torch.bool)
        is_end = torch.cat([skey[..., :-1] != skey[..., 1:], last], dim=-1)
        sidx = torch.where(is_end, skey, sent).clamp(max=nbuckets + 1)
        tmpl = tree_map(
            lambda a: torch.zeros(a.shape[:-1] + (nbuckets + 2,), dtype=a.dtype, device=a.device),
            pts[0],
        )
        base = tree_map(lambda a: a.contiguous(), ops.identity_like(tmpl))
        return tree_map(
            lambda ini, a: ini.scatter(-1, sidx.expand(a.shape), a)[..., :nbuckets].contiguous(), base, pts
        )

    def _strip_mixed(self, skey, order, ssgn, XY, k: int, Cs: int, Rs: int, dead: int, sent: int):
        """The strip pass over the sorted records of every window, from the
        affine bases XY (words, N0): record j < k * N0 is base j % N0, later
        records are padding (the point (0, 0), under the DEAD key); ssgn
        marks the records whose point is negated. skey, order, ssgn: (W,
        Cs*Rs). Returns as _strip_flush. One launch on the card (B5), which
        gathers the bases itself. Counts the records in ``msm_records`` and,
        while a recording is open, those keyed at or past `dead` in
        ``msm_dead_records`` (a sync)."""
        ops = self.ops
        trace.count("msm_records", skey.numel())
        if trace.current() is not None:
            trace.count("msm_dead_records", int((skey >= dead).sum()))
        if _on_card(XY):
            return ops.strip_mixed(skey, order, ssgn, XY, k * _last(XY), Cs, Rs, dead, sent)
        Xg, Yg = self._gather_bases(XY, k, Cs * Rs, order)
        Yg = ops.fa.select(ssgn, ops.fa.neg(Yg), Yg)
        return self._strip_flush(skey, (Xg, Yg), Cs, Rs, dead, sent, mixed=True)

    def _strip(self, skey, pts, Cs: int, Rs: int, dead: int, sent: int):
        """The strip pass over sorted projective records (words, W, Cs*Rs);
        returns as _strip_flush. One launch on the card (B6)."""
        if _on_card(pts):
            return self.ops.strip(skey, pts, Cs, Rs, dead, sent)
        return self._strip_flush(skey, pts, Cs, Rs, dead, sent, mixed=False)

    def _strip_flush(self, skey, pts, Cs: int, Rs: int, dead: int, sent: int, mixed: bool):
        """Strip accumulation, step by step (the plain version of the strip
        kernels): Cs strips of Rs sequential rows per window, one (W*Cs)-wide
        add per row, a flush record at each key boundary. Returns (W,
        (Rs+1)*Cs) flush keys and projective flush points; rows without a
        flush are keyed `sent`. A row keyed at or past `dead` reaches no
        bucket: the accumulator becomes the identity instead of taking the
        row's point. mixed: pts is the gathered affine (X, Y) pair (complete
        mixed adds); else projective."""
        ops = self.ops
        W = skey.shape[0]
        keys2 = skey.reshape(W, Cs, Rs)
        pts2 = tree_map(lambda a: a.reshape(a.shape[:-1] + (Cs, Rs)), pts)
        ident = ops.identity_like(tree_map(lambda a: a[..., 0], pts2[0]))
        acc = ident
        acc_key = torch.full((W, Cs), sent, dtype=skey.dtype, device=skey.device)
        fkeys, fpts = [], []
        for r in range(Rs):
            kk = keys2[..., r]
            pt = tree_map(lambda a: a[..., r], pts2)
            same = kk == acc_key
            if mixed:
                new_acc = ops.select(same, ops.add_mixed(acc, pt), ops.from_affine(pt))
            else:
                new_acc = ops.select(same, ops.add(acc, pt), pt)
            new_acc = ops.select(kk < dead, new_acc, ident)
            fkeys.append(torch.where(same, sent, acc_key))
            fpts.append(acc)
            acc, acc_key = new_acc, kk
        fkeys.append(acc_key)
        fpts.append(acc)
        Mrec = (Rs + 1) * Cs
        keys_out = torch.stack(fkeys, dim=1).reshape(W, Mrec)
        pts_out = tree_map(
            lambda *xs: torch.stack(xs, dim=-2).reshape(xs[0].shape[:-1] + (Mrec,)), *fpts
        )
        return keys_out, pts_out

    def _strip_reduce(self, skey, pts, m: int, nbuckets: int, sent: int):
        """Sorted projective records -> nbuckets bucket sums via one strip
        pass and a small log-scan over the <= nbuckets + C2 survivors. Keys
        at or past nbuckets reach no bucket (the pass drops them)."""
        C2 = max(128, min(1024, 1 << max(0, (m - 1).bit_length() - 5)))
        R2 = -(-m // C2)
        M2 = C2 * R2
        skey = _pad_last(skey, M2, sent)
        pts = tree_map(lambda a: _pad_last(a, M2), pts)
        fkeys, fpts = self._strip(skey, pts, C2, R2, nbuckets, sent)
        K2 = min((R2 + 1) * C2, nbuckets + C2)
        ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K2]
        return self._log_scan_buckets(
            torch.gather(fkeys, -1, ridx), tree_map(lambda a: _take(a, ridx), fpts), K2, nbuckets, sent
        )

    def _small_weighted(self, vals, m: int):
        """sum_b b * vals[b] over the last axis (small m): suffix scan, then
        the sum of suffixes 1..m-1. Result in [..., :1]."""
        ops = self.ops
        for r in range((m - 1).bit_length()):
            vals = self._scan_step(vals, 1 << r, m)
        iota = torch.arange(m, device=_dev(vals))
        vals = ops.select(iota >= 1, vals, ops.identity_like(vals[0]))
        return self._fold_sum(vals, m)

    def _weighted_buckets(self, buckets, k: int):
        """(.., W, k*B') bucket sums -> (.., W, k) sums of (m+1)*S_m, by the
        radix split m = Bl*hi + lo."""
        ops, c = self.ops, self.c
        Bp = 1 << (c - 1)
        Bl = 1 << ((c - 1) // 2)
        Bh = Bp // Bl
        S = tree_map(lambda a: a.reshape(a.shape[:-1] + (k, Bh, Bl)), buckets)
        rows = tree_map(lambda a: a[..., 0].contiguous(), self._fold_sum(S, Bl))  # (.., k, Bh)
        cols = tree_map(lambda a: a.transpose(-1, -2).contiguous(), S)  # (.., k, Bl, Bh)
        cols = tree_map(lambda a: a[..., 0].contiguous(), self._fold_sum(cols, Bh))  # (.., k, Bl)
        w_hi = self._small_weighted(rows, Bh)
        w_lo = self._small_weighted(cols, Bl)
        total = self._fold_sum(rows, Bh)
        for _ in range(Bl.bit_length() - 1):
            w_hi = ops.double(w_hi)
        out = ops.add(ops.add(w_hi, w_lo), total)
        return tree_map(lambda a: a[..., 0], out)

    def _weighted_from_records(self, fkeys, fpts, k: int, C: int):
        """Flush records -> per-poly weighted sums without the k*B' bucket
        array: weight m+1 = 256*u + (v+1) with m = 256u + v, so two small
        bucket spaces (k*B'/256 hi slots, k*256 lo slots), each reduced by a
        strip pass and a scan."""
        ops, c = self.ops, self.c
        Bp = 1 << (c - 1)
        BK = k * Bp
        nh = Bp >> 8
        K = min(fkeys.shape[-1], BK + C)
        ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K]
        skey = torch.gather(fkeys, -1, ridx)
        pts = tree_map(lambda a: _take(a, ridx), fpts)
        # hi part: live key = poly*B' + m, so key >> 8 = poly*nh + (m >> 8);
        # DEAD and the sentinel shift into the dropped overflow slots
        S_hi = self._strip_reduce(skey >> 8, pts, K, k * nh, k * nh + 1)
        S_hi = tree_map(lambda a: a.reshape(a.shape[:-1] + (k, nh)), S_hi)
        w_hi = self._small_weighted(S_hi, nh)
        # lo part: re-sort by poly*256 + (m & 255)
        lkey = torch.where(skey < BK, (skey >> (c - 1)) * 256 + (skey & 255), k * 256)
        lidx = torch.argsort(lkey, dim=-1, stable=True)
        S_lo = self._strip_reduce(
            torch.gather(lkey, -1, lidx),
            tree_map(lambda a: _take(a, lidx), pts),
            K,
            k * 256,
            k * 256 + 1,
        )
        S_lo = tree_map(lambda a: a.reshape(a.shape[:-1] + (k, 256)), S_lo)
        w_lo = self._small_weighted(S_lo, 256)
        total = self._fold_sum(S_lo, 256)
        for _ in range(8):
            w_hi = ops.double(w_hi)
        out = ops.add(ops.add(w_hi, w_lo), total)
        return tree_map(lambda a: a[..., 0], out)


def _leaf(pt) -> torch.Tensor:
    while isinstance(pt, tuple):
        pt = pt[0]
    return pt


def _dev(pt) -> torch.device:
    return _leaf(pt).device


def _on_card(pt) -> bool:
    """Whether a point's tensors lie on a card: then the MSM's loops are the
    fused kernels of KernelCurveOps, else the plain versions here."""
    return _dev(pt).type == "cuda"


def _last(pt) -> int:
    """Length of the last axis of a point's (or coordinate's) tensors."""
    return _leaf(pt).shape[-1]

