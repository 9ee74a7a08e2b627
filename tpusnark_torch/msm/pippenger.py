"""Pippenger multi-scalar multiplication (counterpart of
tpusnark/msm/pippenger.py).

Same algorithm as tpusnark: signed c-bit window digits, composite bucket
keys ``poly * B' + |digit| - 1`` (zero digits and infinity inputs share the
DEAD key), a stable sort of the keys per window with a gather of the points,
then

* N <= 96: the bit ladder;
* small N: a segmented Hillis-Steele log-scan into buckets;
* large N: strip accumulation (C strips of R rows, one C-wide complete mixed
  add per row, flush records at key boundaries), then the flush records are
  reduced by ``weighted_from_records`` (c >= 10) or a log-scan;
* bucket weighting by radix split, and Horner over the windows.

PyTorch runs eagerly, so where tpusnark maps a jitted per-window function
over the windows, the port carries the windows as a leading batch axis: every
phase runs once over all windows, and each row of the strip scan is one
kernel launch over ``n_windows * C`` lanes. The per-window variadic co-sort
becomes ``torch.argsort`` plus a gather, and the 16-bit pair packing of the
point image is dropped (32-bit words fill the lanes already). The group law
is ``CurveOps``: on CUDA tensors its add and add_mixed are the kernels
B6 and B5.

Coordinates are ``(words, *batch)`` words (G2: ``(c0, c1)`` tuples); a
point is an ``(X, Y, Z)`` tuple of them; scalars are ``(words, ...)`` words
of the scalar field; keys are int64.
"""

from __future__ import annotations

import functools

import torch

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
    the ops of tpusnark's CurveConfig for the curve."""
    from tpusnark.curves.config import get_curve

    from ..curves.tcurve import curve_ops
    from ..fields.tfield import get_field

    g1, g2 = curve_ops(curve_name)
    return MSM(g1 if group == "g1" else g2, get_field(get_curve(curve_name).fr_spec), c=c)


def auto_c(n_points: int) -> int:
    """Window size for n points: ~log2(n)+1, clamped to [2, 16] (as tpusnark)."""
    return max(2, min(16, max(1, n_points).bit_length()))


def get_msm_for(group: str, n_points: int, curve_name: str) -> "MSM":
    return get_msm(group, auto_c(n_points), curve_name)


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

    def __call__(self, points_affine, scalars_norm):
        """points: (X, Y, inf), coords (words, N); scalars: (words, N)
        NORMAL-form words. Returns a projective point with batch 1."""
        return self._msm_core(points_affine, scalars_norm[:, None, :])

    def many(self, points_affine, scalars_norm_k):
        """k MSMs over shared points: scalars (words, k, N). Returns batch k."""
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
        dev = inf.device
        use_strips = M0 >= self.strip_threshold
        if use_strips:
            C = min(self.strips, 1 << max(3, (M0 - 1).bit_length() - 6))
            R = -(-M0 // C)
            M = C * R
        else:
            M = M0

        mags, signs = window_digits_signed(
            scalars.reshape(scalars.shape[0], M0), c, self.n_windows
        )
        inf_flat = inf.repeat(k) if k > 1 else inf
        poly_off = (torch.arange(M0, device=dev) // N0) * Bp
        live = (mags > 0) & ~inf_flat
        digits = _pad_last(torch.where(live, mags - 1 + poly_off, BK), M, BK)  # (W, M)
        signs = _pad_last(signs, M, False)

        def image(a):  # (words, N0) -> (words, M): tiled over polys, zero-padded
            return _pad_last(a.repeat(1, k) if k > 1 else a, M)

        XY = tree_map(image, (X, Y))

        # every window at once: (W, M) keys, (words, W, M) coordinates
        order = torch.argsort(digits, dim=-1, stable=True)
        skey = torch.gather(digits, -1, order)
        ssgn = torch.gather(signs, -1, order)
        Xg, Yg = tree_map(lambda a: a[:, order], XY)
        if use_strips:
            Yg = ops.fa.select(ssgn, ops.fa.neg(Yg), Yg)
            fkeys, fpts = self._strip_flush(skey, (Xg, Yg), C, R, BK + 1, mixed=True)
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
            inf0 = _pad_last(inf_flat, M, True)[order]
            pts = ops.from_affine((Xg, Yg, inf0))
            pts = (pts[0], ops.fa.select(ssgn, ops.fa.neg(pts[1]), pts[1]), pts[2])
            buckets = self._log_scan_buckets(skey, pts, M, BK, BK + 1)
            wsums = self._weighted_buckets(buckets, k)

        # Horner from the top window down: acc = 2^c * acc + wsum[w]
        acc = tree_map(lambda a: a[:, self.n_windows - 1], wsums)
        for w in range(self.n_windows - 2, -1, -1):
            for _ in range(c):
                acc = ops.double(acc)
            acc = ops.add(acc, tree_map(lambda a: a[:, w], wsums))
        return acc

    # ------------------------------------------------------------ phases
    def _fold_sum(self, vals, m: int):
        """Sum m points along the last axis by halving; result in [..., :1]."""
        if m == 1:
            return vals
        ops = self.ops
        iota = torch.arange(m, device=_dev(vals))
        width = m
        for _ in range((m - 1).bit_length()):
            half = (width + 1) // 2
            shifted = tree_map(lambda a: torch.roll(a, -half, dims=-1), vals)
            vals = ops.select((iota + half) < width, ops.add(vals, shifted), vals)
            width = half
        return tree_map(lambda a: a[..., :1], vals)

    def _log_scan_buckets(self, skey, pts, m: int, nbuckets: int, sent: int):
        """Segmented Hillis-Steele scan over m sorted records per window, then
        a scatter of the segment-end sums into nbuckets slots (keys >=
        nbuckets land in dropped overflow slots). skey: (W, m)."""
        ops = self.ops
        iota = torch.arange(m, device=skey.device)
        for r in range(max((m - 1).bit_length(), 0)):
            d = 1 << r
            shifted = tree_map(lambda a: torch.roll(a, d, dims=-1), pts)
            same = (iota >= d) & (torch.roll(skey, d, dims=-1) == skey)
            pts = ops.select(same, ops.add(pts, shifted), pts)
        last = torch.ones_like(skey[..., :1], dtype=torch.bool)
        is_end = torch.cat([skey[..., :-1] != skey[..., 1:], last], dim=-1)
        sidx = torch.where(is_end, skey, sent).clamp(max=nbuckets + 1)
        tmpl = tree_map(
            lambda a: torch.zeros(a.shape[:-1] + (nbuckets + 2,), dtype=a.dtype, device=a.device),
            pts[0],
        )
        base = tree_map(lambda a: a.contiguous(), ops.identity_like(tmpl))
        return tree_map(
            lambda ini, a: ini.scatter(-1, sidx.expand(a.shape), a)[..., :nbuckets], base, pts
        )

    def _strip_flush(self, skey, pts, Cs: int, Rs: int, sent: int, mixed: bool):
        """Strip accumulation: Cs strips of Rs sequential rows per window, one
        (W*Cs)-wide add per row, a flush record at each key boundary.
        Returns (W, (Rs+1)*Cs) flush keys and projective flush points; rows
        without a flush are keyed `sent`. mixed: pts is the gathered affine
        (X, Y) pair (complete mixed adds, B5); else projective (B6)."""
        ops = self.ops
        W = skey.shape[0]
        keys2 = skey.reshape(W, Cs, Rs)
        pts2 = tree_map(lambda a: a.reshape(a.shape[:-1] + (Cs, Rs)), pts)
        acc = ops.identity_like(tree_map(lambda a: a[..., 0], pts2[0]))
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
        pass and a small log-scan over the <= nbuckets + C2 survivors."""
        C2 = max(128, min(1024, 1 << max(0, (m - 1).bit_length() - 5)))
        R2 = -(-m // C2)
        M2 = C2 * R2
        skey = _pad_last(skey, M2, sent)
        pts = tree_map(lambda a: _pad_last(a, M2), pts)
        fkeys, fpts = self._strip_flush(skey, pts, C2, R2, sent, mixed=False)
        K2 = min((R2 + 1) * C2, nbuckets + C2)
        ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K2]
        return self._log_scan_buckets(
            torch.gather(fkeys, -1, ridx), tree_map(lambda a: _take(a, ridx), fpts), K2, nbuckets, sent
        )

    def _small_weighted(self, vals, m: int):
        """sum_b b * vals[b] over the last axis (small m): suffix scan, then
        the sum of suffixes 1..m-1. Result in [..., :1]."""
        ops = self.ops
        iota = torch.arange(m, device=_dev(vals))
        for r in range((m - 1).bit_length()):
            d = 1 << r
            shifted = tree_map(lambda a: torch.roll(a, -d, dims=-1), vals)
            vals = ops.select(iota < m - d, ops.add(vals, shifted), vals)
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
        rows = tree_map(lambda a: a[..., 0], self._fold_sum(S, Bl))  # (.., k, Bh)
        cols = tree_map(lambda a: a.transpose(-1, -2), S)  # (.., k, Bl, Bh)
        cols = tree_map(lambda a: a[..., 0], self._fold_sum(cols, Bh))  # (.., k, Bl)
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


def _dev(pt) -> torch.device:
    while isinstance(pt, tuple):
        pt = pt[0]
    return pt.device

