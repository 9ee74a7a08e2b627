"""Radix-2 NTT over a Domain (counterpart of tpusnark/poly/ntt.py).

Arrays are ``(words, *batch, n)`` words with the domain axis last. The transform
is iterative DIT: a bit-reverse gather, then the k = log2(n) stages in a few
passes (``pass_plan``). A pass runs stages s0 .. s0+m-1, which touch only the
2^m elements base + t * 2^s0 of a group, so it is a set of independent groups:
on CUDA tensors one launch of ``csrc/ntt.cu``'s ``k_ntt_stages``, which keeps
a block's groups in shared memory and runs their stages in pairs through the
radix-4 butterfly (B4) and an odd last one through the radix-2 butterfly (B3);
on CPU tensors ``ntt_stages_plain``, the same stages out of the field's plain
ops. A pass holds at most ``max_stages(words)`` stages, set by the shared
memory a block may use, so a 2^17 or a 2^22 transform is 3 passes.

The twiddles stay tpusnark's packed table (stage s at columns [2^s - 1,
2^(s+1) - 1), w^(j * n / 2^(s+1)) for j < 2^s), read straight from it;
tpusnark's four-step split exists for the TPU's (8, 128) tiling and is not
carried over. The tables are built on the device of the NTT from a few host
constants: the powers w^j, j < n/2, by doubling (one product a doubling),
then each stage's slice at stride n / 2^(s+1); the coset powers the same way;
the bit-reversal permutation from an arange.

``butterfly`` and ``butterfly4`` are B3 and B4 pointwise, on flat
``(words, N)`` operands and twiddle rows: no transform runs them, and they
stay as kernels held against their plain versions.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..fields.spec import FieldSpec
from ..fields.tfield import _device_kind, compute_device, get_field
from .domain import Domain


def max_stages(words: int) -> int:
    """The most stages one pass runs for a field of `words` words: a block
    holds kernels.ntt_block_elems(words) elements in shared memory, and a
    pass past the first keeps at least two groups a block, so that its loads
    and stores run over at least 8 bytes of adjacent words."""
    return kernels.ntt_block_elems(words).bit_length() - 2


def bit_reverse_index(k: int, device) -> torch.Tensor:
    """The bit-reversal permutation of 2^k positions (domain.bit_reverse_perm),
    built on `device` like the tables."""
    idx = torch.arange(1 << k, device=device)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def pass_plan(k: int, cap: int) -> list[tuple[int, int]]:
    """Stages 0 .. k-1 in the fewest passes (s0, m) of at most `cap` stages
    each, in order, balanced: the first k mod passes get one stage more."""
    if k <= 0:
        return []
    passes = -(-k // cap)
    plan, s0 = [], 0
    for i in range(passes):
        m = k // passes + (i < k % passes)
        plan.append((s0, m))
        s0 += m
    return plan


class NTT:
    """NTT bound to (FieldSpec, n, device); twiddle tables live on `device`:
    the card, unless the caller names the CPU."""

    def __init__(self, spec: FieldSpec, n: int, device="cuda"):
        self.spec = spec
        self.n = n
        self.k = n.bit_length() - 1
        self.device = device = compute_device(device)
        self.field = f = get_field(spec)
        self.domain = d = Domain(spec, n)
        self.plan = pass_plan(self.k, max_stages(f.n))
        if n > 1:
            self._tw_fwd = self.packed_twiddles(d.generator)
            self._tw_inv = self.packed_twiddles(d.generator_inv)
            self._bitrev = bit_reverse_index(self.k, device)
        self._n_inv = f.const(d.n_inv, mont=True, device=device)
        self._coset = None

    # ------------------------------------------------------------ tables
    def powers(self, base: int, count: int) -> torch.Tensor:
        """base^j for j < count (a power of two), (words, count) Montgomery
        words on the NTT's device: from [1], each doubling appends the row
        so far times base^len (one product). Only the seeds base^(2^i) are
        encoded on the host."""
        f, p = self.field, self.spec.modulus
        doublings = count.bit_length() - 1
        seeds = f.encode([1] + [pow(base, 1 << i, p) for i in range(doublings)], device=self.device)
        row = seeds[:, :1]
        for i in range(doublings):
            row = torch.cat([row, f.mul(row, f.broadcast_const(seeds[:, i + 1], row))], dim=1)
        return row

    def packed_twiddles(self, w: int) -> torch.Tensor:
        """The packed table (words, n - 1) of the n-th root w: stage s at
        columns [2^s - 1, 2^(s+1) - 1) holds w^(j * n / 2^(s+1)), j < 2^s,
        the powers of w at stride n / 2^(s+1)."""
        k, dev = self.k, self.device
        cols = torch.cat([torch.arange(1 << s, device=dev) << (k - 1 - s) for s in range(k)])
        return self.powers(w, self.n // 2).index_select(1, cols)

    def _coset_tables(self):
        if self._coset is None:
            d = self.domain
            self._coset = (self.powers(d.coset_shift, self.n), self.powers(d.coset_shift_inv, self.n))
        return self._coset

    # ------------------------------------------------------------ butterflies
    def butterfly(self, e, o, w):
        """B3: (e + o*w, e - o*w) on flat (words, N) tensors."""
        if _device_kind(e, o, w) == "cuda":
            return kernels.butterfly(self.spec, e, o, w)
        return self.butterfly_plain(e, o, w)

    def butterfly_plain(self, e, o, w):
        f = self.field
        t = f.mul_plain(o, w)
        return f.add_plain(e, t), f.sub_plain(e, t)

    def butterfly4(self, x0, x1, x2, x3, w1, w2a, w2b):
        """B4: two DIT stages; returns (y0+u2, y1+u3, y0-u2, y1-u3)."""
        if _device_kind(x0, x1, x2, x3, w1, w2a, w2b) == "cuda":
            return kernels.butterfly4(self.spec, x0, x1, x2, x3, w1, w2a, w2b)
        return self.butterfly4_plain(x0, x1, x2, x3, w1, w2a, w2b)

    def butterfly4_plain(self, x0, x1, x2, x3, w1, w2a, w2b):
        y0, y1 = self.butterfly_plain(x0, x1, w1)
        y2, y3 = self.butterfly_plain(x2, x3, w1)
        (z0, z2), (z1, z3) = self.butterfly_plain(y0, y2, w2a), self.butterfly_plain(y1, y3, w2b)
        return z0, z1, z2, z3

    # ------------------------------------------------------------ passes
    def ntt_stages(self, x, table, s0: int, m: int, out=None):
        """DIT stages s0 .. s0+m-1 over the last axis of bit-reversed x
        (words, *batch, n): stage s (half = 2^s) pairs positions q and
        q + half inside blocks of 2^(s+1) with twiddle table column
        half - 1 + (q mod half). One launch of the pass kernel on the card
        (into `out`, which may be x), the plain version on the CPU."""
        if _device_kind(x, table) == "cuda":
            flat = x.reshape(x.shape[0], -1)
            dst = None if out is None else out.view(flat.shape)
            return kernels.ntt_stages(self.spec, flat, table, self.n, s0, m, dst).view(x.shape)
        return self.ntt_stages_plain(x, table, s0, m)

    def ntt_stages_plain(self, x, table, s0: int, m: int):
        """The pass out of the field's plain ops: the stages in pairs through
        B4's step and an odd last one through B3's, as the kernel runs them."""
        L = self.field.n
        y = x.reshape(L, -1)
        s, end = s0, s0 + m
        while s < end:
            half = 1 << s
            w1 = table[:, half - 1 : 2 * half - 1].reshape(L, 1, half)
            if s + 1 < end:
                v = y.reshape(L, -1, 4, half).unbind(2)
                w2 = table[:, 2 * half - 1 : 4 * half - 1].reshape(L, 1, 2, half).unbind(2)
                y = torch.stack(self.butterfly4_plain(*v, w1, *w2), dim=2)
                s += 2
            else:
                y = torch.stack(self.butterfly_plain(*y.reshape(L, -1, 2, half).unbind(2), w1), dim=2)
                s += 1
        return y.reshape(x.shape)

    def _stages(self, x, table):
        """All k stages of bit-reversed x, pass by pass in place (x is the
        gather's own tensor)."""
        for s0, m in self.plan:
            x = self.ntt_stages(x, table, s0, m, out=x)
        return x

    def _bcast_table(self, tbl, x):
        return tbl.reshape((self.field.n,) + (1,) * (x.dim() - 2) + (self.n,))

    # ------------------------------------------------------------ entry points
    def ntt(self, x):
        """coefficients -> evaluations on the subgroup (natural order)."""
        if self.n == 1:
            return x
        return self._stages(x.index_select(-1, self._bitrev), self._tw_fwd)

    def intt(self, x):
        """evaluations (natural order) -> coefficients."""
        if self.n == 1:
            return x
        f = self.field
        y = self._stages(x.index_select(-1, self._bitrev), self._tw_inv)
        return f.mul(y, f.broadcast_const(self._n_inv, y))

    def coset_scale(self, x, inv: bool = False):
        """Multiply coefficient i by shift^i (or shift^-i)."""
        cs, csi = self._coset_tables()
        return self.field.mul(x, self._bcast_table(csi if inv else cs, x))

    def ntt_coset(self, x):
        """coefficients -> evaluations on the coset shift*<w>."""
        if self.n == 1:
            return x
        return self.ntt(self.coset_scale(x))

    def intt_coset(self, x):
        """evaluations on the coset -> coefficients."""
        if self.n == 1:
            return x
        return self.coset_scale(self.intt(x), inv=True)


@functools.lru_cache(maxsize=None)
def _get_ntt(spec: FieldSpec, n: int, device: str) -> NTT:
    return NTT(spec, n, device)


def get_ntt(spec: FieldSpec, n: int, device="cuda") -> NTT:
    """The NTT of (spec, n) on `device` (the card unless the caller names the
    CPU), cached per device."""
    return _get_ntt(spec, n, str(compute_device(device)))
