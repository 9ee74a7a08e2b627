"""Radix-2 NTT over a Domain (counterpart of tpusnark/poly/ntt.py).

Arrays are ``(words, *batch, n)`` words with the domain axis last. The transform
is plain iterative DIT: a bit-reverse gather, then the stages in pairs
through the radix-4 butterfly (B4) and an odd last stage through the radix-2
butterfly (B3). Each butterfly works on flat ``(words, N)`` operands and a flat
twiddle row tiled across groups, the contract of tpusnark's ``_butterfly``
and ``_butterfly4``. tpusnark's four-step split and packed-table slicing
exist for the TPU's (8, 128) tiling and are not carried over; the packed
table layout (stage s at columns [2^s - 1, 2^(s+1) - 1)) is kept because it
makes each stage's twiddles one contiguous slice.

On CUDA tensors the butterflies are the kernels of ``csrc/ntt.cu`` for the
domain's field; on CPU tensors their plain versions below, built from the
field's plain ops.
"""

from __future__ import annotations

import functools

import torch

from tpusnark.fields.spec import FieldSpec
from tpusnark.poly.domain import Domain, bit_reverse_perm

from .. import kernels
from ..fields.tfield import _device_kind, _flat, canonical_device, get_field


class NTT:
    """NTT bound to (FieldSpec, n, device); twiddle tables live on `device`."""

    def __init__(self, spec: FieldSpec, n: int, device="cpu"):
        self.spec = spec
        self.n = n
        self.k = n.bit_length() - 1
        self.device = canonical_device(device)
        self.field = f = get_field(spec)
        self.domain = d = Domain(spec, n)
        p = spec.modulus
        if n > 1:

            def packed(base):
                out = []
                for s in range(self.k):
                    step = pow(base, n >> (s + 1), p)
                    v = 1
                    for _ in range(1 << s):
                        out.append(v)
                        v = v * step % p
                return out

            self._tw_fwd = f.encode(packed(d.generator), device=device)
            self._tw_inv = f.encode(packed(d.generator_inv), device=device)
            self._bitrev = torch.from_numpy(bit_reverse_perm(n)).to(device)
        self._n_inv = f.const(d.n_inv, mont=True, device=device)
        self._coset = None

    def _coset_tables(self):
        if self._coset is None:
            f, d = self.field, self.domain
            self._coset = (
                f.encode(d.coset_powers(inv=False), device=self.device),
                f.encode(d.coset_powers(inv=True), device=self.device),
            )
        return self._coset

    # ------------------------------------------------------------ butterflies
    def butterfly(self, e, o, w):
        """B3: (e + o*w, e - o*w) on flat (words, N) tensors."""
        if _device_kind(e, o, w) == "cuda":
            return kernels.butterfly(self.spec, e, o, w)
        return self.butterfly_plain(e, o, w)

    def butterfly_plain(self, e, o, w):
        f = self.field
        t = f.mul(o, w)
        return f.add(e, t), f.sub(e, t)

    def butterfly4(self, x0, x1, x2, x3, w1, w2a, w2b):
        """B4: two DIT stages; returns (y0+u2, y1+u3, y0-u2, y1-u3)."""
        if _device_kind(x0, x1, x2, x3, w1, w2a, w2b) == "cuda":
            return kernels.butterfly4(self.spec, x0, x1, x2, x3, w1, w2a, w2b)
        return self.butterfly4_plain(x0, x1, x2, x3, w1, w2a, w2b)

    def butterfly4_plain(self, x0, x1, x2, x3, w1, w2a, w2b):
        f = self.field
        t1 = f.mul(x1, w1)
        t3 = f.mul(x3, w1)
        y0, y1 = f.add(x0, t1), f.sub(x0, t1)
        y2, y3 = f.add(x2, t3), f.sub(x2, t3)
        u2 = f.mul(y2, w2a)
        u3 = f.mul(y3, w2b)
        return f.add(y0, u2), f.add(y1, u3), f.sub(y0, u2), f.sub(y1, u3)

    # ------------------------------------------------------------ stages
    def _stages(self, x, table):
        """DIT stages over the last axis of a bit-reversed x (words, *batch, n).

        Stage s (half = 2^s) pairs positions q and q + half inside blocks of
        2^(s+1) with twiddle w^((q mod half) * n / 2^(s+1))."""
        n, L = self.n, self.field.n
        lead = tuple(x.shape[1:-1])
        x = x.reshape(L, -1, n)
        B = x.shape[1]

        def tile(w, groups, half):
            return w.reshape(L, 1, 1, half).expand(L, B, groups, half).reshape(L, -1).contiguous()

        s = 0
        while s + 1 < self.k:
            half = 1 << s
            groups = n // (4 * half)
            v = x.reshape(L, B, groups, 4, half)
            xs = [_flat(v[:, :, :, i, :]) for i in range(4)]
            w1 = table[:, half - 1 : 2 * half - 1]
            w2 = table[:, 2 * half - 1 : 4 * half - 1]
            outs = self.butterfly4(
                *xs,
                tile(w1, groups, half),
                tile(w2[:, :half], groups, half),
                tile(w2[:, half:], groups, half),
            )
            x = torch.stack([o.view(L, B, groups, half) for o in outs], dim=3).reshape(L, B, n)
            s += 2
        if s < self.k:
            half = 1 << s
            groups = n // (2 * half)
            v = x.reshape(L, B, groups, 2, half)
            a, b = self.butterfly(
                _flat(v[:, :, :, 0, :]),
                _flat(v[:, :, :, 1, :]),
                tile(table[:, half - 1 : 2 * half - 1], groups, half),
            )
            x = torch.stack(
                [a.view(L, B, groups, half), b.view(L, B, groups, half)], dim=3
            ).reshape(L, B, n)
        return x.reshape((L,) + lead + (n,))

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


def get_ntt(spec: FieldSpec, n: int, device="cpu") -> NTT:
    return _get_ntt(spec, n, str(canonical_device(device)))
