"""Batched elliptic-curve arithmetic on torch tensors (G1 over Fp, G2 over
Fp2 = Fp[u]/(u^2 + q)).

Counterpart of ``tpusnark/curves/jcurve.py``: Renes-Costello-Batina complete
projective formulas for a = 0, identity (0 : 1 : 0). Coordinates are field
elements ``(words, *batch)`` (G2: ``(c0, c1)`` tuples of them); points are
``(X, Y, Z)`` tuples and affine points ``(X, Y, inf)`` with ``inf`` a bool
``(*batch,)`` mask.

``CurveOps`` composes the group law from field operations; on CPU tensors
it is the plain version of the two curve kernels. ``KernelCurveOps`` (in place
of tpusnark's ``FusedCurveOps``) sends ``add`` and ``add_mixed`` of CUDA
tensors to the curve's kernels (``csrc/curve_<curve>.cu``) and everything on
the CPU to ``CurveOps``. ``curve_ops(name)`` builds both groups from
tpusnark's ``CurveConfig``.
"""

from __future__ import annotations

import torch

from tpusnark.curves.config import get_curve

from .. import kernels
from ..fields.tfield import Field, _flat, get_field


class FpArith:
    """Adapter giving CurveOps a uniform field interface over Fp."""

    def __init__(self, field: Field, b: int):
        self.f = field
        self.b = b
        self.b3 = 3 * b

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mul(a, b)

    def neg(self, a):
        return self.f.neg(a)

    # stacked ops: k independent field ops as one op on a k-times-wider batch
    def stack(self, xs):
        return torch.stack(torch.broadcast_tensors(*xs), dim=1)

    def unstack(self, x, k: int):
        return [x[:, i] for i in range(k)]

    def _many(self, op, pairs):
        A = self.stack([a for a, _ in pairs])
        B = self.stack([b for _, b in pairs])
        return self.unstack(op(A, B), len(pairs))

    def mul_many(self, pairs):
        return self._many(self.f.mul, pairs)

    def add_many(self, pairs):
        return self._many(self.f.add, pairs)

    def sub_many(self, pairs):
        return self._many(self.f.sub, pairs)

    def mul_b3(self, x):
        # 3b = 9 (BN254 G1): 9x = 8x + x; else a Montgomery product by 3b
        if self.b3 == 9:
            x2 = self.f.add(x, x)
            x4 = self.f.add(x2, x2)
            x8 = self.f.add(x4, x4)
            return self.f.add(x8, x)
        return self.f.mul_const(x, self.b3)

    def mul_b3_many(self, xs):
        return self.unstack(self.mul_b3(self.stack(xs)), len(xs))

    def select(self, cond, a, b):
        return torch.where(cond, a, b)

    def zero_like(self, x):
        return torch.zeros_like(x)

    def one_like(self, x):
        return self.f.broadcast_const(self.f.one(x.device), x)

    def is_zero(self, x):
        return self.f.is_zero(x)

    def components(self, x):
        return [x]

    def from_components(self, cs):
        return cs[0]


def small_mul(f: Field, x, k: int):
    """k * x for a small host int k >= 1 by lazy double-and-add, in the
    order of jcurve._small_mul."""
    acc, addend = None, x
    while k:
        if k & 1:
            acc = addend if acc is None else f.add(acc, addend)
        k >>= 1
        if k:
            addend = f.add(addend, addend)
    return acc


class Fp2Arith:
    """Fp2 = Fp[u]/(u^2 + q); elements are (c0, c1) tuples of Fp tensors.

    q = 1 for BN254 and BLS12-381 (u^2 = -1), 5 for BLS12-377."""

    def __init__(self, field: Field, b3_fp2: tuple[int, int], q: int):
        if not 1 <= q <= 16:
            raise ValueError("a small nonresidue q is expected")
        self.f = field
        self._b3 = b3_fp2  # (c0, c1) python ints, normal form
        self.q = q

    def add(self, a, b):
        return (self.f.add(a[0], b[0]), self.f.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.f.sub(a[0], b[0]), self.f.sub(a[1], b[1]))

    def neg(self, a):
        return (self.f.neg(a[0]), self.f.neg(a[1]))

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def stack(self, xs):
        return (
            torch.stack(torch.broadcast_tensors(*[x[0] for x in xs]), dim=1),
            torch.stack(torch.broadcast_tensors(*[x[1] for x in xs]), dim=1),
        )

    def unstack(self, x, k: int):
        return [(x[0][:, i], x[1][:, i]) for i in range(k)]

    def mul_many(self, pairs):
        """Karatsuba, stacked: k Fp2 muls as one Fp mul of 3k lanes."""
        f = self.f
        k = len(pairs)
        a0, a1 = self.stack([a for a, _ in pairs])
        b0, b1 = self.stack([b for _, b in pairs])
        asum = f.add(a0, a1)
        bsum = f.add(b0, b1)
        A, B = torch.broadcast_tensors(
            torch.cat([a0, a1, asum], dim=1), torch.cat([b0, b1, bsum], dim=1)
        )
        T = f.mul(A, B)
        t0, t1, t2 = T[:, :k], T[:, k : 2 * k], T[:, 2 * k :]
        c0 = f.sub(t0, small_mul(f, t1, self.q))
        c1 = f.sub(t2, f.add(t0, t1))
        return [(c0[:, i], c1[:, i]) for i in range(k)]

    def add_many(self, pairs):
        return [self.add(a, b) for a, b in pairs]

    def sub_many(self, pairs):
        return [self.sub(a, b) for a, b in pairs]

    def b3_const(self, device):
        f = self.f
        return (
            f.const(self._b3[0], mont=True, device=device),
            f.const(self._b3[1], mont=True, device=device),
        )

    def mul_b3(self, x):
        return self.mul_b3_many([x])[0]

    def mul_b3_many(self, xs):
        f = self.f
        b0, b1 = self.b3_const(xs[0][0].device)
        consts = [(f.broadcast_const(b0, x[0]), f.broadcast_const(b1, x[1])) for x in xs]
        return self.mul_many(list(zip(xs, consts)))

    def select(self, cond, a, b):
        return (torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1]))

    def zero_like(self, x):
        return (torch.zeros_like(x[0]), torch.zeros_like(x[1]))

    def one_like(self, x):
        one = self.f.broadcast_const(self.f.one(x[0].device), x[0])
        return (one, torch.zeros_like(x[1]))

    def is_zero(self, x):
        return self.f.is_zero(x[0]) & self.f.is_zero(x[1])

    def components(self, x):
        return [x[0], x[1]]

    def from_components(self, cs):
        return (cs[0], cs[1])


class CurveOps:
    """Complete projective group law over an arithmetic adapter."""

    def __init__(self, fa):
        self.fa = fa

    def identity_like(self, coord):
        fa = self.fa
        return (fa.zero_like(coord), fa.one_like(coord), fa.zero_like(coord))

    # RCB15 algorithm 7 (a = 0), stacked like jcurve.CurveOps.add
    def add(self, p, q):
        fa = self.fa
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        s1 = fa.add_many([(X1, Y1), (Y1, Z1), (X1, Z1)])
        s2 = fa.add_many([(X2, Y2), (Y2, Z2), (X2, Z2)])
        t0, t1, t2, m3, m4, m5 = fa.mul_many(
            [(X1, X2), (Y1, Y2), (Z1, Z2), (s1[0], s2[0]), (s1[1], s2[1]), (s1[2], s2[2])]
        )
        t01, t12, t02 = fa.add_many([(t0, t1), (t1, t2), (t0, t2)])
        t3, t4, y3p = fa.sub_many([(m3, t01), (m4, t12), (m5, t02)])
        x3 = fa.add(t0, t0)
        t0n = fa.add(x3, t0)
        t2b, y3b = fa.mul_b3_many([t2, y3p])
        z3 = fa.add(t1, t2b)
        t1n = fa.sub(t1, t2b)
        r = fa.mul_many([(t4, y3b), (t3, t1n), (y3b, t0n), (t1n, z3), (t0n, t3), (z3, t4)])
        x3 = fa.sub(r[1], r[0])
        y3, z3 = fa.add_many([(r[3], r[2]), (r[5], r[4])])
        return (x3, y3, z3)

    # RCB15 algorithm 8 (a = 0, Z2 = 1)
    def add_mixed(self, p, q_affine):
        """p + (x2, y2[, inf]); lanes with inf set return p."""
        fa = self.fa
        X1, Y1, Z1 = p
        if len(q_affine) == 3:
            X2, Y2, inf = q_affine
        else:
            (X2, Y2), inf = q_affine, None
        sx1, sx2 = fa.add_many([(X1, Y1), (X2, Y2)])
        t0, t1, m3, mt4, mt5 = fa.mul_many([(X1, X2), (Y1, Y2), (sx1, sx2), (X2, Z1), (Y2, Z1)])
        t01 = fa.add(t0, t1)
        t3 = fa.sub(m3, t01)
        t4, t5 = fa.add_many([(mt4, X1), (mt5, Y1)])
        z3b, y3b = fa.mul_b3_many([Z1, t4])
        x3 = fa.add(t0, t0)
        t0n = fa.add(x3, t0)
        z3 = fa.add(t1, z3b)
        t1n = fa.sub(t1, z3b)
        r = fa.mul_many([(t5, y3b), (t3, t1n), (y3b, t0n), (t1n, z3), (t0n, t3), (z3, t5)])
        x3 = fa.sub(r[1], r[0])
        y3, z3 = fa.add_many([(r[3], r[2]), (r[5], r[4])])
        out = (x3, y3, z3)
        if inf is not None:
            out = tuple(fa.select(inf, a, b) for a, b in zip(p, out))
        return out

    def double(self, p):
        return self.add(p, p)

    def neg(self, p):
        return (p[0], self.fa.neg(p[1]), p[2])

    def select(self, cond, p, q):
        return tuple(self.fa.select(cond, a, b) for a, b in zip(p, q))

    def from_affine(self, q_affine):
        """(x, y, inf) -> projective; inf lanes -> (0, 1, 0)."""
        fa = self.fa
        if len(q_affine) == 3:
            X, Y, inf = q_affine
        else:
            (X, Y), inf = q_affine, None
        p = (X, Y, fa.one_like(X))
        if inf is not None:
            p = self.select(inf, self.identity_like(X), p)
        return p


class KernelCurveOps(CurveOps):
    """CurveOps whose add and add_mixed run the hand-written kernels (B6, B5)
    on CUDA tensors and the plain CurveOps formulas on CPU tensors.

    Operands are broadcast to one batch shape and flattened to (words, N)
    around the kernel, as FusedCurveOps flattens around the TPU kernel. The
    kernels of a curve build in its G1 add chain (3b = 9) and its Fp2 q, so
    ops over a base field with kernels must carry that curve's constants; 3b
    itself goes to the kernel in Montgomery form."""

    def __init__(self, fa):
        super().__init__(fa)
        self.g2 = isinstance(fa, Fp2Arith)
        curve = kernels.curve_of(fa.f.spec)
        if curve is not None:
            cfg = get_curve(curve)
            if self.g2 and fa.q != cfg.fp2_q:
                raise ValueError(f"the {curve} G2 kernels are built for q = {cfg.fp2_q}")
            if not self.g2 and (fa.b3 == 9) != (3 * cfg.g1_b == 9):
                raise ValueError(f"the {curve} G1 kernels are built for 3b = {3 * cfg.g1_b}")
        self._b3_words = None

    def _b3(self):
        """The uint32 words of 3b (G1) or 3b' (G2: c0 then c1), Montgomery."""
        if self._b3_words is None:
            fa = self.fa
            consts = fa.b3_const("cpu") if self.g2 else (fa.f.const(fa.b3, mont=True),)
            words = torch.cat(consts).numpy().view("uint32")
            self._b3_words = [int(w) for w in words]
        return self._b3_words

    def _run(self, op, coords, inf=None):
        fa = self.fa
        comps = [c for x in coords for c in fa.components(x)]
        tensors = torch.broadcast_tensors(*comps)
        batch = tensors[0].shape[1:]
        flat = [_flat(t) for t in tensors]
        if inf is not None:
            inf = inf.expand(batch).reshape(-1).contiguous()
        outs = kernels.curve_op(op, self.g2, fa.f.spec, flat, self._b3(), inf=inf)
        outs = [o.view((o.shape[0],) + tuple(batch)) for o in outs]
        d = len(fa.components(coords[0]))
        return tuple(fa.from_components(outs[i * d : (i + 1) * d]) for i in range(3))

    def _on_cuda(self, p):
        return self.fa.components(p[0])[0].device.type == "cuda"

    def add(self, p, q):
        if self._on_cuda(p):
            return self._run("add", tuple(p) + tuple(q))
        return super().add(p, q)

    def add_mixed(self, p, q_affine):
        if self._on_cuda(p):
            if len(q_affine) == 3:
                X2, Y2, inf = q_affine
            else:
                (X2, Y2), inf = q_affine, None
            return self._run("add_mixed", tuple(p) + (X2, Y2), inf=inf)
        return super().add_mixed(p, q_affine)


def g1_ops(field_fp: Field, b: int) -> KernelCurveOps:
    """G1: y^2 = x^3 + b over field_fp."""
    return KernelCurveOps(FpArith(field_fp, b=b))


def g2_ops(field_fp: Field, b3: tuple[int, int], q: int) -> KernelCurveOps:
    """G2 over Fp[u]/(u^2 + q), with 3b' = b3 = (c0, c1)."""
    return KernelCurveOps(Fp2Arith(field_fp, tuple(b3), q))


def curve_ops(name: str) -> tuple[KernelCurveOps, KernelCurveOps]:
    """(G1, G2) ops of a curve with G2 over Fp2, from tpusnark's CurveConfig."""
    cfg = get_curve(name)
    if cfg.g2_over_fp or cfg.g2_fp4:
        raise NotImplementedError(f"curve {name}: G2 over Fp or Fp4 is not ported yet")
    fp = get_field(cfg.fp_spec)
    return g1_ops(fp, cfg.g1_b), g2_ops(fp, cfg.g2_b3, cfg.fp2_q)
