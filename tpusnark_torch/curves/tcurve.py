"""Batched elliptic-curve arithmetic on torch tensors (BN254 G1 and G2).

Counterpart of ``tpusnark/curves/jcurve.py``: Renes-Costello-Batina complete
projective formulas for a = 0, identity (0 : 1 : 0). Coordinates are field
elements ``(8, *batch)`` (G2: ``(c0, c1)`` tuples of them); points are
``(X, Y, Z)`` tuples and affine points ``(X, Y, inf)`` with ``inf`` a bool
``(*batch,)`` mask.

``CurveOps`` composes the group law from field operations; on CPU tensors
it is the plain version of the two curve kernels. ``KernelCurveOps`` (in place
of tpusnark's ``FusedCurveOps``) sends ``add`` and ``add_mixed`` of CUDA
tensors to ``csrc/curve.cu`` and everything on the CPU to ``CurveOps``.
"""

from __future__ import annotations

import torch

from ..fields.tfield import Field, _flat
from .. import kernels


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
        # 3b = 9 for BN254 G1: 9x = 8x + x
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


class Fp2Arith:
    """Fp2 = Fp[u]/(u^2 + 1); elements are (c0, c1) tuples of Fp tensors."""

    def __init__(self, field: Field, b3_fp2: tuple[int, int]):
        self.f = field
        self._b3 = b3_fp2  # (c0, c1) python ints, normal form

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
        c0 = f.sub(t0, t1)
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

    Operands are broadcast to one batch shape and flattened to (8, N) around
    the kernel, as FusedCurveOps flattens around the TPU kernel."""

    def __init__(self, fa):
        super().__init__(fa)
        self.g2 = isinstance(fa, Fp2Arith)
        if not self.g2 and fa.b3 != 9:
            raise ValueError("the G1 kernel is specialised to 3b = 9 (BN254)")
        self._b3_words = None

    def _b3(self, device):
        if not self.g2:
            return None
        if self._b3_words is None:
            b0, b1 = self.fa.b3_const("cpu")
            words = torch.cat([b0, b1]).numpy().view("uint32")
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
        outs = kernels.curve_op(op, self.g2, flat, inf=inf, b3_words=self._b3(flat[0].device))
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


def _g2_b3() -> tuple[int, int]:
    # BN254: b' = 3/(9+u); 3b' as an Fp2 constant (jcurve._g2_b3)
    from tpusnark.curves.ref import XI, Fp2 as RefFp2

    b3 = RefFp2(3, 0) * XI.inv() * 3
    return (b3.c0, b3.c1)


def g1_ops(field_fp: Field, b: int = 3) -> KernelCurveOps:
    return KernelCurveOps(FpArith(field_fp, b=b))


def g2_ops(field_fp: Field) -> KernelCurveOps:
    return KernelCurveOps(Fp2Arith(field_fp, _g2_b3()))
