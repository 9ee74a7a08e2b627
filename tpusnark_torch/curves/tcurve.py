"""Batched elliptic-curve arithmetic on torch tensors (G1 over Fp; G2 over
Fp2 = Fp[u]/(u^2 + q), over Fp4 = Fp2[v]/(v^2 - Z2) for the BLS24 curves, or
over Fp itself for the BW6 curves).

Counterpart of ``tpusnark/curves/jcurve.py``: Renes-Costello-Batina complete
projective formulas for a = 0, identity (0 : 1 : 0). Coordinates are field
elements ``(words, *batch)`` (G2: ``(c0, c1)`` tuples of them, over Fp4
``((c00, c01), (c10, c11))``); points are
``(X, Y, Z)`` tuples and affine points ``(X, Y, inf)`` with ``inf`` a bool
``(*batch,)`` mask.

``CurveOps`` composes the group law from field operations; on CPU tensors
it is the plain version of the two curve kernels. ``KernelCurveOps`` (in place
of tpusnark's ``FusedCurveOps``) sends ``add`` and ``add_mixed`` of CUDA
tensors to the curve's kernels (``csrc/curve_<curve>.cu``) and everything on
the CPU to ``CurveOps``. It also gives the MSM its fused kernels
(``csrc/msm.cuh``: ``strip_mixed``, ``strip``, ``scan_step``, ``horner``),
which take CUDA tensors only: their plain versions are the MSM's own loops
over ``CurveOps`` (``msm/pippenger.py``). ``curve_ops(name)`` builds both
groups from the curve's ``CurveConfig``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields.tfield import Field, _flat, get_field
from .config import get_curve


class FpArith:
    """Adapter giving CurveOps a uniform field interface over Fp."""

    degree = 1  # base-field components of an element

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
        # (mod p: BW6-761's G1 has b = -1)
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


def _componentwise(fa, op, pairs):
    """k componentwise ops over Fp4 as one Fp op on a stack of all their
    components: one launch, or one pass of the plain version, where the
    tower would take 4k."""
    d = fa.degree
    As = [c for a, _ in pairs for c in fa.components(a)]
    Bs = [c for _, b in pairs for c in fa.components(b)]
    flat = torch.broadcast_tensors(*As, *Bs)
    out = op(torch.stack(flat[: len(As)], dim=1), torch.stack(flat[len(As) :], dim=1))
    return [fa.from_components([out[:, d * i + j] for j in range(d)]) for i in range(len(pairs))]


class Fp2Arith:
    """Fp2 = Fp[u]/(u^2 + q); elements are (c0, c1) tuples of Fp tensors.

    q = 1 for BN254, BLS12-381 and BLS24-317 (u^2 = -1), 5 for BLS12-377, 13
    for BLS24-315."""

    degree = 2

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


class Fp4Arith:
    """Fp4 = Fp2[v]/(v^2 - Z2) over Fp2 = Fp[u]/(u^2 - a2); elements are
    (c0, c1) tuples of Fp2 elements: ((c00, c01), (c10, c11)). The G2
    coordinate field of the BLS24 curves (tpusnark's jcurve.Fp4Arith):
    a2 = -13, Z2 = u for BLS24-315; a2 = -1, Z2 = 1 + u for BLS24-317. The
    product is Karatsuba over Fp2.mul_many, so one Fp4 product is three Fp2
    products is nine Fp products, and Z2 * x is an add chain."""

    degree = 4

    def __init__(self, field: Field, b3_fp4: tuple, a2: int, z2: tuple[int, int]):
        if a2 >= 0:
            raise ValueError("u^2 = a2 with a2 < 0 expected")
        self.f2 = Fp2Arith(field, (0, 0), q=-a2)
        self.f = field
        self.z2 = tuple(z2)
        self._b3 = b3_fp4  # ((c00, c01), (c10, c11)) python ints, normal form

    def _mul_z2(self, x):
        """x * Z2 over Fp2 for the small constant Z2 = z0 + z1 u, in the order
        of jcurve.Fp4Arith._mul_z2: (c0 + c1 u)(z0 + z1 u) = (z0 c0 - q z1 c1)
        + (z0 c1 + z1 c0) u."""
        f, (z0, z1), q = self.f, self.z2, self.f2.q
        c0, c1 = x
        r0s, r1s = [], []
        if z0:
            r0s.append(small_mul(f, c0, z0))
            r1s.append(small_mul(f, c1, z0))
        if z1:
            r0s.append(f.neg(small_mul(f, c1, q * z1)))
            r1s.append(small_mul(f, c0, z1))
        r0 = r0s[0] if len(r0s) == 1 else f.add(*r0s)
        r1 = r1s[0] if len(r1s) == 1 else f.add(*r1s)
        return (r0, r1)

    def add(self, a, b):
        return self.add_many([(a, b)])[0]

    def sub(self, a, b):
        return self.sub_many([(a, b)])[0]

    def neg(self, a):
        return (self.f2.neg(a[0]), self.f2.neg(a[1]))

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def stack(self, xs):
        return (self.f2.stack([x[0] for x in xs]), self.f2.stack([x[1] for x in xs]))

    def unstack(self, x, k: int):
        return list(zip(self.f2.unstack(x[0], k), self.f2.unstack(x[1], k)))

    def mul_many(self, pairs):
        """Karatsuba, stacked: k Fp4 products as one Fp2.mul_many of 3k."""
        f2 = self.f2
        k = len(pairs)
        a0, a1 = self.stack([a for a, _ in pairs])
        b0, b1 = self.stack([b for _, b in pairs])
        asum, bsum = f2.add_many([(a0, a1), (b0, b1)])
        t0, t1, t2 = f2.mul_many([(a0, b0), (a1, b1), (asum, bsum)])
        c0 = f2.add(t0, self._mul_z2(t1))
        c1 = f2.sub(t2, f2.add(t0, t1))
        return self.unstack((c0, c1), k)

    def add_many(self, pairs):
        return _componentwise(self, self.f.add, pairs)

    def sub_many(self, pairs):
        return _componentwise(self, self.f.sub, pairs)

    def b3_const(self, device):
        """3b' in Montgomery form: (c00, c01, c10, c11) constants."""
        f = self.f
        return tuple(f.const(c, mont=True, device=device) for pair in self._b3 for c in pair)

    def mul_b3(self, x):
        return self.mul_b3_many([x])[0]

    def mul_b3_many(self, xs):
        f = self.f
        c00, c01, c10, c11 = self.b3_const(xs[0][0][0].device)
        consts = [
            (
                (f.broadcast_const(c00, x[0][0]), f.broadcast_const(c01, x[0][0])),
                (f.broadcast_const(c10, x[0][0]), f.broadcast_const(c11, x[0][0])),
            )
            for x in xs
        ]
        return self.mul_many(list(zip(xs, consts)))

    def select(self, cond, a, b):
        return (self.f2.select(cond, a[0], b[0]), self.f2.select(cond, a[1], b[1]))

    def zero_like(self, x):
        return (self.f2.zero_like(x[0]), self.f2.zero_like(x[1]))

    def one_like(self, x):
        return (self.f2.one_like(x[0]), self.f2.zero_like(x[1]))

    def is_zero(self, x):
        return self.f2.is_zero(x[0]) & self.f2.is_zero(x[1])

    def components(self, x):
        return [x[0][0], x[0][1], x[1][0], x[1][1]]

    def from_components(self, cs):
        return ((cs[0], cs[1]), (cs[2], cs[3]))


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
    around the kernel, as FusedCurveOps flattens around tpusnark's kernel.
    `group` ("g1" or "g2") names the kernel instances that are launched and
    counted; where G2 lies over Fp (the BW6 curves) it runs the Fp formulas
    with its own 3b. The kernels of a curve build in its G1 add chain (3b =
    9), its Fp2 q and its Fp4 a2 and Z2, so ops over a base field with
    kernels must carry that curve's constants; 3b itself goes to the kernel
    in Montgomery form."""

    def __init__(self, fa, group: str):
        super().__init__(fa)
        if group not in ("g1", "g2"):
            raise ValueError(f"unknown group {group}")
        self.group = group
        self.degree = fa.degree  # base-field components of a coordinate
        self.fp2, self.fp4 = self.degree == 2, self.degree == 4
        curve = kernels.curve_of(fa.f.spec)
        if curve is not None:
            cfg = get_curve(curve)
            if self.degree != (kernels.g2_degree(curve) if group == "g2" else 1):
                raise ValueError(f"the {curve} {group} kernels are not over {type(fa).__name__}")
            if self.fp2 and fa.q != cfg.fp2_q:
                raise ValueError(f"the {curve} G2 kernels are built for q = {cfg.fp2_q}")
            if self.fp4 and (-fa.f2.q, fa.z2) != (cfg.fp4_a2, cfg.fp4_z2):
                raise ValueError(f"the {curve} G2 kernels are built for a2 = {cfg.fp4_a2}, Z2 = {cfg.fp4_z2}")
            if group == "g1" and (fa.b3 == 9) != (3 * cfg.g1_b == 9):
                raise ValueError(f"the {curve} G1 kernels are built for 3b = {3 * cfg.g1_b}")
        self._b3_words = None
        self._fused = None

    def _b3(self):
        """The uint32 words of 3b (G1) or 3b' (G2: its components in order),
        Montgomery."""
        if self._b3_words is None:
            fa = self.fa
            consts = fa.b3_const("cpu") if self.degree > 1 else (fa.f.const(fa.b3, mont=True),)
            words = torch.cat(consts).numpy().view("uint32")
            self._b3_words = [int(w) for w in words]
        return self._b3_words

    def _components(self, coords):
        return [c for x in coords for c in self.fa.components(x)]

    def _point(self, comps):
        d = len(comps) // 3
        return tuple(self.fa.from_components(comps[i * d : (i + 1) * d]) for i in range(3))

    def _run(self, op, coords, inf=None):
        tensors = torch.broadcast_tensors(*self._components(coords))
        batch = tensors[0].shape[1:]
        flat = [_flat(t) for t in tensors]
        if inf is not None:
            inf = inf.expand(batch).reshape(-1).contiguous()
        outs = kernels.curve_op(op, self.group == "g2", self.fa.f.spec, flat, self._b3(), inf=inf)
        return self._point([o.view((o.shape[0],) + tuple(batch)) for o in outs])

    def _on_cuda(self, p):
        return self.fa.components(p[0])[0].device.type == "cuda"

    # ---- the MSM's fused kernels: CUDA tensors only
    def _msm_kernels(self) -> kernels.MsmKernels:
        """The group's fused kernels, with their launch block (3b and 1 in
        Montgomery form) built once."""
        if self._fused is None:
            f = self.fa.f
            one = f.one("cpu")
            ones = (one,) + (torch.zeros_like(one),) * (self.degree - 1)
            one_words = [int(w) for w in torch.cat(ones).numpy().view("uint32")]
            self._fused = kernels.MsmKernels(f.spec, self.group == "g2", self._b3(), one_words)
        return self._fused

    def strip_mixed(self, skey, order, sign, XY, n_records, C, R, dead, sent):
        """kernels.MsmKernels.strip_mixed over the affine bases XY = (X, Y),
        each (words, N0). The kernel gathers the bases in the sort's order, so
        it is handed a point-major image of them, (N0, components, words) with
        all words of a point contiguous, built here with one copy: a gathered
        point is then a few memory sectors, not one per word (1.05-2.1 times
        faster, see csrc/msm.cuh)."""
        comps = self._components(XY)
        image = torch.stack([c.t() for c in comps], dim=1).contiguous()
        views = [image[:, i, :].t() for i in range(len(comps))]
        fkeys, outs = self._msm_kernels().strip_mixed(skey, order, sign, views, n_records, C, R, dead, sent)
        return fkeys, self._point(outs)

    def strip(self, skey, pts, C, R, dead, sent):
        """kernels.MsmKernels.strip over sorted projective records, skey (W,
        C*R) and coordinates (words, W, C*R). A strip's rows are contiguous
        there, so the lanes of a warp would read 4R bytes apart: the kernel
        is handed a copy with a row's lanes side by side."""

        def by_rows(a):
            split = a.reshape(a.shape[:-1] + (C, R))
            return split.transpose(-1, -2).contiguous().transpose(-1, -2)

        comps = [by_rows(c) for c in self._components(pts)]
        fkeys, outs = self._msm_kernels().strip(by_rows(skey), comps, C, R, dead, sent)
        return fkeys, self._point(outs)

    def scan_step(self, pts, shift, width, key=None):
        """kernels.MsmKernels.scan_step along the last axis of pts."""
        return self._point(self._msm_kernels().scan_step(self._components(pts), shift, width, key))

    def horner(self, wsums, c):
        """kernels.MsmKernels.horner over window sums (words, W, k)."""
        return self._point(self._msm_kernels().horner(self._components(wsums), c))

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


def g1_ops(field_fp: Field, b: int, group: str = "g1") -> KernelCurveOps:
    """y^2 = x^3 + b over field_fp: G1, or with group = "g2" a G2 that lies
    over Fp itself (the BW6 curves' sextic twists)."""
    return KernelCurveOps(FpArith(field_fp, b=b), group)


def g2_ops(field_fp: Field, b3: tuple[int, int], q: int) -> KernelCurveOps:
    """G2 over Fp[u]/(u^2 + q), with 3b' = b3 = (c0, c1)."""
    return KernelCurveOps(Fp2Arith(field_fp, tuple(b3), q), "g2")


def g2_ops_fp4(field_fp: Field, b3_fp4: tuple, a2: int, z2: tuple[int, int]) -> KernelCurveOps:
    """G2 over Fp4 = Fp2[v]/(v^2 - z2), Fp2 = Fp[u]/(u^2 - a2), with 3b' =
    b3_fp4 = ((c00, c01), (c10, c11))."""
    return KernelCurveOps(Fp4Arith(field_fp, b3_fp4, a2, z2), "g2")


def curve_ops(name: str) -> tuple[KernelCurveOps, KernelCurveOps]:
    """(G1, G2) ops of a curve, G2 over Fp2, Fp4 or Fp, from its
    CurveConfig."""
    cfg = get_curve(name)
    fp = get_field(cfg.fp_spec)
    if cfg.g2_fp4:
        return g1_ops(fp, cfg.g1_b), g2_ops_fp4(fp, cfg.g2_b3_fp4, cfg.fp4_a2, cfg.fp4_z2)
    if cfg.g2_over_fp:
        return g1_ops(fp, cfg.g1_b), g1_ops(fp, cfg.g2_b, group="g2")
    return g1_ops(fp, cfg.g1_b), g2_ops(fp, cfg.g2_b3, cfg.fp2_q)
