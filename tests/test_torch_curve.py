"""The port's group law (tpusnark_torch.curves.tcurve, plain versions on the
CPU) against tpusnark's CurveOps (JAX on the CPU) and the curve's host module
(tpusnark.curves.ref for BN254; tpusnark.curves.bls12381 for BLS12-381: G1
with 3b = 12, G2 with 3b' = (12, 12) over u^2 = -1; tpusnark.curves.bls12377
for BLS12-377: G1 with 3b = 3, G2 with 3b' = (0, -3/5) over u^2 = -5;
tpusnark.curves.bw6761 for BW6-761: 24-word coordinates, G1 with 3b = -3 and
G2 over Fp itself with 3b = 12), on the same seeded points. Exact: projective outputs are compared with tpusnark's coordinate
by coordinate as ints mod p, and their affine values with the host module."""

import numpy as np
import pytest
import torch

from tpusnark.curves import bls12381
from tpusnark.curves import encoding as jenc
from tpusnark.curves import ref
from tpusnark.curves.config import get_curve
from tpusnark.curves.jcurve import g1_ops as jg1_ops
from tpusnark.curves.jcurve import g2_ops as jg2_ops
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BN254_FP
from tpusnark_torch.convert import from_torch, to_torch
from tpusnark_torch.curves.encoding import (
    g1_from_device_proj,
    g1_to_device,
    g2_from_device_proj,
    g2_to_device,
)
from tpusnark_torch.curves.tcurve import curve_ops, g1_ops, g2_ops
from tpusnark_torch.fields.tfield import get_field

torch.set_num_threads(1)  # the suite's workers fill the cores already

CURVES = ("bn254", "bls12-381", "bls12-377", "bw6-761")
CASES = [(c, g) for c in CURVES for g in ("g1", "g2")]


class Curve:
    """One curve and group on both sides: host module, port and tpusnark
    ops, encoders and decoders."""

    def __init__(self, name, group):
        cfg = get_curve(name)
        # g2: coordinates in Fp2; BW6-761's G2 lies over Fp and takes the
        # G1 layout, encoders and formulas with b = g2_b
        self.cfg, self.g2 = cfg, group == "g2" and not cfg.g2_over_fp
        self.host = cfg.host
        self.G = cfg.host.G2 if group == "g2" else cfg.host.G1
        self.P, self.R = cfg.fp_spec.modulus, cfg.host.R
        self.fp, self.jfp = get_field(cfg.fp_spec), JField(cfg.fp_spec)
        self.ops = curve_ops(name)[int(group == "g2")]
        assert self.ops.group == group and self.ops.fp2 == self.g2
        if self.g2:
            self.jops = jg2_ops(self.jfp, b3=cfg.g2_b3, q=cfg.fp2_q)
        else:
            self.jops = jg1_ops(self.jfp, b=cfg.g2_b if group == "g2" else cfg.g1_b)

    def enc(self, pts):
        return (g2_to_device if self.g2 else g1_to_device)(pts, self.fp)

    def jenc(self, pts):
        return (jenc.g2_to_device if self.g2 else jenc.g1_to_device)(pts, self.jfp)

    def dec(self, pt):
        if self.g2:
            return g2_from_device_proj(pt, self.fp, self.host.Fp2, self.cfg.fp2_q)
        return g1_from_device_proj(pt, self.fp)


def lanes(C, seed):
    """Operand pairs (p_i, q_i), edge cases first: O + Q, P + P, P + (-P),
    P + O, then random points. None is the point at infinity."""
    rng = np.random.default_rng(seed)
    G, g = C.G, C.G.generator()

    def rand():
        return G.mul(g, int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**62)) % C.R)

    a, b, c, d = rand(), rand(), rand(), rand()
    ps = [None, a, b, c] + [rand() for _ in range(4)]
    qs = [d, a, G.neg(b), None] + [rand() for _ in range(4)]
    lam = [int.from_bytes(rng.bytes(96), "little") % (C.P - 1) + 1 for _ in ps]
    return ps, qs, lam


def components(pt):
    """A host coordinate -> its Fp components."""
    return [pt] if isinstance(pt, int) else [pt.c0, pt.c1]


def projective_ints(C, pts, lam):
    """(lam*x : lam*y : lam) per point, (0 : lam : 0) for infinity; returns
    the flat Fp component lists of X, Y, Z."""
    one = C.host.Fp2(1, 0) if C.g2 else 1
    zero = C.host.Fp2(0, 0) if C.g2 else 0
    rows = []
    for pt, s in zip(pts, lam):
        x, y, z = (zero, one, zero) if pt is None else (pt[0], pt[1], one)
        rows.append([v * s % C.P for coord in (x, y, z) for v in components(coord)])
    return [list(col) for col in zip(*rows)]


def port_point(C, cols):
    ts = [C.fp.encode(c) for c in cols]
    if not C.g2:
        return tuple(ts)
    return tuple((ts[2 * i], ts[2 * i + 1]) for i in range(3))


def jax_point(C, cols):
    arrs = [C.jfp.array(c) for c in cols]
    if not C.g2:
        return tuple(arrs)
    return tuple((arrs[2 * i], arrs[2 * i + 1]) for i in range(3))


def flat_ints(pt, decode):
    out = []
    for coord in pt:
        for c in coord if isinstance(coord, tuple) else (coord,):
            out.append(decode(c))
    return out


def assert_same(C, got, want_j, want_host):
    assert flat_ints(got, C.fp.decode) == flat_ints(want_j, C.jfp.to_ints)
    assert C.dec(got) == want_host


@pytest.mark.parametrize("curve,group", CASES)
def test_add_matches_tpusnark_and_reference(curve, group):
    C = Curve(curve, group)
    ps, qs, lam = lanes(C, 1)
    pc, qc = projective_ints(C, ps, lam), projective_ints(C, qs, lam[::-1])
    got = C.ops.add(port_point(C, pc), port_point(C, qc))
    want = C.jops.add(jax_point(C, pc), jax_point(C, qc))
    assert_same(C, got, want, [C.G.add(p, q) for p, q in zip(ps, qs)])


@pytest.mark.parametrize("curve,group", CASES)
def test_double_matches_tpusnark_and_reference(curve, group):
    C = Curve(curve, group)
    ps, _, lam = lanes(C, 2)
    pc = projective_ints(C, ps, lam)
    got = C.ops.double(port_point(C, pc))
    want = C.jops.double(jax_point(C, pc))
    assert_same(C, got, want, [C.G.double(p) for p in ps])


@pytest.mark.parametrize("curve,group", CASES)
def test_add_mixed_matches_tpusnark_and_reference(curve, group):
    """Infinity lanes of the affine operand return the projective one."""
    C = Curve(curve, group)
    ps, qs, lam = lanes(C, 3)
    pc = projective_ints(C, ps, lam)
    q_aff = C.enc(qs)
    assert q_aff[2].tolist() == [q is None for q in qs]
    got = C.ops.add_mixed(port_point(C, pc), q_aff)
    want = C.jops.add_mixed(jax_point(C, pc), C.jenc(qs))
    assert_same(C, got, want, [C.G.add(p, q) for p, q in zip(ps, qs)])


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


@pytest.mark.parametrize("curve,group", CASES)
def test_encoding_round_trip_and_layout(curve, group):
    """to_device then from_affine decodes to the same points, and the
    port's tensors are tpusnark's limbs regrouped into 32-bit words, both
    ways (convert.to_torch, convert.from_torch)."""
    C = Curve(curve, group)
    ps, _, _ = lanes(C, 4)
    aff = C.enc(ps)
    assert C.dec(C.ops.from_affine(aff)) == ps
    j_aff = C.jenc(ps)
    for ours, conv in zip(leaves(aff), leaves(to_torch(j_aff, C.cfg.fp_spec))):
        assert torch.equal(ours, conv)
    for back, theirs in zip(leaves(from_torch(aff, C.cfg.fp_spec)), leaves(j_aff)):
        assert np.array_equal(back, np.asarray(theirs))


def test_g2_decode_returns_the_curves_own_fp2():
    """BLS12-381 G2 points decode into curves.bls12381.Fp2 with their full
    381-bit coordinates. BN254's Fp2 (curves.ref) reduces mod BN254's p, so
    a decoder that fell back to it would return other values, silently."""
    C = Curve("bls12-381", "g2")
    ps, _, _ = lanes(C, 5)
    got = C.dec(C.ops.from_affine(C.enc(ps)))
    assert got == ps
    for pt in filter(None, got):
        assert all(type(v) is bls12381.Fp2 for v in pt)
    big = [v for pt in filter(None, got) for v in (pt[0].c0, pt[0].c1, pt[1].c0, pt[1].c1)]
    assert max(big) > BN254_FP.modulus
    assert ref.Fp2(max(big), 0).c0 != max(big)  # what the BN254 class would keep


def test_kernel_ops_refuse_constants_their_kernels_are_not_built_for():
    """The BN254 G1 kernel has 3b = 9 built in (an add chain); ops over
    BN254's Fp with another b cannot reach it. BLS12-377's G2 kernels are
    built for u^2 = -5, and only BW6-761 has a G2 over Fp."""
    fp = get_field(BN254_FP)
    with pytest.raises(ValueError, match="3b = 9"):
        g1_ops(fp, b=4)
    cfg = get_curve("bls12-377")
    with pytest.raises(ValueError, match="q = 5"):
        g2_ops(get_field(cfg.fp_spec), cfg.g2_b3, q=1)
    with pytest.raises(ValueError, match="bls12-377 g2 kernels are not over FpArith"):
        g1_ops(get_field(cfg.fp_spec), b=4, group="g2")
    bw6 = get_curve("bw6-761")
    assert g1_ops(get_field(bw6.fp_spec), b=bw6.g2_b, group="g2").group == "g2"
