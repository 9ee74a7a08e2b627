"""The port's group law (tpusnark_torch.curves.tcurve, plain versions on the
CPU) against tpusnark's CurveOps (JAX on the CPU) and the Python reference
(tpusnark.curves.ref), on the same seeded points. Exact: projective outputs
are compared with tpusnark's coordinate by coordinate as ints mod p, and
their affine values with the reference."""

import numpy as np
import pytest
import torch

from tpusnark.curves import encoding as jenc
from tpusnark.curves.jcurve import g1_ops as jg1_ops
from tpusnark.curves.jcurve import g2_ops as jg2_ops
from tpusnark.curves.ref import G1, G2, P, R, Fp2
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BN254_FP
from tpusnark_torch.convert import from_torch, to_torch
from tpusnark_torch.curves.encoding import (
    g1_from_device_proj,
    g1_to_device,
    g2_from_device_proj,
    g2_to_device,
)
from tpusnark_torch.curves.tcurve import g1_ops, g2_ops
from tpusnark_torch.fields.tfield import get_field

fp = get_field(BN254_FP)
jfp = JField(BN254_FP)

GROUPS = {
    "g1": (G1, g1_ops, jg1_ops, g1_to_device, g1_from_device_proj),
    "g2": (G2, g2_ops, jg2_ops, g2_to_device, g2_from_device_proj),
}

JENC = {"g1": jenc.g1_to_device, "g2": jenc.g2_to_device}


def lanes(G, seed):
    """Operand pairs (p_i, q_i), edge cases first: O + Q, P + P, P + (-P),
    P + O, then random points. None is the point at infinity."""
    rng = np.random.default_rng(seed)
    g = G.generator()

    def rand():
        return G.mul(g, int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**62)) % R)

    a, b, c, d = rand(), rand(), rand(), rand()
    ps = [None, a, b, c] + [rand() for _ in range(4)]
    qs = [d, a, G.neg(b), None] + [rand() for _ in range(4)]
    lam = [int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1 for _ in ps]
    return ps, qs, lam


def components(pt):
    """A host coordinate -> its Fp components."""
    return [pt.c0, pt.c1] if isinstance(pt, Fp2) else [pt]


def projective_ints(G, pts, lam):
    """(lam*x : lam*y : lam) per point, (0 : lam : 0) for infinity; returns
    the flat Fp component lists of X, Y, Z."""
    one = Fp2(1, 0) if G is G2 else 1
    zero = Fp2(0, 0) if G is G2 else 0
    rows = []
    for pt, s in zip(pts, lam):
        x, y, z = (zero, one, zero) if pt is None else (pt[0], pt[1], one)
        rows.append([v * s % P for coord in (x, y, z) for v in components(coord)])
    return [list(col) for col in zip(*rows)]


def port_point(G, cols):
    ts = [fp.encode(c) for c in cols]
    if G is G1:
        return tuple(ts)
    return tuple((ts[2 * i], ts[2 * i + 1]) for i in range(3))


def jax_point(G, cols):
    arrs = [jfp.array(c) for c in cols]
    if G is G1:
        return tuple(arrs)
    return tuple((arrs[2 * i], arrs[2 * i + 1]) for i in range(3))


def flat_ints(pt, decode):
    out = []
    for coord in pt:
        for c in coord if isinstance(coord, tuple) else (coord,):
            out.append(decode(c))
    return out


def assert_same(got, want_j, want_host, dec):
    assert flat_ints(got, fp.decode) == flat_ints(want_j, jfp.to_ints)
    assert dec(got, fp) == want_host


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_add_matches_tpusnark_and_reference(group):
    G, ops_t, ops_j, _, dec = GROUPS[group]
    ps, qs, lam = lanes(G, 1)
    ops, jops = ops_t(fp), ops_j(jfp)
    pc, qc = projective_ints(G, ps, lam), projective_ints(G, qs, lam[::-1])
    got = ops.add(port_point(G, pc), port_point(G, qc))
    want = jops.add(jax_point(G, pc), jax_point(G, qc))
    assert_same(got, want, [G.add(p, q) for p, q in zip(ps, qs)], dec)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_double_matches_tpusnark_and_reference(group):
    G, ops_t, ops_j, _, dec = GROUPS[group]
    ps, _, lam = lanes(G, 2)
    ops, jops = ops_t(fp), ops_j(jfp)
    pc = projective_ints(G, ps, lam)
    got = ops.double(port_point(G, pc))
    want = jops.double(jax_point(G, pc))
    assert_same(got, want, [G.double(p) for p in ps], dec)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_add_mixed_matches_tpusnark_and_reference(group):
    """Infinity lanes of the affine operand return the projective one."""
    G, ops_t, ops_j, enc, dec = GROUPS[group]
    ps, qs, lam = lanes(G, 3)
    ops, jops = ops_t(fp), ops_j(jfp)
    pc = projective_ints(G, ps, lam)
    q_aff = enc(qs, fp)
    assert q_aff[2].tolist() == [q is None for q in qs]
    got = ops.add_mixed(port_point(G, pc), q_aff)
    want = jops.add_mixed(jax_point(G, pc), JENC[group](qs, jfp))
    assert_same(got, want, [G.add(p, q) for p, q in zip(ps, qs)], dec)


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_encoding_round_trip_and_layout(group):
    """to_device then from_affine decodes to the same points, and the
    port's tensors are tpusnark's limbs regrouped into 32-bit words, both
    ways (convert.to_torch, convert.from_torch)."""
    G, ops_t, _, enc, dec = GROUPS[group]
    ps, _, _ = lanes(G, 4)
    aff = enc(ps, fp)
    assert dec(ops_t(fp).from_affine(aff), fp) == ps
    j_aff = JENC[group](ps, jfp)
    for ours, conv in zip(leaves(aff), leaves(to_torch(j_aff))):
        assert torch.equal(ours, conv)
    for back, theirs in zip(leaves(from_torch(aff)), leaves(j_aff)):
        assert np.array_equal(back, np.asarray(theirs))
