"""The port's MSM (tpusnark_torch.msm.pippenger, plain curve ops on the CPU)
against tpusnark's MSM (JAX on the CPU) and msm_naive_ref, on the ladder,
log-scan and strip paths at the sizes of tests/test_msm.py, plus c = 11 on
the strip path, where the flush records go through
``weighted_from_records`` (the path that c = 16 takes at 2^17 points), over
BN254; and over BLS12-381 (9-word scalars, 12-word coordinates) the strip
path with infinity inputs and zero digits and the G2 ladder, against the
host sum and tpusnark's get_msm(..., "bls12-381"). Exact: results are
compared as affine points."""

import random

import numpy as np
import pytest

from tpusnark.curves import bls12381
from tpusnark.curves import encoding as jenc
from tpusnark.curves import ref
from tpusnark.curves.ref import G1, G2, R
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BLS12_381_FP, BLS12_381_FR, BN254_FP, BN254_FR
from tpusnark.msm import pippenger as jpip
from tpusnark_torch.curves.encoding import (
    g1_from_device_proj,
    g1_to_device,
    g2_from_device_proj,
    g2_to_device,
)
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.msm import pippenger as tmsm
from tpusnark_torch.msm.pippenger import (
    MSM,
    auto_c,
    window_digits,
    window_digits_signed,
)

fp, fr = get_field(BN254_FP), get_field(BN254_FR)
jfp, jfr = JField(BN254_FP), JField(BN254_FR)
CURVE_FIELDS = {"bn254": (BN254_FR, G1), "bls12-381": (BLS12_381_FR, bls12381.G1)}


def get_msm(group, c):
    """The port's BN254 engine (tpusnark's get_msm defaults to BN254)."""
    return tmsm.get_msm(group, c, "bn254")


def chain(G, n):
    """g, 2g, ..., n*g: distinct points without a scalar mul each."""
    g, out, P = G.generator(), [], None
    for _ in range(n):
        P = G.add(P, g)
        out.append(P)
    return out


def ref_sum(G, pts, scs):
    acc = None
    for pt, s in zip(pts, scs):
        acc = G.add(acc, G.mul(pt, s))
    return acc


def port_g1(msm, pts, scs):
    return g1_from_device_proj(msm(g1_to_device(pts, fp), fr.encode(scs, mont=False)), fp)[0]


def jax_g1(msm, pts, scs):
    return jenc.g1_from_device_proj(msm(jenc.g1_to_device(pts, jfp), jfr.array(scs, mont=False)), jfp)[0]


def edge_case_points(n, seed, G=G1, r=R):
    """n - 4 distinct points, then an infinity, two duplicates and a
    negation; zero scalars among them."""
    rng = random.Random(seed)
    pts = chain(G, n - 4)
    pts += [None, pts[0], pts[0], G.neg(pts[1])]
    scs = [rng.randrange(r) for _ in range(n - 4)] + [7, 0, 5, 1]
    scs[2] = 0
    return pts, scs


def small_cases():
    rng = random.Random(11)
    g = G1.generator()
    q = G1.mul(g, 5)
    for n in (1, 2, 7):
        pts = [G1.mul(g, rng.randrange(1, R)) for _ in range(n)]
        yield f"random{n}", pts, [rng.randrange(R) for _ in range(n)]
    yield "edge", [g, q, None, q, q, G1.neg(q)], [0, 3, 7, 3, R - 1, 1]
    yield "all_zero", [g, g], [0, 0]
    yield "single_large", [g], [R - 12345]


SMALL = list(small_cases())


@pytest.mark.parametrize("name,pts,scs", SMALL, ids=[c[0] for c in SMALL])
def test_ladder_path_matches_tpusnark_and_naive(name, pts, scs):
    msm = get_msm("g1", 6)
    assert len(pts) <= msm.ladder_threshold
    got = port_g1(msm, pts, scs)
    assert got == jax_g1(jpip.get_msm("g1", 6), pts, scs) == jpip.msm_naive_ref(pts, scs)


def test_logscan_path_matches_tpusnark_and_naive():
    n = 128
    rng = random.Random(12)
    pts = chain(G1, n)
    scs = [rng.randrange(R) for _ in range(n)]
    msm = get_msm("g1", 5)
    assert msm.ladder_threshold < n < msm.strip_threshold
    got = port_g1(msm, pts, scs)
    assert got == jax_g1(jpip.get_msm("g1", 5), pts, scs) == jpip.msm_naive_ref(pts, scs)


def test_strip_path_matches_tpusnark_and_naive():
    pts, scs = edge_case_points(256, 13)
    msm = MSM(get_msm("g1", 5).ops, fr, c=5, strip_threshold=128, strips=16)
    jmsm = jpip.MSM(jpip.get_msm("g1", 5).ops, jfr, c=5, strip_threshold=128, strips=16)
    got = port_g1(msm, pts, scs)
    assert got == jax_g1(jmsm, pts, scs) == jpip.msm_naive_ref(pts, scs)


def test_strip_path_weighted_from_records_c11():
    """c = 11: 1024 live buckets per window, so the flush records are
    reduced by weighted_from_records, as at c = 16 on the card."""
    pts, scs = edge_case_points(256, 14)
    msm = MSM(get_msm("g1", 11).ops, fr, c=11, strip_threshold=128, strips=16)
    assert msm.nbuckets >= 1024
    assert port_g1(msm, pts, scs) == jpip.msm_naive_ref(pts, scs)


def test_g2_ladder_matches_tpusnark_and_reference():
    rng = random.Random(15)
    g = G2.generator()
    pts = [G2.mul(g, rng.randrange(1, R)) for _ in range(8)]
    scs = [rng.randrange(R) for _ in range(8)]
    out = get_msm("g2", 4)(g2_to_device(pts, fp), fr.encode(scs, mont=False))
    got = g2_from_device_proj(out, fp, ref.Fp2, 1)[0]
    jout = jpip.get_msm("g2", 4)(jenc.g2_to_device(pts, jfp), jfr.array(scs, mont=False))
    assert got == jenc.g2_from_device_proj(jout, jfp)[0] == ref_sum(G2, pts, scs)


def test_g2_strip_path_matches_reference():
    """G2 over Fp2 through the strip path, with duplicates, an infinity and
    zero scalars."""
    rng = random.Random(16)
    n = 128
    pts = chain(G2, n - 4)
    pts += [None, pts[0], pts[0], G2.neg(pts[1])]
    scs = [rng.randrange(R) for _ in range(n - 4)] + [7, 0, 5, 1]
    msm = MSM(get_msm("g2", 5).ops, fr, c=5, strip_threshold=64, strips=16)
    got = g2_from_device_proj(msm(g2_to_device(pts, fp), fr.encode(scs, mont=False)), fp, ref.Fp2, 1)[0]
    assert got == ref_sum(G2, pts, scs)


@pytest.mark.parametrize("n,strip_threshold", [(7, 1 << 15), (128, 128)], ids=["ladder", "strip"])
def test_many_sums_two_scalar_vectors_over_shared_points(n, strip_threshold):
    """MSM.many with k = 2: one result per scalar vector (composite bucket
    keys poly * B' + |digit| - 1 on the strip path)."""
    rng = random.Random(17)
    pts = chain(G1, n - 1) + [None]
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(2)]
    rows[1][0] = 0
    msm = MSM(get_msm("g1", 5).ops, fr, c=5, strip_threshold=strip_threshold, strips=16)
    scalars = fr.encode(rows[0] + rows[1], mont=False).reshape(8, 2, n)
    got = g1_from_device_proj(msm.many(g1_to_device(pts, fp), scalars), fp)
    assert got == [jpip.msm_naive_ref(pts, row) for row in rows]


@pytest.mark.parametrize("curve", sorted(CURVE_FIELDS))
@pytest.mark.parametrize("c", [5, 11, 16])
def test_window_digits_match_tpusnark_and_recode_the_scalar(c, curve):
    """Normal-form scalars of 8 (BN254) and 9 (BLS12-381) words; 255-bit
    BLS12-381 r still takes 16 windows at c = 16."""
    spec = CURVE_FIELDS[curve][0]
    r = spec.modulus
    rng = np.random.default_rng(c)
    scs = [0, 1, r - 1] + [int.from_bytes(rng.bytes(32), "little") % r for _ in range(13)]
    msm = MSM(get_msm("g1", c).ops, get_field(spec), c=c)
    nw = msm.n_windows
    if c == 16:
        assert nw == 16
    s_port = get_field(spec).encode(scs, mont=False)
    s_jax = JField(spec).array(scs, mont=False)
    assert np.array_equal(
        window_digits(s_port, c, nw).numpy(), np.asarray(jpip.window_digits(s_jax, 16, c, nw))
    )
    mags, signs = window_digits_signed(s_port, c, nw)
    jm, js = jpip.window_digits_signed(s_jax, 16, c, nw)
    assert np.array_equal(mags.numpy(), np.asarray(jm))
    assert np.array_equal(signs.numpy(), np.asarray(js))
    assert int(mags.max()) <= 1 << (c - 1)
    weights = [1 << (c * w) for w in range(nw)]
    for i, s in enumerate(scs):
        total = sum(
            (-1 if bool(signs[w, i]) else 1) * int(mags[w, i]) * weights[w] for w in range(nw)
        )
        assert total == s


def test_auto_c_matches_tpusnark():
    sizes = [1, 2, 96, 128, 1000, 1 << 15, (1 << 17) - 6, 1 << 20]
    assert [auto_c(n) for n in sizes] == [jpip.auto_c(n) for n in sizes]
    assert auto_c((1 << 17) - 6) == 16


def bls_port(msm, pts, scs, g2=False):
    bfp, bfr = get_field(BLS12_381_FP), get_field(BLS12_381_FR)
    enc = g2_to_device if g2 else g1_to_device
    out = msm(enc(pts, bfp), bfr.encode(scs, mont=False))
    if g2:
        return g2_from_device_proj(out, bfp, bls12381.Fp2, 1)[0]
    return g1_from_device_proj(out, bfp)[0]


def bls_jax(msm, pts, scs, g2=False):
    jbfp, jbfr = JField(BLS12_381_FP), JField(BLS12_381_FR)
    enc = jenc.g2_to_device if g2 else jenc.g1_to_device
    out = msm(enc(pts, jbfp), jbfr.array(scs, mont=False))
    if g2:
        return jenc.g2_from_device_proj(out, jbfp, fp2_cls=bls12381.Fp2, q=1)[0]
    return jenc.g1_from_device_proj(out, jbfp)[0]


def test_bls12381_strip_path_matches_tpusnark_and_host_sum():
    """BLS12-381 G1 (3b = 12) through the strip path: an infinity input,
    duplicates, a negation and zero scalars."""
    G, r = bls12381.G1, bls12381.R
    pts, scs = edge_case_points(128, 18, G, r)
    msm = MSM(tmsm.get_msm("g1", 5, "bls12-381").ops, get_field(BLS12_381_FR), c=5, strip_threshold=64, strips=16)
    jmsm = jpip.MSM(
        jpip.get_msm("g1", 5, "bls12-381").ops, JField(BLS12_381_FR), c=5, strip_threshold=64, strips=16
    )
    assert msm.n_windows == jmsm.n_windows
    got = bls_port(msm, pts, scs)
    assert got == bls_jax(jmsm, pts, scs) == ref_sum(G, pts, scs)


def test_bls12381_g2_ladder_matches_tpusnark_and_host_sum():
    """BLS12-381 G2 (3b' = (12, 12) over u^2 = -1) on the ladder path, with
    an infinity input and a zero scalar."""
    G, r = bls12381.G2, bls12381.R
    rng = random.Random(19)
    pts = [G.mul(G.generator(), rng.randrange(1, r)) for _ in range(5)] + [None]
    scs = [rng.randrange(r) for _ in range(5)] + [3]
    scs[1] = 0
    got = bls_port(tmsm.get_msm("g2", 4, "bls12-381"), pts, scs, g2=True)
    assert got == bls_jax(jpip.get_msm("g2", 4, "bls12-381"), pts, scs, g2=True) == ref_sum(G, pts, scs)
