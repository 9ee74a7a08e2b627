"""The port's MSM (tpusnark_torch.msm.pippenger, plain curve ops on the CPU)
over gnark's native 2-chain. BLS12-377 (G1 with 3b = 3, G2 over Fp2 with
u^2 = -5) on the strip and ladder paths against the host sum and tpusnark's
get_msm(..., "bls12-377") (JAX on the CPU). BW6-761 (12-word scalars,
24-word coordinates, G1 with 3b = -3 mod p, G2 over Fp itself with 3b = 12)
against the host sum alone: tpusnark's own 48-limb MSM compiles for minutes.
Infinity inputs, duplicates, a negation and zero scalars are among the
points. Exact: results are compared as affine points."""

import random

import pytest
import torch

from tpusnark.curves import bls12377, bw6761
from tpusnark.curves import encoding as jenc
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BLS12_377_FP, BLS12_377_FR, BW6_761_FP, BW6_761_FR
from tpusnark.msm import pippenger as jpip
from tpusnark_torch.curves.encoding import (
    g1_from_device_proj,
    g1_to_device,
    g2_from_device_proj,
    g2_to_device,
)
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.msm import pippenger as tmsm
from tpusnark_torch.msm.pippenger import MSM

torch.set_num_threads(1)  # the suite's workers fill the cores already

# curve -> (host module, fr spec, fp spec, Fp2 nonresidue q or None where G2 lies over Fp)
HOSTS = {
    "bls12-377": (bls12377, BLS12_377_FR, BLS12_377_FP, 5),
    "bw6-761": (bw6761, BW6_761_FR, BW6_761_FP, None),
}


def ref_sum(G, pts, scs):
    acc = None
    for pt, s in zip(pts, scs):
        acc = G.add(acc, G.mul(pt, s))
    return acc


def edge_case_points(n, seed, G, r):
    """n - 4 distinct points, then an infinity, two duplicates and a
    negation; zero scalars among them."""
    rng = random.Random(seed)
    g, pts, P = G.generator(), [], None
    for _ in range(n - 4):
        P = G.add(P, g)
        pts.append(P)
    pts += [None, pts[0], pts[0], G.neg(pts[1])]
    scs = [rng.randrange(r) for _ in range(n - 4)] + [7, 0, 5, 1]
    scs[2] = 0
    return pts, scs


def port(curve, msm, pts, scs, fp2=False):
    """fp2: the points have Fp2 coordinates (a G2 over Fp has not)."""
    host, frs, fps, q = HOSTS[curve]
    bfp, bfr = get_field(fps), get_field(frs)
    out = msm((g2_to_device if fp2 else g1_to_device)(pts, bfp), bfr.encode(scs, mont=False))
    if fp2:
        return g2_from_device_proj(out, bfp, host.Fp2, q)[0]
    return g1_from_device_proj(out, bfp)[0]


def jax(curve, msm, pts, scs, fp2=False):
    host, frs, fps, q = HOSTS[curve]
    jbfp, jbfr = JField(fps), JField(frs)
    out = msm((jenc.g2_to_device if fp2 else jenc.g1_to_device)(pts, jbfp), jbfr.array(scs, mont=False))
    if fp2:
        return jenc.g2_from_device_proj(out, jbfp, fp2_cls=host.Fp2, q=q)[0]
    return jenc.g1_from_device_proj(out, jbfp)[0]


def test_bls12377_strip_path_matches_tpusnark_and_host_sum():
    G, r = bls12377.G1, bls12377.R
    pts, scs = edge_case_points(96, 20, G, r)
    msm = MSM(tmsm.get_msm("g1", 5, "bls12-377").ops, get_field(BLS12_377_FR), c=5, strip_threshold=64, strips=16)
    jmsm = jpip.MSM(
        jpip.get_msm("g1", 5, "bls12-377").ops, JField(BLS12_377_FR), c=5, strip_threshold=64, strips=16
    )
    assert msm.n_windows == jmsm.n_windows
    got = port("bls12-377", msm, pts, scs)
    assert got == jax("bls12-377", jmsm, pts, scs) == ref_sum(G, pts, scs)


def test_bls12377_g2_ladder_matches_tpusnark_and_host_sum():
    G, r = bls12377.G2, bls12377.R
    rng = random.Random(21)
    pts = [G.mul(G.generator(), rng.randrange(1, r)) for _ in range(3)] + [None]
    scs = [rng.randrange(r), 0, rng.randrange(r), 3]
    got = port("bls12-377", tmsm.get_msm("g2", 4, "bls12-377"), pts, scs, fp2=True)
    want = jax("bls12-377", jpip.get_msm("g2", 4, "bls12-377"), pts, scs, fp2=True)
    assert got == want == ref_sum(G, pts, scs)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bw6761_strip_path_matches_host_sum(group):
    """377-bit scalars in 12 words: ceil(378 / 13) = 30 windows at c = 13,
    so the flush records go through weighted_from_records, as at c = 16 on
    the card. G2's points are plain int pairs in the G1 layout."""
    G, r = getattr(bw6761, group.upper()), bw6761.R
    pts, scs = edge_case_points(40, 22, G, r)
    engine = tmsm.get_msm(group, 13, "bw6-761")
    assert engine.ops.group == group and not engine.ops.fp2
    msm = MSM(engine.ops, get_field(BW6_761_FR), c=13, strip_threshold=32, strips=8)
    assert msm.n_windows == 30 and msm.nbuckets >= 1024
    assert port("bw6-761", msm, pts, scs) == ref_sum(G, pts, scs)


def test_bw6761_g2_ladder_matches_host_sum():
    G, r = bw6761.G2, bw6761.R
    rng = random.Random(23)
    pts = [G.mul(G.generator(), rng.randrange(1, r)) for _ in range(2)] + [None]
    scs = [rng.randrange(r), 0, 3]
    assert port("bw6-761", tmsm.get_msm("g2", 4, "bw6-761"), pts, scs) == ref_sum(G, pts, scs)
