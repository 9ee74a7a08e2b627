"""MSM.many of the port (tpusnark_torch.msm.pippenger, plain curve ops on the
CPU) at k = 2 and k = 3 scalar vectors over shared points against tpusnark's
MSM.many (JAX on the CPU) and the naive sums, on the ladder path and on the
strip path (composite bucket keys poly * B' + |digit| - 1), over BN254 and
over BLS12-381 (9-word scalars, 12-word coordinates). The points hold an
infinity; zero scalars are among the rows. Exact: results are compared as
affine points."""

import random

import pytest
import torch

from tpusnark.curves import bls12381
from tpusnark.curves import encoding as jenc
from tpusnark.curves import ref
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BLS12_381_FP, BLS12_381_FR, BN254_FP, BN254_FR
from tpusnark.msm import pippenger as jpip
from tpusnark_torch.curves.encoding import g1_from_device_proj, g1_to_device
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.msm import pippenger as tmsm

torch.set_num_threads(1)  # the suite's workers fill the cores already

# curve -> (host G1, r, fr spec, fp spec)
CURVES = {
    "bn254": (ref.G1, ref.R, BN254_FR, BN254_FP),
    "bls12-381": (bls12381.G1, bls12381.R, BLS12_381_FR, BLS12_381_FP),
}
# path -> (points, strip threshold): 7 points take the ladder; 100 points are
# past it, and under k vectors they are k * 100 >= 128 records: the strip path
PATHS = {"ladder": (7, 1 << 15), "strip": (100, 128)}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_many_matches_tpusnark_many_and_naive_sums(curve, path, k):
    G, r, frs, fps = CURVES[curve]
    n, strip_threshold = PATHS[path]
    rng = random.Random(41 + k)
    g, pts, P = G.generator(), [], None
    for _ in range(n - 1):
        P = G.add(P, g)
        pts.append(P)
    pts.append(None)
    rows = [[rng.randrange(r) for _ in range(n)] for _ in range(k)]
    rows[1][0] = 0
    rows[k - 1][3] = rows[0][3]  # one point under the same scalar in two vectors
    flat = [s for row in rows for s in row]

    fp, fr = get_field(fps), get_field(frs)
    msm = tmsm.MSM(tmsm.get_msm("g1", 5, curve).ops, fr, c=5, strip_threshold=strip_threshold, strips=16)
    assert (n <= msm.ladder_threshold) == (path == "ladder")
    assert (k * n >= msm.strip_threshold) == (path == "strip")
    scalars = fr.encode(flat, mont=False).reshape(fr.n, k, n)
    got = g1_from_device_proj(msm.many(g1_to_device(pts, fp), scalars), fp)

    jfp, jfr = JField(fps), JField(frs)
    jmsm = jpip.MSM(jpip.get_msm("g1", 5, curve).ops, jfr, c=5, strip_threshold=strip_threshold, strips=16)
    jscalars = jfr.array(flat, mont=False).reshape(-1, k, n)
    jout = jmsm.many(jenc.g1_to_device(pts, jfp), jscalars)
    want = jenc.g1_from_device_proj(jout, jfp)

    naive = []
    for row in rows:
        acc = None
        for pt, s in zip(pts, row):
            acc = G.add(acc, G.mul(pt, s))
        naive.append(acc)
    assert got == want == naive
