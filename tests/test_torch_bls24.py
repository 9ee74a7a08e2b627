"""BLS24-315 and BLS24-317 through the port (tpusnark_torch, plain versions on
the CPU) against tpusnark: G2 over Fp4 = Fp2[v]/(v^2 - Z2), Fp2 = Fp[u]/(u^2
- a2) (a2 = -13, Z2 = u for BLS24-315; a2 = -1, Z2 = 1 + u for BLS24-317),
10-word Fp, and 8- and 9-word fr (BLS24-317's 17-limb fr: R = 2^288 here,
2^272 in tpusnark).

* The Fp4 group law against tpusnark's ``g2_ops_fp4`` (JAX on the CPU): one
  add (with identity lanes, a doubling P + P and P + (-P)), one mixed add
  with infinity lanes, and the doubling. The port runs the same formulas in
  the same order, so the projective X, Y and Z are equal as ints mod p. Each
  tpusnark call costs a quarter of a minute or more, so one module fixture a
  curve makes both calls.
* The Fp4 product and 3b' against the host tower (curves/bls24.py).
* The Fp4 MSM on its strip and log-scan paths against the host sum, with
  infinity points and zero digits (the DEAD key).

Groth16 over these curves is in tests/test_torch_groth16_bls24.py."""

import random
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.curves.config import get_curve
from tpusnark.curves.jcurve import g2_ops_fp4
from tpusnark.fields.jfield import Field as JField
from tpusnark_torch import kernels
from tpusnark_torch.curves.config import get_curve as tget_curve
from tpusnark_torch.curves.encoding import g4_from_device_proj, g4_to_device
from tpusnark_torch.curves.tcurve import Fp4Arith, curve_ops, g2_ops_fp4 as tg2_ops_fp4
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.msm.pippenger import MSM, auto_c

torch.set_num_threads(1)  # the suite's workers fill the cores already

CURVES = ("bls24-315", "bls24-317")
LANES = 16


def fp4_ints(e):
    """A host Fp4 element -> its four Fp components (c00, c01, c10, c11)."""
    return [f.v for f2 in e.c for f in f2.c]


class Side:
    """One curve's G2 on both sides: host module, port ops, tpusnark ops."""

    def __init__(self, curve):
        cfg = get_curve(curve)
        self.cfg, self.host = cfg, tget_curve(curve).host
        self.p = cfg.fp_spec.modulus
        self.fp, self.jfp = get_field(cfg.fp_spec), JField(cfg.fp_spec)
        self.ops = curve_ops(curve)[1]
        assert self.ops.degree == 4 and self.ops.group == "g2" and isinstance(self.ops.fa, Fp4Arith)
        self.jops = g2_ops_fp4(self.jfp, cfg.g2_b3_fp4, cfg.fp4_a2, cfg.fp4_z2)

    def port(self, cols):
        """12 lists of ints (X, Y, Z, four components each) -> port point."""
        ts = [self.fp.encode(c) for c in cols]
        return tuple(((ts[4 * i], ts[4 * i + 1]), (ts[4 * i + 2], ts[4 * i + 3])) for i in range(len(cols) // 4))

    def jax(self, cols):
        arrs = [self.jfp.array(c) for c in cols]
        return tuple(((arrs[4 * i], arrs[4 * i + 1]), (arrs[4 * i + 2], arrs[4 * i + 3])) for i in range(len(cols) // 4))

    def port_ints(self, pt):
        return [self.fp.decode(c) for coord in pt for c in self.ops.fa.components(coord)]

    def jax_ints(self, pt):
        return [self.jfp.to_ints(c) for coord in pt for pair in coord for c in pair]


def operands(S, seed):
    """X, Y, Z columns of P and Q (12 lists of LANES ints each): lanes 0-1
    P = O, lanes 2-3 Q = P, lane 4 P = 2g and Q = 3g, lane 5 Q = -P, scaled
    by random Fp factors; arbitrary coordinates elsewhere (the formulas are
    polynomial identities). Returns (P, Q, the host points of lanes 4-5)."""
    rng = np.random.default_rng(seed)

    def rnd():
        return int.from_bytes(rng.bytes(48), "little") % S.p

    P = [[rnd() for _ in range(LANES)] for _ in range(12)]
    Q = [[rnd() for _ in range(LANES)] for _ in range(12)]
    for i in (0, 1):  # the identity (0 : 1 : 0)
        for k in range(12):
            P[k][i] = int(k == 4)
    for k in range(12):
        for i in (2, 3):
            Q[k][i] = P[k][i]
    G = S.host.G2
    g2 = G.double(G.generator())
    g3 = G.add(g2, G.generator())
    real = {4: (g2, g3), 5: (g3, G.neg(g3))}
    for i, (a, b) in real.items():
        # P projective under a random factor; Q with Z = 1 (also the mixed
        # add's affine operand)
        for cols, pt, lam in ((P, a, rnd() or 1), (Q, b, 1)):
            vals = fp4_ints(pt[0]) + fp4_ints(pt[1]) + [1, 0, 0, 0]
            for k in range(12):
                cols[k][i] = vals[k] * lam % S.p
    return P, Q, real


@pytest.fixture(scope="module", params=CURVES)
def group_law(request):
    """tpusnark's add and mixed add over one curve's Fp4, and the port's."""
    S = Side(request.param)
    P, Q, real = operands(S, 1)
    inf = np.zeros(LANES, dtype=bool)
    inf[[7, 9]] = True
    q_aff = Q[:8]
    out = {
        "add": (S.ops.add(S.port(P), S.port(Q)), S.jops.add(S.jax(P), S.jax(Q))),
        "add_mixed": (
            S.ops.add_mixed(S.port(P), S.port(q_aff) + (torch.from_numpy(inf),)),
            S.jops.add_mixed(S.jax(P), S.jax(q_aff) + (jnp.asarray(inf),)),
        ),
    }
    return S, P, Q, real, inf, out


def test_fp4_add_equals_tpusnark_coordinate_by_coordinate(group_law):
    S, _, _, real, _, out = group_law
    got, want = out["add"]
    assert S.port_ints(got) == S.jax_ints(want)
    G = S.host.G2
    dec = g4_from_device_proj(got, S.fp, S.host.Fp4, S.host.Fp2)
    assert dec[4] == G.add(*real[4]) and dec[5] is None
    assert dec[0] is not None and dec[1] is not None  # O + Q = Q


def test_fp4_mixed_add_with_infinity_lanes_equals_tpusnark(group_law):
    S, P, _, real, inf, out = group_law
    got, want = out["add_mixed"]
    ints = S.port_ints(got)
    assert ints == S.jax_ints(want)
    for k in range(12):  # infinity lanes return P itself
        assert [ints[k][i] for i in (7, 9)] == [P[k][i] % S.p for i in (7, 9)]
    dec = g4_from_device_proj(got, S.fp, S.host.Fp4, S.host.Fp2)
    assert dec[4] == S.host.G2.add(*real[4]) and dec[5] is None


def test_fp4_doubling_equals_tpusnark(group_law):
    """The port's doubling equals tpusnark's add on the lanes where Q = P."""
    S, P, _, _, _, out = group_law
    got = S.port_ints(S.ops.double(S.port(P)))
    want = S.jax_ints(out["add"][1])
    assert [c[2:4] for c in got] == [c[2:4] for c in want]
    G = S.host.G2
    dec = g4_from_device_proj(S.ops.double(S.port(P)), S.fp, S.host.Fp4, S.host.Fp2)
    assert dec[4] == G.double(G.double(G.generator())) and dec[0] is None


@pytest.mark.parametrize("curve", CURVES)
def test_fp4_product_and_3b_equal_the_host_tower(curve):
    """Fp4Arith's Karatsuba, Z2 * x, 3b' and the inversion through the norm
    (setup's to_affine) against curves/bls24.py's tower."""
    S = Side(curve)
    fa, host = S.ops.fa, S.host
    rng = random.Random(3)
    xs = [host.Fp4((host.Fp2((rng.randrange(S.p), rng.randrange(S.p))),) * 2) for _ in range(4)]
    xs += [host.Fp4((host.Fp2((rng.randrange(S.p), rng.randrange(S.p))), host.Fp2((rng.randrange(S.p), 0))))]
    xs += [host.Fp4.zero(), host.Fp4.one()]
    ys = xs[1:] + xs[:1]

    def enc(vals):
        cols = [S.fp.encode([fp4_ints(v)[k] for v in vals]) for k in range(4)]
        return ((cols[0], cols[1]), (cols[2], cols[3]))

    def dec(e):
        cols = [S.fp.decode(c) for c in fa.components(e)]
        return [host.Fp4((host.Fp2((cols[0][i], cols[1][i])), host.Fp2((cols[2][i], cols[3][i])))) for i in range(len(cols[0]))]

    assert dec(fa.mul(enc(xs), enc(ys))) == [x * y for x, y in zip(xs, ys)]
    b3 = host.Fp4(tuple(host.Fp2(pair) for pair in S.cfg.g2_b3_fp4))
    assert b3 == host.B2 * 3  # 3b' of the twist
    assert dec(fa.mul_b3(enc(xs))) == [x * b3 for x in xs]
    setup_mod = import_module("tpusnark_torch.backend.groth16.setup")
    inv = dec(setup_mod._fp4_inv(fa, enc(xs)))
    assert inv == [host.Fp4.zero() if x.is_zero() else x.inv() for x in xs]


def host_msm_case(S, n, seed):
    """n host points i*g (with an infinity and a repeated point) and scalars
    (with zeros, and one-word ones whose upper digits are zero), and their
    host sum, from the discrete logs."""
    G, R = S.host.G2, S.host.R
    rng = random.Random(seed)
    g = G.generator()
    pts, logs, P = [], [], None
    for i in range(1, n - 1):
        P = G.add(P, g)
        pts.append(P)
        logs.append(i)
    pts += [None, pts[0]]
    logs += [0, 1]
    scs = [rng.randrange(R) for _ in range(n)]
    scs[1], scs[2], scs[3] = 0, 5, rng.randrange(1 << 32)
    want = G.mul(g, sum(s * d for s, d in zip(scs, logs)) % R)
    return pts, scs, want


@pytest.mark.parametrize("curve,path", (("bls24-315", "strip"), ("bls24-317", "log-scan")))
def test_fp4_msm_matches_the_host_sum(curve, path):
    """The Fp4 MSM's strip path (the strip pass over the bases, then the
    segmented scan over its flush records, the bucket weighting and the
    Horner) and its log-scan path (the segmented scan over the gathered
    bases), against the host sum: one path a curve, each a minute of plain
    Fp4 adds on the CPU. (The c = 16 strip path of the prove, whose flush
    records go through weighted_from_records, runs on the card in
    chip_smoke.py.)"""
    S = Side(curve)
    fr = get_field(S.cfg.fr_spec)
    n = 40
    pts, scs, want = host_msm_case(S, n, 5 if path == "strip" else 6)
    if path == "strip":
        msm = MSM(S.ops, fr, c=5, strips=8, strip_threshold=32)
    else:
        msm = MSM(S.ops, fr, c=auto_c(n))
    msm.ladder_threshold = 16  # past the bit ladder at this small n
    assert (n >= msm.strip_threshold) == (path == "strip")
    out = msm(g4_to_device(pts, S.fp), fr.encode(scs, mont=False))
    assert g4_from_device_proj(out, S.fp, S.host.Fp4, S.host.Fp2) == [want]


def test_fp4_kernels_refuse_cpu_tensors_and_wrong_shapes(monkeypatch):
    """The Fp4 wrappers take 24 input components (12 for a mixed add's
    affine operand: 20 in all) and 4N words of 3b'; everything is refused
    before any build."""

    def no_build():
        raise AssertionError("nothing may be built")

    monkeypatch.setattr(kernels, "build", no_build)
    spec = get_curve("bls24-315").fp_spec
    w = torch.zeros((10, 4), dtype=torch.int32)
    assert kernels.g2_degree("bls24-315") == kernels.g2_degree("bls24-317") == 4
    with pytest.raises(ValueError, match="expected 24 coordinate components"):
        kernels.curve_op("add", True, spec, [w] * 12, [0] * 40)
    with pytest.raises(ValueError, match="expected 40 words of 3b"):
        kernels.curve_op("add", True, spec, [w] * 24, [0] * 20)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.curve_op("add_mixed", True, spec, [w] * 20, [0] * 40)
    with pytest.raises(ValueError, match="expected 40 words of 3b and of 1"):
        kernels.MsmKernels(spec, True, [0] * 20, [0] * 20)
    fused = kernels.MsmKernels(spec, True, [0] * 40, [0] * 40)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.scan_step([w] * 12, 1, 4)
    with pytest.raises(ValueError, match="G2 kernels are built for a2 = -13"):
        tg2_ops_fp4(get_field(spec), get_curve("bls24-315").g2_b3_fp4, -1, (0, 1))
