"""The MSM's fused phases (tpusnark_torch.msm.pippenger: _strip_mixed, _strip,
_scan_step, _horner; one kernel launch each on the card, csrc/msm.cuh) on CPU
tensors, where they are the plain versions, against what the kernels are
specified to compute: one lane at a time, with Python control flow, as a
kernel thread walks its strip (restart at a key boundary, add inside a run,
a flush record per row; a row keyed at or past the first key that reaches no
bucket is not added, and a run of such rows is the identity), one position
at a time for a scan step, and the host curve's integers for the window
Horner. Over BN254, BLS12-381, BLS12-377, BW6-761, BW6-633 (both groups over
Fp) and BLS24-315 and BLS24-317 (G2 over Fp4), both groups. And over BN254
G1 the composite-key MSM of KZG's batched commits: the strip pass at c = 13
with k = 3 polynomials against the walk, and a whole k = 3 MSM at c = 13
down the strip path (its threshold lowered to the test's size) against host
sums. Over BN254 G1 and G2, MSMs down the strip path over the scalars of a
witness of bits (most records DEAD) against host sums, with the MSM's record
counters. Exact: coordinates are compared word for word (the
Horner and the MSM as affine points)."""

import numpy as np
import pytest
import torch

from tpusnark_torch.curves.config import get_curve
from tpusnark_torch.curves.encoding import (
    g1_from_device_proj,
    g1_to_device,
    g2_from_device_proj,
    g2_to_device,
    g4_from_device_proj,
    g4_to_device,
)
from tpusnark_torch.curves.tcurve import CurveOps, curve_ops
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch import trace
from tpusnark_torch.msm.pippenger import MSM, tree_map

torch.set_num_threads(1)  # the suite's workers fill the cores already

CURVES = ("bn254", "bls12-381", "bls12-377", "bw6-761", "bw6-633", "bls24-315", "bls24-317")
CASES = [(c, g) for c in CURVES for g in ("g1", "g2")]
IDS = [f"{c}-{g}" for c, g in CASES]


def engine(curve, group, c=5):
    cfg = get_curve(curve)
    ops = curve_ops(curve)[0 if group == "g1" else 1]
    return cfg, ops, MSM(ops, get_field(cfg.fr_spec), c=c, strips=4)


def lazy_words(rng, shape, p, words):
    """Arbitrary coordinates in [0, 2p): the group law is polynomial, so the
    comparisons do not need points of the curve."""
    top = ((2 * p).bit_length() - 1) // 32
    w = rng.integers(0, 1 << 32, size=(words, *shape), dtype=np.uint64)
    w[top] = rng.integers(0, (2 * p) >> (32 * top), size=shape, dtype=np.uint64)
    w[top + 1 :] = 0
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def coordinate(rng, ops, shape):
    """One coordinate over Fp, Fp2 ((c0, c1)) or Fp4 (((c00, c01), (c10, c11)))."""
    f = ops.fa.f

    def fp():
        return lazy_words(rng, shape, f.modulus, f.n)

    if ops.fp4:
        return ((fp(), fp()), (fp(), fp()))
    if ops.fp2:
        return (fp(), fp())
    return fp()


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def lane(pt, *idx):
    """One lane of a point (or coordinate pair) as batch-1 tensors."""
    return tree_map(lambda a: a[(slice(None), *idx)].reshape(a.shape[0], 1), pt)


def put(dst, src, *idx):
    tree_map(lambda d, s: d.__setitem__((slice(None), *idx), s[:, 0]), dst, src)


def same_words(a, b):
    ok = []
    tree_map(lambda x, y: ok.append(torch.equal(x, y)), a, b)
    return all(ok)


def walk_strips(plain, skey, point_of, like, C, R, dead, sent, mixed):
    """What the strip kernel computes, one lane (window, strip) at a time: a
    row keyed at or past `dead` reaches no bucket, so its point is not read
    and the accumulator is the identity. like: one coordinate with batch 1."""
    W = skey.shape[0]
    fkeys = torch.zeros((W, (R + 1) * C), dtype=torch.int64)
    fpts = tuple(tree_map(lambda a: torch.zeros((a.shape[0], W, (R + 1) * C), dtype=a.dtype), like) for _ in range(3))
    for w in range(W):
        for s in range(C):
            acc, acc_key = plain.identity_like(like), sent
            for r in range(R):
                kk = int(skey[w, s * R + r])
                fkeys[w, r * C + s] = sent if kk == acc_key else acc_key
                put(fpts, acc, w, r * C + s)
                if kk >= dead:
                    acc = plain.identity_like(like)
                elif kk == acc_key:
                    pt = point_of(w, s * R + r)
                    acc = plain.add_mixed(acc, pt) if mixed else plain.add(acc, pt)
                else:
                    pt = point_of(w, s * R + r)
                    acc = plain.from_affine(pt) if mixed else pt
                acc_key = kk
            fkeys[w, R * C + s] = acc_key
            put(fpts, acc, w, R * C + s)
    return fkeys, fpts


@pytest.mark.parametrize("curve,group", CASES, ids=IDS)
def test_strip_pass_over_bases_equals_a_lane_by_lane_walk(curve, group):
    """DEAD keys (a zero scalar, an infinity input, zero digits, the
    padding), sign flips, a run longer than a strip's rows and a repeated
    point inside a run. The DEAD run starts in a strip's last row (window 0)
    and in a strip's first row (window 1), and fills whole strips: the live
    flush records are what they were when DEAD records were added too, and
    the DEAD ones are the identity."""
    cfg, ops, msm = engine(curve, group)
    rng = np.random.default_rng(31)
    fr = msm.fr
    n0, C, R, W = 20, 4, 6, 2
    X, Y = coordinate(rng, ops, (n0,)), coordinate(rng, ops, (n0,))
    for a in leaves((X, Y)):
        a[:, 9] = a[:, 8]
    scalars = lazy_words(rng, (n0,), fr.modulus // 2, fr.n)
    # the two c = 5 windows' raw digits (lo, hi) of each record: a lo digit
    # past 16 is negative and carries 1 into hi, where 31 + 1 is digit 0
    raw = [(3, 0), (20, 31), (5, 0), (0, 9), (7, 0), (0, 0), (25, 31), (1, 1)] + [(9, 4)] * 7
    raw += [(18, 2), (1, 17), (30, 5), (12, 28), (16, 0)]
    scalars[0] = (scalars[0] & ~1023) | torch.tensor([lo + 32 * hi for lo, hi in raw], dtype=torch.int32)
    scalars[:, 8:15] = scalars[:, 8:9]  # one key for seven records, two of them the same point
    scalars[:, 5] = 0
    inf = torch.zeros(n0, dtype=torch.bool)
    inf[7] = True
    skey, order, ssgn = (t[:W].contiguous() for t in msm._sort_records(scalars[:, None, :], inf, C * R))
    dead = msm.nbuckets
    sent = dead + 1
    assert (skey == dead).sum(-1).tolist() == [7, 12] and bool(ssgn.any()) and not bool(ssgn.all())
    k2, o2 = skey.reshape(W, C, R), order.reshape(W, C, R)
    doubled = (k2[..., 1:] == k2[..., :-1]) & (o2[..., :-1] == 8) & (o2[..., 1:] == 9)
    assert bool(doubled.any()), "the repeated point must meet itself inside a run"

    plain = CurveOps(ops.fa)
    zero = tree_map(lambda a: torch.zeros_like(a[:, :1]), X)

    def point_of(w, j):
        i = int(order[w, j])
        if i >= n0:
            return (zero, zero)
        x, y = lane(X, i), lane(Y, i)
        return (x, plain.fa.neg(y) if bool(ssgn[w, j]) else y)

    want_keys, want_pts = walk_strips(plain, skey, point_of, lane(X, 0), C, R, dead, sent, mixed=True)
    got_keys, got_pts = msm._strip_mixed(skey, order, ssgn, (X, Y), 1, C, R, dead, sent)
    assert torch.equal(got_keys, want_keys)
    assert same_words(got_pts, want_pts)
    # with no key dropped, every record is added: the walk before the rule
    all_keys, all_pts = walk_strips(plain, skey, point_of, lane(X, 0), C, R, sent + 1, sent, mixed=True)
    assert torch.equal(all_keys, want_keys)
    live, dropped = want_keys < dead, want_keys == dead
    assert same_words(tree_map(lambda a: a[:, live], got_pts), tree_map(lambda a: a[:, live], all_pts))
    ident = tree_map(lambda a: a.expand(a.shape[0], int(dropped.sum())), plain.identity_like(lane(X, 0)))
    assert same_words(tree_map(lambda a: a[:, dropped], got_pts), ident)
    assert not same_words(tree_map(lambda a: a[:, dropped], all_pts), ident)


@pytest.mark.parametrize("curve,group", CASES, ids=IDS)
def test_strip_pass_over_records_equals_a_lane_by_lane_walk(curve, group):
    cfg, ops, msm = engine(curve, group)
    rng = np.random.default_rng(32)
    C, R, W, dead, sent = 4, 5, 2, 5, 9
    skey = torch.from_numpy(np.sort(rng.integers(0, 6, size=(W, C * R)), axis=-1))
    skey[:, -3:] = sent  # padding
    skey[0, :8] = 2  # a run across a strip boundary
    assert bool((skey == dead).any())  # keys 5 and 9 reach no bucket
    pts = tuple(coordinate(rng, ops, (W, C * R)) for _ in range(3))
    plain = CurveOps(ops.fa)
    want_keys, want_pts = walk_strips(
        plain, skey, lambda w, j: lane(pts, w, j), lane(pts[0], 0, 0), C, R, dead, sent, mixed=False
    )
    got_keys, got_pts = msm._strip(skey, pts, C, R, dead, sent)
    assert torch.equal(got_keys, want_keys)
    assert same_words(got_pts, want_pts)


# one step of each log-step loop: _fold_sum (shift = half of the width left),
# _small_weighted's suffix scan (shift = d, the whole axis) and
# _log_scan_buckets' segmented scan (shift = -d under the keys)
STEPS = [("fold", 3, 5, False), ("suffix", 2, 7, False), ("segmented", -2, 7, True)]


@pytest.mark.parametrize("step", STEPS, ids=[s[0] for s in STEPS])
@pytest.mark.parametrize("curve,group", CASES, ids=IDS)
def test_scan_step_equals_a_position_by_position_walk(curve, group, step):
    _, shift, width, keyed = step
    cfg, ops, msm = engine(curve, group)
    rng = np.random.default_rng(33)
    W, m = 2, 7
    pts = tuple(coordinate(rng, ops, (W, m)) for _ in range(3))
    key = torch.tensor([[0, 0, 0, 1, 1, 1, 1], [2, 3, 3, 3, 3, 3, 4]]) if keyed else None
    plain = CurveOps(ops.fa)
    want = tree_map(torch.clone, pts)
    for w in range(W):
        for i in range(m):
            j = i + shift
            if 0 <= j < width and (key is None or int(key[w, j]) == int(key[w, i])):
                put(want, plain.add(lane(pts, w, i), lane(pts, w, j)), w, i)
    assert same_words(msm._scan_step(pts, shift, width, key), want)


def host_points(cfg, group, n):
    G = cfg.host.G1 if group == "g1" else cfg.host.G2
    g, out, P = G.generator(), [], None
    for _ in range(n):
        P = G.add(P, g)
        out.append(P)
    return G, out


@pytest.mark.parametrize("c", [5, 16])
@pytest.mark.parametrize("curve,group", CASES, ids=IDS)
def test_horner_over_the_windows_equals_the_host_sum(curve, group, c):
    """sum_w 2^(c w) S_w for two results, over the curve's window count at
    c = 5 and at c = 16 (the prove's), with an identity among the S_w."""
    cfg, ops, msm = engine(curve, group, c)
    W, k = msm.n_windows, 2
    fp = ops.fa.f
    G, pts = host_points(cfg, group, W * k)
    pts[3] = None
    enc = g4_to_device if ops.fp4 else g2_to_device if ops.fp2 else g1_to_device
    wsums = tree_map(lambda a: a.reshape(a.shape[0], W, k), ops.from_affine(enc(pts, fp)))
    got = msm._horner(wsums)
    if ops.fp4:
        got = g4_from_device_proj(got, fp, cfg.host.Fp4, cfg.host.Fp2)
    elif ops.fp2:
        got = g2_from_device_proj(got, fp, cfg.host.Fp2, cfg.fp2_q)
    else:
        got = g1_from_device_proj(got, fp)
    want = []
    for j in range(k):
        acc = None
        for w in range(W - 1, -1, -1):
            acc = G.add(G.mul(acc, 1 << c) if acc is not None else None, pts[w * k + j])
        want.append(acc)
    assert got == want


def test_composite_strip_pass_at_c13_equals_a_lane_by_lane_walk():
    """KZG's batched commits over BN254 G1 (k = 3 polynomials at c = 13, 20
    windows): record j is base j % n0 under polynomial j // n0, keyed
    poly * 2^12 + |digit| - 1; DEAD (k * 2^12) for zero digits, the infinity
    input and the padding."""
    cfg, ops, msm = engine("bn254", "g1", c=13)
    rng = np.random.default_rng(35)
    fr, k = msm.fr, 3
    n0, C, R = 10, 4, 9
    X, Y = coordinate(rng, ops, (n0,)), coordinate(rng, ops, (n0,))
    scalars = lazy_words(rng, (k, n0), fr.modulus // 2, fr.n)
    scalars[:, 1, 2] = 0
    scalars[:, 2, :4] = scalars[:, 0, :4]  # two polynomials agree on four digits
    inf = torch.zeros(n0, dtype=torch.bool)
    inf[5] = True
    skey, order, ssgn = msm._sort_records(scalars, inf, C * R)
    assert msm.n_windows == 20 and skey.shape == (20, C * R)
    dead = k * msm.nbuckets
    assert int(skey.max()) == dead and bool((skey // msm.nbuckets == 2).any())
    sent = dead + 1
    plain = CurveOps(ops.fa)
    zero = torch.zeros_like(X[:, :1])

    def point_of(w, j):
        i = int(order[w, j])
        if i >= k * n0:
            return (zero, zero)
        x, y = lane(X, i % n0), lane(Y, i % n0)
        return (x, plain.fa.neg(y) if bool(ssgn[w, j]) else y)

    want_keys, want_pts = walk_strips(plain, skey, point_of, lane(X, 0), C, R, dead, sent, mixed=True)
    got_keys, got_pts = msm._strip_mixed(skey, order, ssgn, (X, Y), k, C, R, dead, sent)
    assert torch.equal(got_keys, want_keys)
    assert same_words(got_pts, want_pts)


def test_composite_msm_at_c13_down_the_strip_path_equals_host_sums():
    """MSM.many at c = 13 with k = 3 down the path KZG's batched commits take
    at 2^17 (strip pass, weighted_from_records, Horner over 20 windows), on
    20 points with the strip path's threshold lowered to them."""
    cfg = get_curve("bn254")
    ops = curve_ops("bn254")[0]
    msm = MSM(ops, get_field(cfg.fr_spec), c=13, strips=4, strip_threshold=32)
    G, pts = host_points(cfg, "g1", 20)
    pts[4] = None
    rng = np.random.default_rng(36)
    scalars = [[int.from_bytes(rng.bytes(32), "little") % cfg.host.R for _ in pts] for _ in range(3)]
    scalars[1][7] = 0
    scalars[2][:5] = [1, 2, cfg.host.R - 1, 2**200, 0]
    fr = msm.fr
    norm = fr.encode([s for row in scalars for s in row], mont=False).view(fr.n, 3, len(pts))
    got = g1_from_device_proj(msm.many(g1_to_device(pts, ops.fa.f), norm), ops.fa.f)
    want = []
    for row in scalars:
        acc = None
        for s, pt in zip(row, pts):
            acc = G.add(acc, G.mul(pt, s) if pt is not None else None)
        want.append(acc)
    assert got == want


def signed_digits(s, c, W):
    """The signed c-bit window digits of s, by hand."""
    out, carry = [], 0
    for w in range(W):
        d = ((s >> (c * w)) & ((1 << c) - 1)) + carry
        carry = int(d > 1 << (c - 1))
        out.append(d - (carry << c))
    return out


# a witness of bits down the strip path: G1 at a thousand points, G2 (whose
# plain Fp2 strip pass and scans cost ~5 times G1's on the CPU) at 160
BIT_WITNESS_POINTS = {"g1": 1100, "g2": 160}


@pytest.fixture(scope="module", params=["g1", "g2"])
def bit_witness_msm(request):
    """A c = 5 BN254 MSM down the strip path, its threshold lowered to the
    points, over the scalars of a witness of bits as ECADD64's: ~95 % 0 or 1,
    some 64-bit limbs, some full width, and 10 % of the bases at infinity.
    The MSM's window sums are summed by Horner on the host (the plain
    Horner's ~300 one-lane steps would take most of the test's time; its own
    test is above). G1 runs inside a recording, G2 outside one. Returns the
    group, the MSM, its sum and the host's, the counters' changes and a hand
    count of the DEAD records."""
    group = request.param
    n0, c = BIT_WITNESS_POINTS[group], 5
    cfg = get_curve("bn254")
    ops = curve_ops("bn254")[0 if group == "g1" else 1]
    msm = MSM(ops, get_field(cfg.fr_spec), c=c, strip_threshold=n0)
    msm._horner = lambda wsums: wsums  # the MSM returns its window sums
    rng = np.random.default_rng(37)
    R = cfg.host.R
    kind = rng.choice(3, size=n0, p=[0.95, 0.03, 0.02])
    scalars = [
        int(rng.integers(0, 2)) if t == 0 else int.from_bytes(rng.bytes(8 if t == 1 else 32), "little") % R
        for t in kind
    ]
    at_inf = rng.random(n0) < 0.1
    G = cfg.host.G1 if group == "g1" else cfg.host.G2
    pts, P = [], None
    for i in range(n0):  # P_i = (i + 1) g
        P = G.add(P, G.generator())
        pts.append(None if at_inf[i] else P)
    want = G.mul(G.generator(), sum(s * (i + 1) for i, s in enumerate(scalars) if not at_inf[i]) % R)
    fp, fr = ops.fa.f, msm.fr
    enc = g2_to_device if ops.fp2 else g1_to_device
    counts0 = dict(trace.COUNTS)
    if group == "g1":
        with trace.recording():
            wsums = msm(enc(pts, fp), fr.encode(scalars, mont=False))
    else:
        wsums = msm(enc(pts, fp), fr.encode(scalars, mont=False))
    counts = {k: v - counts0.get(k, 0) for k, v in trace.COUNTS.items()}
    wsums = tree_map(lambda a: a.reshape(a.shape[0], -1), wsums)  # (words, W)
    if ops.fp2:
        wsums = g2_from_device_proj(wsums, fp, cfg.host.Fp2, cfg.fp2_q)
    else:
        wsums = g1_from_device_proj(wsums, fp)
    got = None
    for S in reversed(wsums):
        got = G.add(G.mul(got, 1 << c) if got is not None else None, S)
    C, Rs = msm.strip_shape(n0)
    digits = [signed_digits(s, c, msm.n_windows) for s in scalars]
    dead = sum(
        sum(bool(at_inf[i]) or d[w] == 0 for i, d in enumerate(digits)) + C * Rs - n0 for w in range(msm.n_windows)
    )
    return group, msm, got, want, counts, dead


def test_msm_over_a_bit_witness_equals_the_host_sum(bit_witness_msm):
    group, msm, got, want, _, dead = bit_witness_msm
    C, R = msm.strip_shape(BIT_WITNESS_POINTS[group])
    assert dead > 0.8 * msm.n_windows * C * R  # most records reach no bucket
    assert got == want


def test_msm_record_counters(bit_witness_msm):
    """msm_records counts a strip pass's W x M records, always;
    msm_dead_records the DEAD ones (zero digits, infinity bases, the
    padding), and only inside a recording (G1 here; G2 runs outside)."""
    group, msm, _, _, counts, dead = bit_witness_msm
    C, R = msm.strip_shape(BIT_WITNESS_POINTS[group])
    assert counts["msm_records"] == msm.n_windows * C * R
    assert counts["msm_dead_records"] == (dead if group == "g1" else 0)


def test_fused_kernels_take_cuda_tensors_only():
    """A CPU tensor reaches no kernel: the wrappers refuse it before any
    build, and the MSM's phases take their plain versions instead."""
    cfg, ops, msm = engine("bn254", "g1")
    rng = np.random.default_rng(34)
    pts = tuple(coordinate(rng, ops, (2, 4)) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.scan_step(pts, 1, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.horner(pts, 5)
    key = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.strip(key, pts, 2, 2, 8, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bases = (coordinate(rng, ops, (4,)), coordinate(rng, ops, (4,)))
        ops.strip_mixed(key, key, key == 1, bases, 4, 2, 2, 8, 9)
