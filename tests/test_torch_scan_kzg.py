"""The port's prefix scan (tpusnark_torch.poly.scan) and KZG
(tpusnark_torch.poly.kzg) on the CPU, against Python integers and against
tpusnark's KZG (JAX on the CPU) on the same seeded inputs: the scan at
lengths that are and are not powers of two, with a distinct point per
polynomial (only then does a swapped combine show); synthetic division,
batched evaluation, openings and the composite-key commit; the unsafe SRS on
its host path and on its fixed-base path; the host verifiers' verdicts on a
good and a bad opening; auto_c_many over a grid. Exact: device outputs are
lazy in [0, 2p), so values are compared as ints mod p."""

import itertools
import random

import pytest
import torch

import tpusnark.msm.pippenger as jpip
import tpusnark.poly.kzg as jkzg
from tpusnark.fields.jfield import get_field as jget_field
from tpusnark.fields.spec import BN254_FR as JBN254_FR
from tpusnark_torch.curves.ref import G1
from tpusnark_torch.fields.spec import BN254_FP, BN254_FR
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.msm import pippenger as tpip
from tpusnark_torch.poly import kzg as tkzg
from tpusnark_torch.poly import scan

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
fr, fp = get_field(BN254_FR), get_field(BN254_FP)
jfr = jget_field(JBN254_FR)
LENGTHS = (1, 2, 3, 7, 8, 33)
TAU = 0x5EED_7A0


def ints(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def horner_suffixes(coeffs, z):
    """[value after folding coefficients n-1 .. n-1-k for each k]."""
    out, acc = [], 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % P
        out.append(acc)
    return out


def rows(polys):
    """(words, B, n) Montgomery words of B equal-length polynomials."""
    return fr.encode([c for poly in polys for c in poly]).view(fr.n, len(polys), -1)


@pytest.mark.parametrize("n", LENGTHS)
def test_prefix_product_equals_cumulative_products(n):
    xs = ints(n, n)
    got = fr.decode(scan.prefix_mul(fr, fr.encode(xs)))
    assert got == list(itertools.accumulate(xs, lambda a, b: a * b % P))


@pytest.mark.parametrize("n", LENGTHS)
def test_horner_scan_and_division_equal_python(n):
    polys, zs = [ints(n, 10 + n), ints(n, 20 + n)], [3, ints(1, 30 + n)[0]]
    for poly, z in zip(polys, zs):  # one point per polynomial, as a batch of one
        accs = scan.horner_scan(fr, rows([poly]), fr.encode([z])[:, 0])
        assert fr.decode(accs) == horner_suffixes(poly, z)
        q, pz = scan.div_linear(fr, rows([poly]), fr.encode([z])[:, 0])
        assert (fr.decode(q), fr.decode(pz)[0]) == tkzg._div_by_linear_host(poly, z)
    # a batch at one point: every row its own Horner
    evals = scan.horner_evals(fr, rows(polys), fr.encode([zs[1]])[:, 0])
    assert fr.decode(evals) == [horner_suffixes(poly, zs[1])[-1] for poly in polys]


def test_associative_scan_keeps_the_earlier_operand_first():
    """A non-commutative combine (2x2 integer matrices): each output is the
    product of its prefix in order, at a length that is not a power of two."""
    mats = [torch.tensor([[1, i], [i % 3, 1]], dtype=torch.int64) for i in range(11)]
    x = torch.stack(mats, dim=-1)  # (2, 2, 11)
    got = scan.associative_scan(lambda a, b: torch.einsum("ijn,jkn->ikn", a, b), x)
    want = list(itertools.accumulate(mats, lambda a, b: a @ b))
    assert all(torch.equal(got[..., i], w) for i, w in enumerate(want))


@pytest.mark.parametrize("n", (1, 7))
def test_div_by_linear_and_eval_many_equal_tpusnark(n):
    polys, z = [ints(n, 40 + n), ints(n, 50 + n), ints(n, 60 + n)], ints(1, 70 + n)[0]
    q, pz = tkzg.div_by_linear_dev(rows(polys), z)
    jq, jpz = jkzg.div_by_linear_dev(jfr.array([c for poly in polys for c in poly]).reshape(jfr.n, 3, n), z)
    assert fr.decode(q) == [v % P for v in jfr.to_ints(jq)]
    assert fr.decode(pz) == [v % P for v in jfr.to_ints(jpz)]
    host = [tkzg._div_by_linear_host(poly, z) for poly in polys]
    assert fr.decode(q) == [c for hq, _ in host for c in hq]
    assert tkzg.eval_many_dev(rows(polys), z) == [pz for _, pz in host]
    assert [v % P for v in jkzg.eval_many_dev(jfr.array([c for p in polys for c in p]).reshape(jfr.n, 3, n), z)] == [
        pz for _, pz in host
    ]


@pytest.fixture(scope="module")
def srs():
    """The port's and tpusnark's SRS of 40 powers (host path), same tau."""
    ours, theirs = tkzg.new_srs_unsafe(40, tau=TAU, device="cpu"), jkzg.new_srs_unsafe(40, tau=TAU)
    return ours, theirs


def test_small_srs_equals_tpusnark(srs):
    ours, theirs = srs
    assert ours.g1 == theirs.g1 and ours.g2 == theirs.g2
    assert ours.g1[1] == G1.mul(G1.generator(), TAU)


def test_commits_and_openings_equal_tpusnark_and_host_sums(srs):
    ours, theirs = srs
    polys = [ints(33, 80), ints(33, 81), [0] * 5 + ints(28, 82)]
    norm = fr.encode([c for poly in polys for c in poly], mont=False).view(fr.n, 3, 33)
    many = tkzg.commit_many_dev(ours, norm)
    host = [tkzg.commit_ints(ours, poly, device="cpu") for poly in polys]
    assert many == host == [jkzg.commit_ints(theirs, poly) for poly in polys]
    assert [tkzg.commit_dev(ours, norm[:, i]) for i in range(3)] == host
    z = ints(1, 83)[0]
    value, proof = tkzg.open_dev(ours, rows(polys[:1])[:, 0], z)
    assert (value, proof) == tkzg.open_ints(ours, polys[0], z, device="cpu") == jkzg.open_ints(theirs, polys[0], z)


def test_composite_commit_equals_tpusnark_msm_many(srs):
    """commit_many_dev against tpusnark's commit_many_dev (MSM.many over the
    SRS points) at k = 2 and 130 points: both past the ladder, on the
    log-scan path at auto_c_many's window size."""
    ours = tkzg.new_srs_unsafe(130, tau=TAU, device="cpu")
    theirs = jkzg.SRS(g1=ours.g1, g2=ours.g2)
    polys = [ints(130, 90), [0, 1] * 65]
    norm = fr.encode([c for poly in polys for c in poly], mont=False).view(fr.n, 2, 130)
    jnorm = jfr.array([c for poly in polys for c in poly], mont=False).reshape(jfr.n, 2, 130)
    assert tkzg.commit_many_dev(ours, norm) == jkzg.commit_many_dev(theirs, jnorm)


def test_fixed_base_srs_equals_tpusnark():
    """From 2^10 powers the SRS is a batched fixed-base multiplication (on
    the CPU here, the plain mixed adds), normalised to affine on the device:
    the same points as tpusnark's, and its device copy is that table."""
    n = tkzg.DEVICE_SRS_MIN
    ours = tkzg.new_srs_unsafe(n, tau=TAU, device="cpu")
    theirs = jkzg.new_srs_unsafe(n, tau=TAU)
    assert ours.g1 == theirs.g1 and ours.g2 == theirs.g2
    X, Y, inf = ours.device("cpu")["g1"]
    assert not inf.any() and list(zip(fp.decode(X), fp.decode(Y))) == ours.g1


def test_host_verifiers_give_tpusnark_verdicts(srs):
    ours, theirs = srs
    poly = ints(20, 95)
    C = tkzg.commit_ints(ours, poly, device="cpu")
    z, z2 = ints(2, 96)
    v, H = tkzg.open_ints(ours, poly, z, device="cpu")
    v2, H2 = tkzg.open_ints(ours, poly, z2, device="cpu")
    for mod, s in ((tkzg, ours), (jkzg, theirs)):
        assert mod.verify_opening(s, C, z, v, H)
        assert not mod.verify_opening(s, C, z, (v + 1) % P, H)
        assert mod.batch_verify_multi_points(s, [(C, z, v, H), (C, z2, v2, H2)], lam=7)
        assert not mod.batch_verify_multi_points(s, [(C, z, v, H), (C, z2, v, H2)], lam=7)
    # a folded opening of two polynomials at one point
    other = ints(20, 97)
    C2 = tkzg.commit_ints(ours, other, device="cpu")
    nu = 11
    folded = [(a + nu * b) % P for a, b in zip(poly, other)]
    fv, fH = tkzg.open_ints(ours, folded, z, device="cpu")
    vals = [v, tkzg._div_by_linear_host(other, z)[1]]
    for mod, s in ((tkzg, ours), (jkzg, theirs)):
        assert mod.batch_verify_single_point(s, [C, C2], z, vals, fH, nu)
        assert not mod.batch_verify_single_point(s, [C, C2], z, [vals[0], vals[1] + 1], fH, nu)
    assert fv == (vals[0] + nu * vals[1]) % P


def test_auto_c_many_equals_tpusnark():
    for n, k in itertools.product((1, 10, 96, 1000, 1 << 12, 131074, 1 << 17, 1 << 20), (1, 2, 3, 8)):
        assert tpip.auto_c_many(n, k) == jpip.auto_c_many(n, k), (n, k)
    assert tpip.auto_c_many(131074, 3) == tpip.auto_c_many(131074, 2) == 13
    assert tpip.get_msm_many_for("g1", 131074, 3, "bn254").c == 13


@pytest.mark.parametrize("k", (1, 7, 40))
def test_field_sum_equals_tpusnark(k):
    """Field.sum over a batch axis: int64 column sums, then reduce_columns;
    inputs anywhere in the lazy range [0, 2p)."""
    vals = ints(3 * k, 100 + k)
    vals[:2] = [P - 1, 0]
    # the Montgomery words of each value, every third one as its lazy
    # representative in [p, 2p)
    mont = [v * fr.r % P + (P if i % 3 == 0 else 0) for i, v in enumerate(vals)]
    words = [[(x >> (32 * w)) & 0xFFFFFFFF for x in mont] for w in range(fr.n)]
    a = torch.tensor(words, dtype=torch.int64).to(torch.int32).view(fr.n, k, 3)
    got = fr.decode(fr.sum(a, axis=1))
    want = [sum(vals[j * 3 + c] for j in range(k)) % P for c in range(3)]
    assert got == want
    ja = jfr.array(vals).reshape(jfr.n, k, 3)
    assert [v % P for v in jfr.to_ints(jfr.sum(ja, axis=1))] == want
    with pytest.raises(ValueError, match="2\\^16"):
        fr.sum(torch.zeros((fr.n, (1 << 16) + 1, 1), dtype=torch.int32), axis=1)
