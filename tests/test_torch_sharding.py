"""The port's sharded device layer (tpusnark_torch/parallel/sharding.py,
backend/groth16/sharded.py, backend/plonk/sharded.py, parallel/dryrun.py)
on lists of CPU devices.

* tests/test_sharding.py's seven cases, ported (its two `slow` marks kept);
* each sharded module against tpusnark's own on its 8-device CPU mesh
  (tests/conftest.py sets the devices) over ("cpu",) * 8: ShardedNTT at
  n = 256 and at n = 32 < 8^2 (the fallback split), ShardedMSM and .many at
  n = 64, c = 4, tree_add_batch at n = 5; values compared as ints mod p,
  points in affine form (the tree: projective, coordinate for coordinate);
* the slice as a whole: the sharded Groth16 and PLONK proofs equal the
  port's unsharded proofs under one seeded rng, verify, and a wrong input is
  rejected; dryrun_multichip gives those proofs.

The whole proves run over ("cpu",) * 2: on the CPU an MSM of the plain group
law costs ~2 s whatever its size (its window sums take ~255 sequential
doublings), so every shard adds one such MSM per commitment, and a Groth16
prove over eight CPU shards takes ~100 s. The split, the gathers, the
transposes and the tree are the same code at any device count."""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from tpusnark.curves import encoding as jenc
from tpusnark.curves import jcurve
from tpusnark.fields.jfield import get_field as jget_field
from tpusnark.fields.spec import BN254_FP as JBN254_FP
from tpusnark.fields.spec import BN254_FR as JBN254_FR
from tpusnark.msm import pippenger as jpip
from tpusnark.parallel import sharding as jsharding
from tpusnark_torch.backend import groth16, plonk
from tpusnark_torch.backend.groth16.sharded import prove_sharded
from tpusnark_torch.backend.plonk.sharded import prove_sharded as plonk_prove_sharded
from tpusnark_torch.curves.encoding import g1_from_device_proj, g1_to_device
from tpusnark_torch.curves.ref import G1, R
from tpusnark_torch.fields.spec import BN254_FP, BN254_FR
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.frontend.builder import Builder
from tpusnark_torch.msm.pippenger import get_msm
from tpusnark_torch.parallel import dryrun
from tpusnark_torch.parallel.sharding import ShardedMSM, ShardedNTT, mesh_devices, tree_add_batch
from tpusnark_torch.poly.ntt import get_ntt

torch.set_num_threads(1)  # the suite's workers fill the cores already

CPU8 = ("cpu",) * 8
CPU2 = ("cpu",) * 2
fr, fp = get_field(BN254_FR), get_field(BN254_FP)
jfr, jfp = jget_field(JBN254_FR), jget_field(JBN254_FP)


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.sharding.Mesh(np.array(devs[:8]), ("data",))


def _points(n, seed=3):
    """G, 2G, ..., nG and n seeded scalars (tests/test_sharding.py)."""
    rng = np.random.default_rng(seed)
    base = G1.generator()
    pts, P = [], base
    for _ in range(n):
        pts.append(P)
        P = G1.add(P, base)
    scal = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]
    return pts, scal


def _host_sum(pts, scal):
    acc = None
    for pt, s in zip(pts, scal):
        acc = G1.add(acc, G1.mul(pt, s))
    return acc


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]


# ------------------------------------------------------------ the MSM
MSM_N, MSM_C, MSM_K = 64, 4, 2


@pytest.fixture(scope="module")
def msm_case():
    """The port's ShardedMSM over eight CPU shards at n = 64, c = 4: the
    table, its scalars and the sums of __call__ and of .many (k = 2)."""
    pts, scal = _points(MSM_N)
    many = [_values(MSM_N, 20 + i) for i in range(MSM_K)]
    smsm = ShardedMSM(get_msm("g1", MSM_C, "bn254"), CPU8)
    table = smsm.shard_points(g1_to_device(pts, fp))
    one = g1_from_device_proj(smsm(table, fr.encode(scal, mont=False)), fp)
    stack = fr.encode([v for row in many for v in row], mont=False).view(fr.n, MSM_K, MSM_N)
    k = g1_from_device_proj(smsm.many(table, stack), fp)
    return pts, scal, many, table, one, k


def test_sharded_msm_matches_oracle(msm_case):
    pts, scal, many, table, one, k = msm_case
    assert len(table) == 8 and all(part[2].shape == (MSM_N // 8,) for part in table)
    assert one == [_host_sum(pts, scal)]
    assert k == [_host_sum(pts, row) for row in many]


@pytest.mark.slow
def test_sharded_msm_matches_single_chip():
    pts, scal = _points(128, seed=4)
    msm = get_msm("g1", 5, "bn254")
    dev = g1_to_device(pts, fp)
    sc = fr.encode(scal, mont=False)
    smsm = ShardedMSM(msm, CPU8)
    assert g1_from_device_proj(smsm(smsm.shard_points(dev), sc), fp) == g1_from_device_proj(msm(dev, sc), fp)


def test_sharded_msm_and_many_equal_tpusnark(msm_case, mesh):
    pts, scal, many, _, one, k = msm_case
    jsmsm = jsharding.ShardedMSM(jpip.get_msm("g1", c=MSM_C), mesh, "data")
    jtable = jsmsm.shard_points(jenc.g1_to_device(pts))
    assert jenc.g1_from_device_proj(jsmsm(jtable, JBN254_FR.encode(scal, mont=False).T.copy())) == one
    flat = [v for row in many for v in row]
    jstack = JBN254_FR.encode(flat, mont=False).T.copy().reshape(-1, MSM_K, MSM_N)
    assert jenc.g1_from_device_proj(jsmsm.many(jtable, jstack)) == k


def test_sharded_msm_points_must_split():
    smsm = ShardedMSM(get_msm("g1", MSM_C, "bn254"), CPU8)
    pts, _ = _points(12)
    with pytest.raises(ValueError, match="do not split"):
        smsm.shard_points(g1_to_device(pts, fp))


def test_tree_add_batch_equals_tpusnark():
    """n = 5: an odd count (padded with the identity) and an infinity lane;
    both packages' group law is RCB15's, so the projective sums agree
    coordinate for coordinate."""
    host = [G1.mul(G1.generator(), k) for k in (3, 5, 7, 11)] + [None]
    ops = get_msm("g1", MSM_C, "bn254").ops
    got = tree_add_batch(ops, ops.from_affine(g1_to_device(host, fp)), 5)
    jops = jcurve.g1_ops(jfp)
    want = jsharding.tree_add_batch(jops, jops.from_affine(jenc.g1_to_device(host)), 5)
    assert [fp.decode(c) for c in got] == [[v % fp.modulus for v in jfp.to_ints(c)] for c in want]
    assert g1_from_device_proj(got, fp) == [G1.mul(G1.generator(), 26)]


# ------------------------------------------------------------ the NTT
@pytest.mark.parametrize("n", [256, 32])
def test_sharded_ntt_equals_tpusnark(n, mesh):
    """ntt, intt, ntt_coset and intt_coset over eight CPU shards against
    tpusnark's ShardedNTT on its mesh; n = 32 < 8^2 takes the fallback
    split (n1 = 8, n2 = 4: the j2 stage whole on devices[0])."""
    sntt = ShardedNTT(BN254_FR, n, CPU8)
    jsntt = jsharding.ShardedNTT(JBN254_FR, n, mesh, "data")
    assert (sntt.n1, sntt.n2) == (jsntt.n1, jsntt.n2) == ((8, 32) if n == 256 else (8, 4))
    xs = _values(n, n)
    x, jx = fr.encode(xs), jfr.array(xs)
    for name in ("ntt", "intt", "ntt_coset", "intt_coset"):
        got = fr.decode(getattr(sntt, name)(x))
        assert got == [v % R for v in jfr.to_ints(getattr(jsntt, name)(jx))], name


def test_sharded_ntt_matches_single():
    n = 256
    sntt = ShardedNTT(BN254_FR, n, CPU8)
    ntt = get_ntt(BN254_FR, n, "cpu")
    x = fr.encode(_values(n, 5))
    assert fr.decode(sntt.ntt(x)) == fr.decode(ntt.ntt(x))
    assert fr.decode(sntt.intt(sntt.ntt(x))) == fr.decode(x)


def test_sharded_ntt_coset_roundtrip():
    n = 64
    sntt = ShardedNTT(BN254_FR, n, CPU8)
    x = fr.encode(_values(n, 6))
    assert fr.decode(sntt.intt_coset(sntt.ntt_coset(x))) == fr.decode(x)


def test_sharded_ntt_batches_and_matches_the_ntt():
    """(words, 3, n) in one call: each row the port's NTT of it."""
    n = 64
    sntt, ntt = ShardedNTT(BN254_FR, n, CPU8), get_ntt(BN254_FR, n, "cpu")
    x = fr.encode(_values(3 * n, 7)).view(fr.n, 3, n)
    for name in ("ntt", "intt", "ntt_coset", "intt_coset"):
        assert fr.decode(getattr(sntt, name)(x)) == fr.decode(getattr(ntt, name)(x)), name


def test_devices_default_to_every_card_and_raise_without_one():
    assert mesh_devices(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    if torch.cuda.is_available():
        assert len(mesh_devices()) == torch.cuda.device_count()
        return
    for make in (mesh_devices, lambda: ShardedNTT(BN254_FR, 16), lambda: ShardedMSM(get_msm("g1", 4, "bn254"))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    with pytest.raises(ValueError, match="empty"):
        mesh_devices(())


# ------------------------------------------------------------ the provers
@pytest.fixture(scope="module")
def demo():
    """The demo circuits' keys (dryrun's, cached per device), the unsharded
    Groth16 proof under Random(1) and PLONK proof under Random(2), and
    dryrun_multichip's sharded proofs over two CPU devices with seed 1 (so
    under the same rngs)."""
    cs, pk, vk = dryrun._demo_keys("cpu")
    pcs, assignment, ppk, pvk = dryrun._plonk_keys("cpu")
    y = (pow(3, 41, R) + 3 + 5) % R
    r1, r2 = random.Random(1), random.Random(2)
    proof = groth16.prove(cs, pk, {"x": 3, "y": y}, rng=lambda: r1.randrange(R), device="cpu")
    pproof = plonk.prove(pcs, ppk, assignment, rng=lambda: r2.randrange(1, R))
    sharded = dryrun.dryrun_multichip(CPU2, seed=1)
    return (cs, pk, vk, y, proof), (pcs, assignment, ppk, pvk, pproof), sharded


def test_dryrun_multichip(demo):
    """dryrun_multichip proved and verified both circuits over two CPU
    devices; its proofs equal the unsharded ones under the same rngs."""
    (_, _, _, _, proof), (_, _, _, _, pproof), sharded = demo
    assert sharded == (proof, pproof)


def test_prove_sharded_verifies(demo):
    """The sharded Groth16 proof verifies and a wrong public input is
    rejected."""
    (_, _, vk, y, _), _, (proof, _) = demo
    assert groth16.verify(proof, vk, [y])
    assert not groth16.verify(proof, vk, [(y + 1) % R])


def test_plonk_prove_sharded_equals_unsharded(demo):
    _, (_, assignment, _, vk, want), (_, proof) = demo
    assert proof == want
    assert plonk.verify(proof, vk, [assignment["y"]])
    assert not plonk.verify(proof, vk, [(assignment["y"] + 1) % R])


def test_sharded_cores_and_engines_are_cached_on_the_key(demo):
    """Each proving key holds one sharded core (Groth16) or engine (PLONK)
    per circuit and device list: the tables are placed once."""
    from tpusnark_torch.backend.groth16.sharded import _core_cache
    from tpusnark_torch.backend.plonk.sharded import _engine_cache

    (cs, pk, _, _, _), (_, _, ppk, _, _), _ = demo
    core = _core_cache(cs, pk, CPU2)
    assert _core_cache(cs, pk, ["cpu", "cpu"]) is core and core.m == 64 and len(core._pts["a"]) == 2
    eng = _engine_cache(ppk, CPU2)
    assert _engine_cache(ppk, CPU2) is eng and eng.m % 2 == 0 and eng.m >= len(ppk.srs.g1)
    assert eng.place(torch.zeros(3)).device == ppk.device


def test_sharded_prover_is_bn254_only(demo):
    from tpusnark_torch.backend.groth16.sharded import ShardedProverCore

    (cs, pk, _, _, _), _, _ = demo
    with pytest.raises(NotImplementedError, match="BN254-only"):
        ShardedProverCore(cs, dataclasses.replace(pk, curve="bls12-381"), CPU2)


@pytest.mark.slow
def test_prove_sharded_awkward_wire_count():
    """Wire counts that do not align with the devices."""
    b = Builder(R)
    xs = [b.secret(f"x{i}") for i in range(3)]
    y = b.public("y")
    z = b.mul(xs[0], xs[1])
    z = b.mul(z, xs[2])
    for _ in range(9):
        z = b.mul(z, xs[0])
    b.assert_is_equal(z, y)
    cs = b.compile()
    yv = 2 * 3 * 5 * pow(2, 9, R) % R
    rng_state = np.random.default_rng(9)
    pk, vk = groth16.setup(cs, rng=lambda: int(rng_state.integers(1, 1 << 62)), device="cpu")
    proof = prove_sharded(cs, pk, {"x0": 2, "x1": 3, "x2": 5, "y": yv}, CPU8)
    assert groth16.verify(proof, vk, [yv])


def test_prove_sharded_bsb22():
    """The sharded prover installs the BSB22 hint override and carries the
    commitment and its proof of knowledge; its phases are timed."""
    from tpusnark_torch.curves.marshal import g1_raw
    from tpusnark_torch.curves.pedersen import pedersen_commit
    from tpusnark_torch.utils.hash_to_field import COMMITMENT_DST, hash_to_field

    b = Builder(R)
    x = b.secret("x")
    pub = b.public("pub")
    c = b.commit(x, pub)
    x3 = b.mul(x, x, x)
    # pad the domain past the devices' count
    acc = x
    for _ in range(12):
        acc = b.mul(acc, x)
    b.assert_is_equal(acc, b.mul(x3, x3, x3, x3, x))
    b.assert_is_equal(b.add(x3, b.mul(c, x), 5, pub), b.public("y"))
    cs = b.compile()
    st = random.Random(7)
    rng = lambda: st.randrange(1, R)  # noqa: E731
    pk, vk = groth16.setup(cs, rng=rng, device="cpu")
    xv, pubv = 3, 11
    C = pedersen_commit(pk.commitment_keys[0], [xv])
    (ch,) = hash_to_field(g1_raw(C) + pubv.to_bytes(32, "big"), COMMITMENT_DST, R)
    yv = (pow(xv, 3, R) + ch * xv + 5 + pubv) % R
    timings = {}
    proof = prove_sharded(cs, pk, {"x": xv, "pub": pubv, "y": yv}, CPU2, rng=rng, timings=timings)
    assert proof.commitments == [C] and proof.commitment_pok is not None
    assert groth16.verify(proof, vk, [pubv, yv])
    assert not groth16.verify(proof, vk, [pubv, (yv + 1) % R])
    assert sorted(timings) == sorted(("solve", "encode", "h", "msm", "assemble"))
