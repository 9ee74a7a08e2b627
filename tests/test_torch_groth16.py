"""Groth16 over BN254, BLS12-381 and BLS12-377 through the port
(tpusnark_torch.backend.groth16, plain versions on the CPU) against tpusnark
(host setup, JAX prover on the CPU) on the cubic circuit of
tests/test_groth16.py over each curve's r, with the same seeded setup and
prove rngs. Each side builds the circuit with its own builder and solves it
with its own solver. Exact: keys and proofs are compared point for point
(the containers are each package's own dataclasses, compared field by
field), device vectors as ints mod p. Both packages' host verifiers check
every proof, and for BLS12-381 also both ``bls381.verify`` (checked against
bellman's fixtures). BW6-761 is in tests/test_torch_groth16_bw6.py."""

import dataclasses
import inspect
import random
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.backend import groth16 as jg16
from tpusnark.backend.groth16 import bls381 as jbls381
from tpusnark.backend.groth16.prove import _abc_eval
from tpusnark.backend.groth16.prove import compute_h_dev as jax_compute_h
from tpusnark.constraint.solver import solve
from tpusnark.curves.config import get_curve
from tpusnark.fields.jfield import Field as JField
from tpusnark.frontend.builder import Builder
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.groth16 import bls381 as tbls381
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.solver import solve as tsolve
from tpusnark_torch import kernels
from tpusnark_torch.backend.groth16.keys import ported_curve
from tpusnark_torch.constraint import solver_torch as st
from tpusnark_torch.constraint.eval_torch import ABCEvaluator, abc_evaluator
from tpusnark_torch.convert import pk_tables, to_torch
from tpusnark_torch.fields.tfield import get_field, n_words
from tpusnark_torch.curves.config import get_curve as tget_curve
from tpusnark_torch.frontend.builder import Builder as TBuilder
from tpusnark_torch.poly.ntt import NTT, get_ntt

torch.set_num_threads(1)  # the suite's workers fill the cores already

jverify = import_module("tpusnark.backend.groth16.verify")  # the package's `verify` is the function

ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def cubic_circuit(r, builder=Builder):
    """x**3 + x + 5 == y over the field of r (tests/test_groth16.py), built
    with tpusnark's builder or the port's."""
    b = builder(r)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


def seeded(seed, r, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, r)


def verifiers(curve):
    """The host verifiers of the curve, the port's and tpusnark's: name ->
    verify(proof, vk, pubs)."""
    out = {
        "port verify": lambda proof, vk, pubs: tg16.verify(proof, vk, pubs, curve=curve),
        "tpusnark verify": lambda proof, vk, pubs: jverify.verify(proof, vk, pubs, curve=curve),
    }
    if curve == "bls12-381":

        def bls(B):
            def run(proof, vk, pubs):
                vkb = B.VerifyingKeyBLS(
                    alpha_g1=vk.alpha_g1,
                    beta_g1=vk.beta_g1,
                    beta_g2=vk.beta_g2,
                    gamma_g2=vk.gamma_g2,
                    delta_g1=vk.delta_g1,
                    delta_g2=vk.delta_g2,
                    k=vk.k,
                )
                return B.verify(B.ProofBLS(ar=proof.ar, bs=proof.bs, krs=proof.krs), vkb, pubs)

            return run

        out["port bls381.verify"] = bls(tbls381)
        out["tpusnark bls381.verify"] = bls(jbls381)
    return out


class Circuits:
    """The same circuit from each package's builder."""

    def __init__(self, r):
        self.port, self.jax = cubic_circuit(r, TBuilder), cubic_circuit(r, Builder)


@pytest.fixture(scope="module", params=("bn254", "bls12-381", "bls12-377"))
def keys(request):
    curve = request.param
    cfg = get_curve(curve)
    cs = Circuits(cfg.host.R)
    pk_t, vk_t = tg16.setup(cs.port, rng=seeded(42, cfg.host.R), device="cpu", curve=curve)
    pk_j, vk_j = jg16.setup(cs.jax, rng=seeded(42, cfg.host.R), use_device=False, curve=curve)
    return cfg, cs, pk_t, vk_t, pk_j, vk_j


def test_setup_matches_tpusnark_point_for_point(keys):
    cfg, _, pk_t, vk_t, pk_j, vk_j = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    assert (pk_t.curve, pk_t.domain_n, pk_t.k_wires) == (cfg.name, pk_j.domain_n, pk_j.k_wires)
    assert (pk_t.commitment_keys, vk_t.commitment_key, vk_t.public_and_commitment_committed) == ([], None, [])
    # the containers are the port's own dataclasses, with tpusnark's fields
    assert type(pk_t) is tg16.ProvingKey and type(pk_t) is not jg16.ProvingKey
    assert type(vk_t) is tg16.VerifyingKey and type(vk_t) is not jg16.VerifyingKey
    for ours, theirs in ((pk_t, pk_j), (vk_t, vk_j)):
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    # G2 coordinates are the port's copy of the curve's host Fp2 class
    port_fp2 = import_module(cfg.host.__name__.replace("tpusnark.", "tpusnark_torch.")).Fp2
    assert all(type(c) is port_fp2 for c in vk_t.delta_g2)
    assert [(c.c0, c.c1) for c in vk_t.delta_g2] == [(c.c0, c.c1) for c in vk_j.delta_g2]


def test_setup_tables_equal_tpusnark_device_tables(keys):
    """The affine tables setup leaves on the device are tpusnark's
    ProvingKey.device() arrays, converted to the port's words."""
    cfg, _, pk_t, _, pk_j, _ = keys
    fp = get_field(cfg.fp_spec)
    ours, theirs = device_tables(pk_t, "cpu"), pk_tables(pk_j.device(), cfg.fp_spec)
    for name in ("a", "b1", "b2", "k", "z"):
        for got, want in zip(_leaves(ours[name]), _leaves(theirs[name])):
            if got.dtype == want.dtype and got.dim() == 1:
                assert got.tolist() == want.tolist(), name
            else:
                assert got.shape[0] == n_words(cfg.fp_spec)
                assert fp.decode(got) == fp.decode(want), name


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_abc_and_compute_h_match_tpusnark(keys):
    cfg, cs, pk_t, _, _, _ = keys
    spec = cfg.fr_spec
    fr, jfr = get_field(spec), JField(spec)
    W = tsolve(cs.port, ASSIGN)
    assert W == solve(cs.jax, ASSIGN)
    A, B, C = abc_evaluator(cs.port, fr, "cpu")(fr.encode(W))
    jA, jB, jC = _abc_eval(cs.jax, jfr)(jnp.asarray(spec.encode(W, mont=True).T.copy()))
    for got, want in zip((A, B, C), (jA, jB, jC)):
        assert fr.decode(got) == jfr.to_ints(want)
    n = pk_t.domain_n
    h = tg16.compute_h_dev(A, B, C, n, spec)
    jh = jax_compute_h(jA, jB, jC, n, spec)
    assert h.shape == (n_words(spec), n - 1)
    assert fr.decode(h, mont=False) == jfr.to_ints(jh, mont=False)
    # the same H from tpusnark's own A/B/C converted into the port's layout
    hc = tg16.compute_h_dev(*to_torch((np.asarray(jA), np.asarray(jB), np.asarray(jC)), spec), n, spec)
    assert fr.decode(hc, mont=False) == fr.decode(h, mont=False)


def test_proof_matches_tpusnark_and_verifies(keys):
    cfg, cs, pk_t, vk_t, pk_j, _ = keys
    r = cfg.host.R
    timings = {}
    proof = tg16.prove(cs.port, pk_t, ASSIGN, rng=seeded(7, r, lo=0), timings=timings, device="cpu")
    want = jg16.prove(cs.jax, pk_j, ASSIGN, rng=seeded(7, r, lo=0))
    assert type(proof) is tg16.Proof
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert (proof.commitments, proof.commitment_pok) == (want.commitments, want.commitment_pok)
    assert set(timings) == {"solve", "encode", "h", "msm", "assemble"}
    for name, verify in verifiers(cfg.name).items():
        assert verify(proof, vk_t, [35]), name
        assert not verify(proof, vk_t, [36]), name


def test_dummy_setup_equals_tpusnark():
    """dummy_setup (gnark's DummySetup): the same seeded draw over BN254's r
    as tpusnark's, so the same key, point for point."""
    r = get_curve("bn254").host.R
    ours = import_module("tpusnark_torch.backend.groth16.setup").dummy_setup(cubic_circuit(r, TBuilder), device="cpu")
    theirs = import_module("tpusnark.backend.groth16.setup").dummy_setup(cubic_circuit(r), use_device=False)
    for name in PK_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.curve, ours.domain_n, ours.k_wires) == ("bn254", theirs.domain_n, theirs.k_wires)


def test_commitment_circuits_are_refused(keys):
    """BSB22 commitments are BN254-only, as in tpusnark: over BN254 a
    commitment circuit sets up, proves and verifies (tests/
    test_torch_groth16_commit.py holds it against tpusnark); over the BLS12
    curves setup and prove refuse it, as tpusnark's setup does."""
    cfg, _, pk_t, _, _, _ = keys
    b = TBuilder(cfg.host.R)
    x = b.secret("x")
    y = b.public("y")
    c = b.commit(x)
    b.assert_is_equal(b.add(b.mul(x, x), c, 0), b.add(y, c))
    cs = b.compile()
    if cfg.name == "bn254":
        pk, vk = tg16.setup(cs, rng=seeded(1, cfg.host.R), device="cpu", curve=cfg.name)
        proof = tg16.prove(cs, pk, {"x": 2, "y": 4}, rng=seeded(2, cfg.host.R, lo=0), device="cpu")
        assert len(proof.commitments) == 1 and proof.commitment_pok is not None
        assert tg16.verify(proof, vk, [4]) and not tg16.verify(proof, vk, [5])
        return
    with pytest.raises(NotImplementedError, match="BN254-only"):
        tg16.setup(cs, rng=seeded(1, cfg.host.R), device="cpu", curve=cfg.name)
    with pytest.raises(NotImplementedError, match="BN254-only"):
        tg16.prove(cs, pk_t, {"x": 2, "y": 4}, device="cpu")
    jcs = Builder(cfg.host.R)
    jx = jcs.secret("x")
    jc = jcs.commit(jx)
    jcs.assert_is_equal(jcs.add(jcs.mul(jx, jx), jc, 0), jcs.add(jcs.public("y"), jc))
    with pytest.raises(NotImplementedError, match="BN254-only"):
        jg16.setup(jcs.compile(), rng=seeded(1, cfg.host.R), use_device=False, curve=cfg.name)


@pytest.mark.parametrize("curve", ("bw6-633", "bls24-315"))
def test_curves_without_kernels_are_refused(curve):
    """setup and prove refuse a curve whose kernels are not ported, before
    any work, with NotImplementedError; `curve`, refused until its kernels
    came, is admitted now."""
    assert ported_curve(curve) is tget_curve(curve) and curve in kernels.CURVES
    cs = cubic_circuit(get_curve(curve).host.R, TBuilder)
    with pytest.raises(NotImplementedError, match="curve secp256k1: its kernels are not ported"):
        tg16.setup(cs, rng=seeded(1, cs.modulus), device="cpu", curve="secp256k1")
    pk = tg16.ProvingKey.__new__(tg16.ProvingKey)
    pk.curve = "secp256k1"
    with pytest.raises(NotImplementedError, match="curve secp256k1"):
        tg16.prove(cs, pk, ASSIGN, device="cpu")


@pytest.mark.parametrize("curve", ("bn254", "bw6-761"))
def test_entry_points_run_on_the_card_unless_the_caller_names_the_cpu(curve):
    """setup, prove and the ceremony's contributions (BN254 only)
    default to device="cuda": with no card they raise and do not fall back
    to the plain versions, the contributions even for an SRS under the
    device threshold (before any rng draw)."""
    mpc = tg16.mpcsetup
    for fn in (tg16.setup, tg16.prove, mpc.Phase1.contribute, mpc.Phase2.contribute):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    cs = cubic_circuit(get_curve(curve).host.R, TBuilder)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tg16.setup(cs, rng=seeded(1, cs.modulus), curve=curve)
    pk = tg16.ProvingKey.__new__(tg16.ProvingKey)
    pk.curve = curve
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tg16.prove(cs, pk, ASSIGN)
    if curve == "bn254":
        drawn = []
        rng = lambda: drawn.append(1) or 2  # noqa: E731
        for phase in (mpc.init_phase1(1), mpc.Phase2.__new__(mpc.Phase2)):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                phase.contribute(rng)
        assert not drawn


def test_layer_entry_points_run_on_the_card_unless_the_caller_names_the_cpu():
    """NTT, get_ntt, ABCEvaluator, abc_evaluator and the device solver's
    LevelSolver, get_level_solver, solve_torch(_ints) and solve_any default
    to the card, as setup and prove do: with no card they raise and do not
    fall back to the plain versions (nor, for solve_any, to the host
    solver); named, the CPU runs them."""
    solver_fns = (st.LevelSolver.__init__, st.get_level_solver, st.solve_torch, st.solve_torch_ints, st.solve_any)
    for fn in (NTT.__init__, get_ntt, ABCEvaluator.__init__, abc_evaluator) + solver_fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    spec = get_curve("bn254").fr_spec
    cs = cubic_circuit(get_curve("bn254").host.R, TBuilder)
    fr = get_field(spec)
    assert get_ntt(spec, 8, "cpu").device.type == "cpu" and abc_evaluator(cs, fr, "cpu").device.type == "cpu"
    assert st.get_level_solver(cs, spec, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    for make in (
        lambda: NTT(spec, 8),
        lambda: get_ntt(spec, 8),
        lambda: ABCEvaluator(cs, fr),
        lambda: abc_evaluator(cs, fr),
        lambda: st.LevelSolver(cs, fr),
        lambda: st.get_level_solver(cs, spec),
        lambda: st.solve_torch(cs, ASSIGN, spec),
        lambda: st.solve_any(cs, ASSIGN, spec),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
