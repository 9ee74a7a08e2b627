"""Groth16 over BN254 and BLS12-381 through the port
(tpusnark_torch.backend.groth16, plain versions on the CPU) against tpusnark
(host setup, JAX prover on the CPU) on the cubic circuit of
tests/test_groth16.py over each curve's r, with the same seeded setup and
prove rngs. Exact: keys and proofs are compared point for point, device
vectors as ints mod p. tpusnark's host verifier checks every proof, and for
BLS12-381 also ``bls381.verify`` (checked against bellman's fixtures)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from tpusnark.backend import groth16 as jg16
from tpusnark.backend.groth16.prove import _abc_eval
from tpusnark.backend.groth16.prove import compute_h_dev as jax_compute_h
from tpusnark.constraint.solver import solve
from tpusnark.curves.config import get_curve
from tpusnark.fields.jfield import Field as JField
from tpusnark.frontend.builder import Builder
from tpusnark_torch import _host
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.eval_torch import abc_evaluator
from tpusnark_torch.convert import pk_tables, to_torch
from tpusnark_torch.fields.tfield import get_field, n_words

ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def cubic_circuit(r):
    """x**3 + x + 5 == y over the field of r (tests/test_groth16.py)."""
    b = Builder(r)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


def seeded(seed, r, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, r)


def verifiers(curve):
    """The host verifiers of the curve: name -> verify(proof, vk, pubs)."""
    out = {"verify": lambda proof, vk, pubs: _host.verify.verify(proof, vk, pubs, curve=curve)}
    if curve == "bls12-381":
        B = _host.bls381

        def bls(proof, vk, pubs):
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

        out["bls381.verify"] = bls
    return out


@pytest.fixture(scope="module", params=("bn254", "bls12-381"))
def keys(request):
    curve = request.param
    cfg = get_curve(curve)
    cs = cubic_circuit(cfg.host.R)
    pk_t, vk_t = tg16.setup(cs, rng=seeded(42, cfg.host.R), curve=curve)
    pk_j, vk_j = jg16.setup(cs, rng=seeded(42, cfg.host.R), use_device=False, curve=curve)
    return cfg, cs, pk_t, vk_t, pk_j, vk_j


def test_setup_matches_tpusnark_point_for_point(keys):
    cfg, _, pk_t, vk_t, pk_j, vk_j = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    assert (pk_t.curve, pk_t.domain_n, pk_t.k_wires) == (cfg.name, pk_j.domain_n, pk_j.k_wires)
    assert isinstance(pk_t, jg16.ProvingKey)
    assert all(type(c) is cfg.host.Fp2 for c in vk_t.delta_g2)


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
    W = solve(cs, ASSIGN)
    A, B, C = abc_evaluator(cs, fr, "cpu")(fr.encode(W))
    jA, jB, jC = _abc_eval(cs, jfr)(jnp.asarray(spec.encode(W, mont=True).T.copy()))
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
    proof = tg16.prove(cs, pk_t, ASSIGN, rng=seeded(7, r, lo=0), timings=timings)
    want = jg16.prove(cs, pk_j, ASSIGN, rng=seeded(7, r, lo=0))
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert set(timings) == {"solve", "encode", "h", "msm", "assemble"}
    for name, verify in verifiers(cfg.name).items():
        assert verify(proof, vk_t, [35]), name
        assert not verify(proof, vk_t, [36]), name


def test_commitment_circuits_are_refused(keys):
    """BSB22 commitments are not ported: setup and prove refuse them."""
    cfg, _, pk_t, _, _, _ = keys
    b = Builder(cfg.host.R)
    x = b.secret("x")
    y = b.public("y")
    c = b.commit(x)
    b.assert_is_equal(b.add(b.mul(x, x), c, 0), b.add(y, c))
    cs = b.compile()
    with pytest.raises(NotImplementedError):
        tg16.setup(cs, rng=seeded(1, cfg.host.R), curve=cfg.name)
    with pytest.raises(NotImplementedError):
        tg16.prove(cs, pk_t, {"x": 2, "y": 4})


@pytest.mark.parametrize("curve", ("bls12-377", "bw6-761"))
def test_curves_without_kernels_are_refused(curve):
    """setup and prove refuse a curve whose kernels are not ported, before
    any work, with NotImplementedError."""
    cs = cubic_circuit(get_curve(curve).host.R)
    with pytest.raises(NotImplementedError, match=f"curve {curve}: its kernels are not ported"):
        tg16.setup(cs, rng=seeded(1, cs.modulus), curve=curve)
    pk = jg16.ProvingKey.__new__(jg16.ProvingKey)
    pk.curve = curve
    with pytest.raises(NotImplementedError, match=f"curve {curve}"):
        tg16.prove(cs, pk, ASSIGN)
