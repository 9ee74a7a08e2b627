"""Groth16 over BW6-761 (fr 12 words, fp 24 words, G2 over Fp itself)
through the port (tpusnark_torch.backend.groth16, plain versions on the CPU)
on the cubic circuit of tests/test_groth16.py.

tpusnark's own BW6-761 prove compiles 48-limb kernels for minutes and is
marked slow in its tests, so here the port is held against the pieces of
tpusnark that stay cheap: its host setup point for point, its device tables,
its ``_abc_eval`` and ``compute_h_dev`` (field only, 24 limbs), the proof
that its host code computes from the replayed toxic waste, and its host
verifier, which must accept the port's proof (four Miller loops of about a
minute each in Python integers: the one long test of this file). The proof
for proof comparison with the JAX prover, and the rejection of a wrong public
input, run under the ``slow`` marker. Exact: points and ints mod p."""

import dataclasses
import random
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.backend import groth16 as jg16
from tpusnark.backend.groth16.prove import _abc_eval
from tpusnark.backend.groth16.prove import compute_h_dev as jax_compute_h
from tpusnark.constraint.solver import solve
from tpusnark.curves.config import get_curve
from tpusnark.fields.jfield import Field as JField
from tpusnark.frontend.builder import Builder
from tpusnark.poly.domain import Domain
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.eval_torch import abc_evaluator
from tpusnark_torch.constraint.solver import solve as tsolve
from tpusnark_torch.convert import pk_tables, to_torch
from tpusnark_torch.fields.tfield import get_field, n_words
from tpusnark_torch.frontend.builder import Builder as TBuilder

torch.set_num_threads(1)  # the suite's workers fill the cores already

# the package's `verify` and `setup` are the functions: the submodules by name
jverify = import_module("tpusnark.backend.groth16.verify")
jsetup = import_module("tpusnark.backend.groth16.setup")

CURVE = "bw6-761"
ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def cubic_circuit(r, builder):
    b = builder(r)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


def seeded(seed, r, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, r)


@pytest.fixture(scope="module")
def keys():
    cfg = get_curve(CURVE)
    r = cfg.host.R
    cs_t, cs_j = cubic_circuit(r, TBuilder), cubic_circuit(r, Builder)
    pk_t, vk_t = tg16.setup(cs_t, rng=seeded(42, r), device="cpu", curve=CURVE)
    pk_j, vk_j = jg16.setup(cs_j, rng=seeded(42, r), use_device=False, curve=CURVE)
    return cfg, cs_t, cs_j, pk_t, vk_t, pk_j, vk_j


@pytest.fixture(scope="module")
def proof(keys):
    cfg, cs_t, _, pk_t, _, _, _ = keys
    timings = {}
    out = tg16.prove(cs_t, pk_t, ASSIGN, rng=seeded(7, cfg.host.R, lo=0), timings=timings, device="cpu")
    assert set(timings) == {"solve", "encode", "h", "msm", "assemble"}
    return out


def test_setup_matches_tpusnark_host_setup_point_for_point(keys):
    cfg, _, _, pk_t, vk_t, pk_j, vk_j = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    assert (pk_t.curve, pk_t.domain_n, pk_t.k_wires) == (CURVE, pk_j.domain_n, pk_j.k_wires)
    assert type(pk_t) is tg16.ProvingKey and type(pk_t) is not jg16.ProvingKey
    assert [f.name for f in dataclasses.fields(pk_t)] == [f.name for f in dataclasses.fields(pk_j)]
    # G2 over Fp: plain int pairs, of the full 761 bits
    assert all(isinstance(c, int) for c in vk_t.delta_g2)
    assert max(c for pt in pk_t.b2 if pt for c in pt).bit_length() > 700


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_setup_tables_equal_tpusnark_device_tables(keys):
    """The affine tables setup leaves on the device are tpusnark's
    ProvingKey.device() arrays (G2 in the G1 layout), converted to words."""
    cfg, _, _, pk_t, _, pk_j, _ = keys
    fp = get_field(cfg.fp_spec)
    ours, theirs = device_tables(pk_t, "cpu"), pk_tables(pk_j.device(), cfg.fp_spec)
    for name in ("a", "b1", "b2", "k", "z"):
        got, want = _leaves(ours[name]), _leaves(theirs[name])
        assert len(got) == len(want) == 3, name  # X, Y, inf: no Fp2 pairs
        for g, w in zip(got, want):
            if g.dim() == 1:
                assert g.tolist() == w.tolist(), name
            else:
                assert g.shape[0] == n_words(cfg.fp_spec) == 24
                assert fp.decode(g) == fp.decode(w), name


def test_abc_and_compute_h_match_tpusnark(keys):
    cfg, cs_t, cs_j, pk_t, _, _, _ = keys
    spec = cfg.fr_spec
    fr, jfr = get_field(spec), JField(spec)
    W = tsolve(cs_t, ASSIGN)
    assert W == solve(cs_j, ASSIGN)
    A, B, C = abc_evaluator(cs_t, fr, "cpu")(fr.encode(W))
    jA, jB, jC = _abc_eval(cs_j, jfr)(jnp.asarray(spec.encode(W, mont=True).T.copy()))
    for got, want in zip((A, B, C), (jA, jB, jC)):
        assert fr.decode(got) == jfr.to_ints(want)
    n = pk_t.domain_n
    h = tg16.compute_h_dev(A, B, C, n, spec)
    jh = jax_compute_h(jA, jB, jC, n, spec)
    assert h.shape == (n_words(spec), n - 1) and n_words(spec) == 12
    assert fr.decode(h, mont=False) == jfr.to_ints(jh, mont=False)
    hc = tg16.compute_h_dev(*to_torch((np.asarray(jA), np.asarray(jB), np.asarray(jC)), spec), n, spec)
    assert fr.decode(hc, mont=False) == fr.decode(h, mont=False)


def test_proof_points_lie_in_their_subgroups(keys, proof):
    host = keys[0].host
    assert type(proof) is tg16.Proof and (proof.commitments, proof.commitment_pok) == ([], None)
    for pt in (proof.ar, proof.krs):
        assert host.G1.is_on_curve(pt) and host.G1.in_subgroup(pt)
    assert all(isinstance(c, int) for c in proof.bs)
    assert host.G2.is_on_curve(proof.bs) and host.G2.in_subgroup(proof.bs)


def test_proof_equals_the_host_oracle_proof(keys, proof):
    """With the seeded toxic waste replayed, the proof Groth16 defines is
    three scalar multiples of the generators; tpusnark's host code (QAP
    evaluation, domain, curve) computes them, and the port's proof must equal
    them point for point (so it equals what tpusnark's prover returns)."""
    cfg, _, cs_j, pk_t, _, _, _ = keys
    host, p = cfg.host, cfg.host.R
    rand = seeded(42, p)
    alpha, beta, _gamma, delta, t = (rand() for _ in range(5))
    rs = seeded(7, p, lo=0)
    r, s = rs(), rs()
    n = pk_t.domain_n
    assert pow(t, n, p) != 1
    W = solve(cs_j, ASSIGN)
    A, B, C = jsetup._qap_eval_at_t(cs_j, t, n, Domain(cfg.fr_spec, n).generator)
    dot = lambda v: sum(w * c for w, c in zip(W, v)) % p  # noqa: E731
    inv = lambda v: pow(v, -1, p)  # noqa: E731
    zt = (pow(t, n, p) - 1) % p
    h_zt = (dot(A) * dot(B) - dot(C)) % p  # H(t) * Z_H(t)
    a, b = (alpha + dot(A) + r * delta) % p, (beta + dot(B) + s * delta) % p
    priv = sum(W[w] * (beta * A[w] + alpha * B[w] + C[w]) for w in range(cs_j.n_public, cs_j.n_wires)) % p
    c = ((priv + h_zt) * inv(delta) + a * s + b * r - r * s * delta) % p
    assert zt != 0
    g1, g2 = host.G1.generator(), host.G2.generator()
    assert proof.ar == host.G1.mul(g1, a)
    assert proof.bs == host.G2.mul(g2, b)
    assert proof.krs == host.G1.mul(g1, c)


def test_tpusnark_verifier_accepts_the_ports_proof(keys, proof):
    vk_t = keys[4]
    assert jverify.verify(proof, vk_t, [35], curve=CURVE)


@pytest.mark.slow
def test_wrong_public_input_is_rejected_by_both_verifiers(keys, proof):
    vk_t = keys[4]
    assert tg16.verify(proof, vk_t, [35], curve=CURVE)
    assert not tg16.verify(proof, vk_t, [36], curve=CURVE)
    assert not jverify.verify(proof, vk_t, [36], curve=CURVE)


@pytest.mark.slow
def test_proof_matches_tpusnark_jax_prover(keys, proof):
    """The JAX prover over 48-limb coordinates: minutes of compilation."""
    cfg, _, cs_j, _, _, pk_j, _ = keys
    want = jg16.prove(cs_j, pk_j, ASSIGN, rng=seeded(7, cfg.host.R, lo=0))
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
