"""Groth16 over BLS24-315 and BLS24-317 (fr 8 and 9 words, fp 10 words, G2
over Fp4) through the port (plain versions on the CPU) on the cubic circuit
of tests/test_bls24_bw6633.py, against tpusnark: setup equals tpusnark's
host setup point for point (the Fp4 inversion of ``to_affine`` and the
decode of ``to_host``), the device tables equal tpusnark's
``ProvingKey.device()``, A/B/C and H equal tpusnark's (BLS24-317's 17-limb
fr: R = 2^288 here, 2^272 in tpusnark), and the proof equals the host
oracle's three scalar multiples. The port's setup and prove run where jax
and tpusnark cannot be imported. A BLS24 pairing check is most of a minute
of Python integers, so the verifiers' verdicts run under the ``slow``
marker, and on the card's host in chip_smoke.py. The Fp4 group law and MSM
are in tests/test_torch_bls24.py."""

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
from tpusnark_torch.curves.config import get_curve as tget_curve
from tpusnark_torch.curves.encoding import g4_to_device
from tpusnark_torch.fields.tfield import get_field, n_words
from tpusnark_torch.frontend.builder import Builder as TBuilder

from tests.test_torch_imports import groth16_without_jax

torch.set_num_threads(1)  # the suite's workers fill the cores already

jsetup = import_module("tpusnark.backend.groth16.setup")

CURVES = ("bls24-315", "bls24-317")
ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def fp4_ints(e):
    """A host Fp4 element -> its four Fp components (c00, c01, c10, c11)."""
    return [f.v for f2 in e.c for f in f2.c]


def cubic_circuit(r, builder):
    b = builder(r)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


def seeded(seed, r, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, r)


@pytest.fixture(scope="module", params=CURVES)
def keys(request, tmp_path_factory):
    """The port's setup and prove, run where jax and tpusnark cannot be
    imported (tests/test_torch_imports.py), and tpusnark's host setup."""
    curve = request.param
    cfg = get_curve(curve)
    r = cfg.host.R
    cs_t, cs_j = cubic_circuit(r, TBuilder), cubic_circuit(r, Builder)
    pk_t, vk_t, proof, phases = groth16_without_jax(curve, tmp_path_factory.mktemp(curve))
    assert phases == ["assemble", "encode", "h", "msm", "solve"]
    pk_j, vk_j = jg16.setup(cs_j, rng=seeded(42, r), use_device=False, curve=curve)
    return cfg, cs_t, cs_j, pk_t, vk_t, pk_j, vk_j, proof


def test_setup_matches_tpusnark_host_setup_point_for_point(keys):
    """tpusnark multiplies the BLS24 G2 keys on the host, one ladder a point;
    the port's batched multiplication, its Fp4 to_affine and its to_host
    decode give the same points."""
    cfg, _, _, pk_t, vk_t, pk_j, vk_j, _ = keys
    for name in PK_FIELDS:
        assert plain_tree(getattr(pk_t, name)) == plain_tree(getattr(pk_j, name)), name
    for name in VK_FIELDS:
        assert plain_tree(getattr(vk_t, name)) == plain_tree(getattr(vk_j, name)), name
    assert (pk_t.curve, pk_t.domain_n, pk_t.k_wires) == (cfg.name, pk_j.domain_n, pk_j.k_wires)
    # G2 coordinates are the port's own host Fp4 class
    host = tget_curve(cfg.name).host
    assert all(type(c) is host.Fp4 for c in vk_t.delta_g2) and type(pk_t) is tg16.ProvingKey


def plain_tree(v):
    """Host values (ints, points over Fp or Fp4, lists of them) as nested
    ints, so that the port's and tpusnark's host classes compare."""
    if v is None or isinstance(v, int):
        return v
    if isinstance(v, list):
        return [plain_tree(x) for x in v]
    if isinstance(v, tuple):
        return tuple(plain_tree(x) for x in v)
    return tuple(fp4_ints(v))


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_setup_tables_equal_tpusnark_device_tables(keys):
    """The affine tables setup leaves on the device are tpusnark's
    ProvingKey.device() arrays (G2 with four components a coordinate)."""
    cfg, _, _, pk_t, _, pk_j, _, _ = keys
    fp = get_field(cfg.fp_spec)
    ours, theirs = device_tables(pk_t, "cpu"), pk_tables(pk_j.device(), cfg.fp_spec)
    for name in ("a", "b1", "b2", "k", "z"):
        got, want = _leaves(ours[name]), _leaves(theirs[name])
        assert len(got) == len(want) == (9 if name == "b2" else 3), name
        for g, w in zip(got, want):
            if g.dim() == 1:
                assert g.tolist() == w.tolist(), name
            else:
                assert g.shape[0] == n_words(cfg.fp_spec) == 10
                assert fp.decode(g) == fp.decode(w), name
    # the tables the prover would encode from the host keys are the same
    enc = g4_to_device(pk_t.b2, fp)
    for g, w in zip(_leaves(enc), _leaves(ours["b2"])):
        assert g.tolist() == w.tolist() if g.dim() == 1 else fp.decode(g) == fp.decode(w)


def test_abc_and_compute_h_match_tpusnark(keys):
    cfg, cs_t, cs_j, pk_t, _, _, _, _ = keys
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
    assert h.shape == (n_words(spec), n - 1)
    assert fr.decode(h, mont=False) == jfr.to_ints(jh, mont=False)
    # tpusnark's A/B/C through convert.py (BLS24-317 fr: R = 2^272 there)
    hc = tg16.compute_h_dev(*to_torch((np.asarray(jA), np.asarray(jB), np.asarray(jC)), spec), n, spec)
    assert fr.decode(hc, mont=False) == fr.decode(h, mont=False)


def test_proof_equals_the_host_oracle_proof(keys):
    """With the seeded toxic waste replayed, the proof is three scalar
    multiples of the generators, computed by tpusnark's host code."""
    cfg, _, cs_j, pk_t, _, _, _, proof = keys
    host, p = cfg.host, cfg.host.R
    rand = seeded(42, p)
    alpha, beta, _gamma, delta, t = (rand() for _ in range(5))
    rs = seeded(7, p, lo=0)
    r, s = rs(), rs()
    n = pk_t.domain_n
    W = solve(cs_j, ASSIGN)
    A, B, C = jsetup._qap_eval_at_t(cs_j, t, n, Domain(cfg.fr_spec, n).generator)
    dot = lambda v: sum(w * c for w, c in zip(W, v)) % p  # noqa: E731
    zt = (pow(t, n, p) - 1) % p
    h_zt = (dot(A) * dot(B) - dot(C)) % p
    a, b = (alpha + dot(A) + r * delta) % p, (beta + dot(B) + s * delta) % p
    priv = sum(W[w] * (beta * A[w] + alpha * B[w] + C[w]) for w in range(cs_j.n_public, cs_j.n_wires)) % p
    c = ((priv + h_zt) * pow(delta, -1, p) + a * s + b * r - r * s * delta) % p
    g1, g2 = host.G1.generator(), host.G2.generator()
    assert type(proof) is tg16.Proof and (proof.commitments, proof.commitment_pok) == ([], None)
    assert plain_tree(proof.ar) == plain_tree(host.G1.mul(g1, a))
    assert plain_tree(proof.bs) == plain_tree(host.G2.mul(g2, b))
    assert plain_tree(proof.krs) == plain_tree(host.G1.mul(g1, c))


@pytest.mark.slow
def test_verifiers_accept_the_proof_and_reject_a_wrong_input(keys):
    """Two BLS24 pairing checks a verifier: minutes of Python integers."""
    cfg, _, _, _, vk_t, _, _, proof = keys
    assert tg16.verify(proof, vk_t, [35], curve=cfg.name)
    assert not tg16.verify(proof, vk_t, [36], curve=cfg.name)


@pytest.mark.slow
def test_proof_matches_tpusnark_jax_prover(keys):
    """tpusnark's JAX prover over Fp4: minutes of compilation."""
    cfg, _, cs_j, _, _, pk_j, _, proof = keys
    want = jg16.prove(cs_j, pk_j, ASSIGN, rng=seeded(7, cfg.host.R, lo=0))
    assert plain_tree((proof.ar, proof.bs, proof.krs)) == plain_tree((want.ar, want.bs, want.krs))
