"""Groth16 over BW6-633 (fr 10 words, fp 20 words, G2 over Fp itself: the
outer curve of the BLS24-315 2-chain) through the port (plain versions on
the CPU) on the cubic circuit of tests/test_bls24_bw6633.py, against
tpusnark: its host setup point for point, its device tables, its
``_abc_eval`` and ``compute_h_dev``, the proof its host code computes from
the replayed toxic waste, and both packages' verifiers, which accept the
proof and reject a wrong public input (a BW6-633 pairing check takes
seconds). Also the 20-word product's carries against Python ints, and the
2-chain: BW6-633's fr is BLS24-315's fp, with its own kernel instances.
Exact: points and ints mod p."""

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
from tpusnark_torch import kernels
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.eval_torch import abc_evaluator
from tpusnark_torch.constraint.solver import solve as tsolve
from tpusnark_torch.convert import pk_tables, to_torch
from tpusnark_torch.fields.tfield import get_field, n_words
from tpusnark_torch.frontend.builder import Builder as TBuilder
from tpusnark_torch.msm.pippenger import get_msm_for

from tests.test_torch_imports import groth16_without_jax

torch.set_num_threads(1)  # the suite's workers fill the cores already

jverify = import_module("tpusnark.backend.groth16.verify")
jsetup = import_module("tpusnark.backend.groth16.setup")

CURVE = "bw6-633"
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
def keys(tmp_path_factory):
    """The port's setup and prove, run where jax and tpusnark cannot be
    imported (tests/test_torch_imports.py), and tpusnark's host setup."""
    cfg = get_curve(CURVE)
    r = cfg.host.R
    cs_t, cs_j = cubic_circuit(r, TBuilder), cubic_circuit(r, Builder)
    pk_t, vk_t, proof, phases = groth16_without_jax(CURVE, tmp_path_factory.mktemp(CURVE))
    assert phases == ["assemble", "encode", "h", "msm", "solve"]
    pk_j, vk_j = jg16.setup(cs_j, rng=seeded(42, r), use_device=False, curve=CURVE)
    return cfg, cs_t, cs_j, pk_t, vk_t, pk_j, vk_j, proof


def test_setup_matches_tpusnark_host_setup_point_for_point(keys):
    cfg, _, _, pk_t, vk_t, pk_j, vk_j, _ = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    assert (pk_t.curve, pk_t.domain_n, pk_t.k_wires) == (CURVE, pk_j.domain_n, pk_j.k_wires)
    # G2 over Fp: plain int pairs, of the full 633 bits
    assert all(isinstance(c, int) for c in vk_t.delta_g2)
    assert max(c for pt in pk_t.b2 if pt for c in pt).bit_length() > 600


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_setup_tables_equal_tpusnark_device_tables(keys):
    """The affine tables setup leaves on the device are tpusnark's
    ProvingKey.device() arrays (G2 in the G1 layout), converted to words."""
    cfg, _, _, pk_t, _, pk_j, _, _ = keys
    fp = get_field(cfg.fp_spec)
    ours, theirs = device_tables(pk_t, "cpu"), pk_tables(pk_j.device(), cfg.fp_spec)
    for name in ("a", "b1", "b2", "k", "z"):
        got, want = _leaves(ours[name]), _leaves(theirs[name])
        assert len(got) == len(want) == 3, name
        for g, w in zip(got, want):
            if g.dim() == 1:
                assert g.tolist() == w.tolist(), name
            else:
                assert g.shape[0] == n_words(cfg.fp_spec) == 20
                assert fp.decode(g) == fp.decode(w), name


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
    assert h.shape == (n_words(spec), n - 1) and n_words(spec) == 10
    assert fr.decode(h, mont=False) == jfr.to_ints(jh, mont=False)
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
    assert proof.ar == host.G1.mul(g1, a)
    assert proof.bs == host.G2.mul(g2, b)
    assert proof.krs == host.G1.mul(g1, c)


def test_both_verifiers_accept_the_proof_and_reject_a_wrong_input(keys):
    cfg, _, _, _, vk_t, _, _, proof = keys
    for verify in (tg16.verify, jverify.verify):
        assert verify(proof, vk_t, [35], curve=CURVE)
        assert not verify(proof, vk_t, [36], curve=CURVE)


def test_20_word_products_with_long_carry_ripples_equal_python_ints():
    """BW6-633 fp: 20 words, a product of 40 word rows, with operands whose
    words are all ones or all zeros (carries ripple across every word)."""
    spec = get_curve(CURVE).fp_spec
    f = get_field(spec)
    p = spec.modulus
    R = 1 << (32 * f.n)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1, (1 << (32 * 19)) - 1, (2 * p) >> 1, (2 * p - 1) ^ 0xFFFF]
    vals = [v % (2 * p) for v in edge]
    a = torch.from_numpy(np.ascontiguousarray(np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals] for k in range(f.n)], dtype="<u4")).view(np.int32))
    b = a.flip(1).contiguous()
    rinv = pow(R, -1, p)
    got = f.decode(f.mul(a, b), mont=False)
    assert got == [x * y * rinv % p for x, y in zip(vals, vals[::-1])]
    assert f.decode(f.from_mont(a), mont=False) == [x * rinv % p for x in vals]


def test_the_2_chain_fields_keep_their_own_kernel_instances():
    """BW6-633's fr and BLS24-315's fp have one modulus, and each keeps its
    spec, field id and launch counters; the BW6-633 MSMs take 20 windows of
    c = 16 over 315-bit scalars (the signed digits' headroom bit)."""
    bw6, bls = get_curve(CURVE), get_curve("bls24-315")
    assert bw6.fr_spec.modulus == bls.fp_spec.modulus and bw6.fr_spec.name != bls.fp_spec.name
    assert kernels.SPECS["bw6_633_fr"] != kernels.SPECS["bls24_315_fp"]
    assert kernels.SPECS["bw6_633_fr"][1] == kernels.SPECS["bls24_315_fp"][1] == 10
    assert "butterfly[bw6_633_fr]" in kernels.instances(CURVE)
    assert "neg[bls24_315_fp]" in kernels.instances("bls24-315")
    assert kernels.base_field_ops(CURVE) == ("mul", "from_mont", "neg")  # G2 over Fp: no Fp2 inversion
    for group in ("g1", "g2"):
        msm = get_msm_for(group, 1 << 17, CURVE)
        assert (msm.c, msm.scalar_bits, msm.n_windows) == (16, 315, 20)
