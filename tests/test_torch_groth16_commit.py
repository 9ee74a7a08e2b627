"""BSB22 commitments through the port (tpusnark_torch.backend.groth16, plain
versions on the CPU) against tpusnark on tests/test_commit.py's circuit over
BN254, y == x^3 + c*x + 5 + pub with c = Commit(x, pub), under the same
seeded rngs: the keys (with the Pedersen keys and the vk's commitment
sections) and the proof (with the commitment and its proof of knowledge)
are equal point for point, on the host solver's branch and on the device
solver's (the shape rule's thresholds lowered in both packages, inside the
test only). Both packages' verifiers accept the proof and reject a wrong
public input and a tampered commitment."""

import dataclasses
import random
from importlib import import_module

import pytest
import torch

import tpusnark.constraint.solver_jax as jsolver_jax
import tpusnark_torch.constraint.solver_torch as st
from tpusnark.backend import groth16 as jg16
from tpusnark.curves.marshal import g1_raw
from tpusnark.curves.pedersen import pedersen_commit
from tpusnark.fields.spec import BN254_FR
from tpusnark.frontend.builder import Builder
from tpusnark.utils.hash_to_field import COMMITMENT_DST, hash_to_field
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.config import ProverConfig
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.hints import bsb22_placeholder
from tpusnark_torch.constraint.solver import UnsatisfiedConstraintError
from tpusnark_torch.curves.config import get_curve
from tpusnark_torch.curves.tcurve import curve_ops
from tpusnark_torch.frontend.builder import Builder as TBuilder

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
X, PUB = 3, 11
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z", "domain_n", "k_wires")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1", "public_and_commitment_committed")
jverify = import_module("tpusnark.backend.groth16.verify")
tsetup = import_module("tpusnark_torch.backend.groth16.setup")


def commit_circuit(builder):
    """tests/test_commit.py's circuit, from either package's builder."""
    b = builder(P)
    x = b.secret("x")
    pub = b.public("pub")
    c = b.commit(x, pub)
    y = b.add(b.mul(x, x, x), b.mul(c, x), 5, pub)
    b.assert_is_equal(y, b.public("y"))
    return b.compile()


def seeded(seed, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, P)


@pytest.fixture(scope="module")
def keys():
    cs_t, cs_j = commit_circuit(TBuilder), commit_circuit(Builder)
    pk_t, vk_t = tg16.setup(cs_t, rng=seeded(42), device="cpu")
    pk_j, vk_j = jg16.setup(cs_j, rng=seeded(42), use_device=False)
    # the prover's challenge, as tests/test_commit.py computes it
    C = pedersen_commit(pk_j.commitment_keys[0], [X])
    (c,) = hash_to_field(g1_raw(C) + PUB.to_bytes(32, "big"), COMMITMENT_DST, P)
    assign = {"x": X, "pub": PUB, "y": (X**3 + c * X + 5 + PUB) % P}
    return cs_t, cs_j, pk_t, vk_t, pk_j, vk_j, assign


@pytest.fixture(scope="module")
def proofs(keys):
    """The port's proof (host branch, the default shape rule) and
    tpusnark's, under the same rng."""
    cs_t, cs_j, pk_t, _, pk_j, _, assign = keys
    ours = tg16.prove(cs_t, pk_t, assign, rng=seeded(9, 0), device="cpu")
    theirs = jg16.prove(cs_j, pk_j, assign, rng=seeded(9, 0))
    return ours, theirs


def proof_image(proof):
    return (proof.ar, proof.bs, proof.krs, proof.commitments, proof.commitment_pok)


def test_commitment_setup_matches_tpusnark_point_for_point(keys):
    cs_t, _, pk_t, vk_t, pk_j, vk_j, _ = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    (ck_t,), (ck_j,) = pk_t.commitment_keys, pk_j.commitment_keys
    assert (ck_t.basis, ck_t.basis_exp_sigma) == (ck_j.basis, ck_j.basis_exp_sigma)
    assert len(ck_t.basis) == 1 and ck_t.basis[0] is not None
    assert (vk_t.commitment_key.g2, vk_t.commitment_key.g2_sigma_neg) == (
        vk_j.commitment_key.g2,
        vk_j.commitment_key.g2_sigma_neg,
    )
    # the committed and commitment wires have no pk.K point; the vk has one
    # per public wire and one per commitment
    assert len(pk_t.k) == len(pk_t.k_wires) == cs_t.n_wires - cs_t.n_public - 2
    assert len(vk_t.k) == cs_t.n_public + 1
    # the tables setup leaves on the device are the host keys' points
    g1, _ = curve_ops("bn254")
    tables = device_tables(pk_t, "cpu")
    host = get_curve("bn254").host
    for name in ("a", "b1", "k", "z"):
        assert tsetup.to_host(g1, tables[name], host) == getattr(pk_t, name), name


def test_commitment_proof_matches_tpusnark_and_verifies(keys, proofs):
    _, _, _, vk_t, _, vk_j, assign = keys
    ours, theirs = proofs
    assert proof_image(ours) == proof_image(theirs)
    assert len(ours.commitments) == 1 and ours.commitment_pok is not None
    pubs = [PUB, assign["y"]]
    for verify, vk in ((tg16.verify, vk_t), (jverify.verify, vk_j)):
        assert verify(ours, vk, pubs)
        assert not verify(ours, vk, [PUB, (assign["y"] + 1) % P])


def test_tampered_commitment_is_rejected_by_both_verifiers(keys, proofs):
    _, _, _, vk_t, _, vk_j, assign = keys
    host = get_curve("bn254").host
    forged = dataclasses.replace(proofs[0], commitments=[host.G1.mul(host.G1.generator(), 1234567)])
    for mod, vk in ((import_module("tpusnark_torch.backend.groth16.verify"), vk_t), (jverify, vk_j)):
        with pytest.raises(mod.InvalidProofError):
            mod.verify(forged, vk, [PUB, assign["y"]])
        with pytest.raises(mod.InvalidProofError, match="missing BSB22"):
            mod.verify(dataclasses.replace(proofs[0], commitment_pok=None), vk, [PUB, assign["y"]])


def test_device_branch_gives_the_host_branch_proof_and_tpusnark_device_proof(keys, proofs, monkeypatch):
    """With the shape rule's thresholds at 1 in both packages, the commit
    circuit takes the device solvers, whose hint sync runs the BSB22
    override; the proof is the same on every branch. The placeholder's
    challenge gives a y that the device branch refuses, as the host does."""
    cs_t, cs_j, pk_t, _, pk_j, _, assign = keys
    for mod in (st, jsolver_jax):
        monkeypatch.setattr(mod, "MIN_TOTAL_INSTRUCTIONS", 1)
        monkeypatch.setattr(mod, "MIN_MEAN_LEVEL_WIDTH", 1)
    assert st.prefer_device(cs_t) and jsolver_jax.prefer_device(cs_j)
    solvers = []
    get = st.get_level_solver
    monkeypatch.setattr(st, "get_level_solver", lambda *a: solvers.append(a[0]) or get(*a))
    ours = tg16.prove(cs_t, pk_t, assign, rng=seeded(9, 0), device="cpu")
    assert solvers == [cs_t]
    host = tg16.prove(cs_t, pk_t, assign, rng=seeded(9, 0), config=ProverConfig().with_accelerator("host"), device="cpu")
    assert solvers == [cs_t]
    theirs = jg16.prove(cs_j, pk_j, assign, rng=seeded(9, 0))
    assert proof_image(ours) == proof_image(host) == proof_image(theirs) == proof_image(proofs[0])
    c = bsb22_placeholder(P, [0, PUB, X])[0]
    wrong = {**assign, "y": (X**3 + c * X + 5 + PUB) % P}
    with pytest.raises(UnsatisfiedConstraintError):
        tg16.prove(cs_t, pk_t, wrong, rng=seeded(9, 0), device="cpu")
