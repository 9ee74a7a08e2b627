"""The port's PLONK with a BSB22 commitment (tpusnark_torch.backend.plonk, on
the CPU) against tpusnark's on the circuit of tests/test_plonk_commit.py
(one commitment, whose challenge flows through an inverse gate and a
square), with tau 987654321 and the blinding rng random.Random(5): the
port's setup, prove and verifier run in a process where jax and tpusnark
cannot be imported. The qcp column, the keys and the proof (the BSB22 commitment and
the eighth claimed value included) equal tpusnark's; the port's verifier
accepts the proof and rejects a wrong public input and a tampered
commitment, and tpusnark's verifier accepts it. A file of its own, so that
the suite's workers run it beside tests/test_torch_plonk.py."""

import dataclasses
import random

import pytest
import torch

from tpusnark.backend import plonk as jplonk
from tpusnark.fields.jfield import get_field as jget_field
from tpusnark.fields.spec import BN254_FR as JBN254_FR
from tpusnark.frontend.plonk_builder import PlonkBuilder as JPlonkBuilder
from tpusnark_torch.backend import plonk as tplonk
from tpusnark_torch.curves.ref import G1
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.fields.tfield import get_field

from tests.test_torch_imports import start_plonk_without_jax

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
TAU = 987654321
ASSIGN = {"x": 3, "y": 9}


def commit_circuit(Builder, P):
    """tests/test_plonk_commit.py's circuit: x^2 == y, c = Commit(x),
    x != c, (x - c)^2 == x^2 - 2cx + c^2."""
    b = Builder(P)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.mul(x, x), y)
    c = b.commit(x)
    b.assert_is_different(x, c)
    d = b.mul(b.sub(x, c), b.sub(x, c))
    b.assert_is_equal(d, b.add(b.mul(x, x), b.mul(b._scale(c, P - 2), x), b.mul(c, c)))
    return b.compile()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port's pk, vk, proof, phase names; tpusnark's pk, vk, proof)."""
    wait = start_plonk_without_jax(commit_circuit, ASSIGN, [9], TAU, 5, tmp_path_factory.mktemp("plonk"))
    jcs = commit_circuit(JPlonkBuilder, P)
    jpk, jvk = jplonk.setup(jcs, tau=TAU)
    rng = random.Random(5)
    jproof = jplonk.prove(jcs, jpk, ASSIGN, rng=lambda: rng.randrange(1, P))
    return (*wait(), jpk, jvk, jproof)


def test_keys_and_qcp_column_equal_tpusnark(artifacts):
    pk, vk, _, _, jpk, jvk, _ = artifacts
    assert dataclasses.asdict(vk) == dataclasses.asdict(jvk)
    assert len(vk.qcp) == 1 and len(pk.qcp_coeffs) == 1
    fr, jfr = get_field(BN254_FR), jget_field(JBN254_FR)
    assert fr.decode(pk.qcp_coeffs[0]) == jfr.to_ints(jpk.qcp_coeffs[0])
    assert fr.decode(pk.dev()["qcp_stack"]) == jfr.to_ints(jpk.dev()["qcp_stack"])


def test_proof_with_a_commitment_equals_tpusnark(artifacts):
    _, _, proof, _, _, _, jproof = artifacts
    assert len(proof.bsb22_commitments) == 1 and len(proof.claimed_values) == 8
    for f in dataclasses.fields(jproof):
        assert getattr(proof, f.name) == getattr(jproof, f.name), f.name


def test_verifiers_accept_and_reject(artifacts):
    _, vk, proof, _, _, jvk, _ = artifacts
    assert tplonk.verify(proof, vk, [9])
    assert jplonk.verify(proof, jvk, [9])
    assert not tplonk.verify(proof, vk, [10])
    bad = dataclasses.replace(proof, bsb22_commitments=[G1.mul(G1.generator(), 987654321)])
    assert not tplonk.verify(bad, vk, [9])
