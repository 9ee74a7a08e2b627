"""Groth16 over BN254 through the port (tpusnark_torch.backend.groth16,
plain versions on the CPU) against tpusnark (host setup, JAX prover on the
CPU) on the cubic circuit of tests/test_groth16.py, with the same seeded
setup and prove rngs. Exact: keys and proofs are compared point for point,
device vectors as ints mod p. tpusnark's host verifier checks the proof."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from tpusnark.backend import groth16 as jg16
from tpusnark.backend.groth16.prove import _abc_eval
from tpusnark.backend.groth16.prove import compute_h_dev as jax_compute_h
from tpusnark.constraint.solver import solve
from tpusnark.curves import ref
from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BN254_FP, BN254_FR
from tpusnark.frontend.builder import Builder
from tpusnark_torch import _host
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.backend.groth16.keys import device_tables
from tpusnark_torch.constraint.eval_torch import abc_evaluator
from tpusnark_torch.convert import pk_tables, to_torch
from tpusnark_torch.fields.tfield import get_field

from tests.test_groth16 import cubic_circuit

ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def seeded(seed, lo=1):
    rng = random.Random(seed)
    return lambda: rng.randrange(lo, ref.R)


@pytest.fixture(scope="module")
def keys():
    cs = cubic_circuit()
    pk_t, vk_t = tg16.setup(cs, rng=seeded(42))
    pk_j, vk_j = jg16.setup(cs, rng=seeded(42), use_device=False)
    return cs, pk_t, vk_t, pk_j, vk_j


def test_setup_matches_tpusnark_point_for_point(keys):
    _, pk_t, vk_t, pk_j, vk_j = keys
    for name in PK_FIELDS:
        assert getattr(pk_t, name) == getattr(pk_j, name), name
    for name in VK_FIELDS:
        assert getattr(vk_t, name) == getattr(vk_j, name), name
    assert (pk_t.domain_n, pk_t.k_wires) == (pk_j.domain_n, pk_j.k_wires)
    assert isinstance(pk_t, jg16.ProvingKey)


def test_setup_tables_equal_tpusnark_device_tables(keys):
    """The affine tables setup leaves on the device are tpusnark's
    ProvingKey.device() arrays, converted to the port's words."""
    _, pk_t, _, pk_j, _ = keys
    fp = get_field(BN254_FP)
    ours, theirs = device_tables(pk_t, "cpu"), pk_tables(pk_j.device())
    for name in ("a", "b1", "b2", "k", "z"):
        for got, want in zip(_leaves(ours[name]), _leaves(theirs[name])):
            if got.dtype == want.dtype and got.dim() == 1:
                assert got.tolist() == want.tolist(), name
            else:
                assert fp.decode(got) == fp.decode(want), name


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_abc_and_compute_h_match_tpusnark(keys):
    cs, pk_t, _, _, _ = keys
    fr, jfr = get_field(BN254_FR), JField(BN254_FR)
    W = solve(cs, ASSIGN)
    A, B, C = abc_evaluator(cs, fr, "cpu")(fr.encode(W))
    jA, jB, jC = _abc_eval(cs, jfr)(jnp.asarray(BN254_FR.encode(W, mont=True).T.copy()))
    for got, want in zip((A, B, C), (jA, jB, jC)):
        assert fr.decode(got) == jfr.to_ints(want)
    n = pk_t.domain_n
    h = tg16.compute_h_dev(A, B, C, n)
    jh = jax_compute_h(jA, jB, jC, n)
    assert h.shape == (8, n - 1)
    assert fr.decode(h, mont=False) == jfr.to_ints(jh, mont=False)
    # the same H from tpusnark's own A/B/C converted into the port's layout
    hc = tg16.compute_h_dev(*to_torch((np.asarray(jA), np.asarray(jB), np.asarray(jC))), n)
    assert fr.decode(hc, mont=False) == fr.decode(h, mont=False)


def test_proof_matches_tpusnark_and_verifies(keys):
    cs, pk_t, vk_t, pk_j, _ = keys
    timings = {}
    proof = tg16.prove(cs, pk_t, ASSIGN, rng=seeded(7, lo=0), timings=timings)
    want = jg16.prove(cs, pk_j, ASSIGN, rng=seeded(7, lo=0))
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert set(timings) == {"solve", "encode", "h", "msm", "assemble"}
    assert _host.verify.verify(proof, vk_t, [35])
    assert not _host.verify.verify(proof, vk_t, [36])


def test_commitment_circuits_are_refused(keys):
    """BSB22 commitments are not ported: setup and prove refuse them."""
    _, pk_t, _, _, _ = keys
    b = Builder(ref.R)
    x = b.secret("x")
    y = b.public("y")
    c = b.commit(x)
    b.assert_is_equal(b.add(b.mul(x, x), c, 0), b.add(y, c))
    cs = b.compile()
    with pytest.raises(NotImplementedError):
        tg16.setup(cs, rng=seeded(1))
    with pytest.raises(NotImplementedError):
        tg16.prove(cs, pk_t, {"x": 2, "y": 4})
