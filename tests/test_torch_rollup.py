"""The port's examples against the repo's top-level ``examples/`` (tpusnark's):
the rollup (``tpusnark_torch/examples/rollup.py``) at batch 2 over 4
accounts (depth 2) builds tpusnark's constraint system with either
package's builder, its operator gives tpusnark's witness data, the port's
two solvers (host, and the level solver on CPU tensors) give tpusnark's
host solver's witness wire for wire, and every solver refuses a tampered
``root_mid_0`` (the secret root between the two transfers) and a wrong
amount. The slice as a whole: the cubic and MiMC examples' ``main`` on the
CPU with a seeded rng: keys equal to tpusnark's host setup under the same
rng point for point, proofs accepted by both packages' verifiers and
refused with a wrong public input. Exact. (A CPU prove of the rollup
itself is left out: even at depth 1 its domain is 2^15, minutes of plain
MSMs.)"""

import random
from importlib import import_module

import pytest
import torch

import tpusnark.constraint.solver as jsolver
import tpusnark_torch.constraint.solver as tsolver
from examples import cubic as jcubic
from examples import mimc as jmimc
from examples import rollup as jrollup
from tests.test_torch_host import cs_image
from tpusnark.frontend.builder import Builder as JBuilder
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.constraint.solver_torch import LevelSolver, prefer_device
from tpusnark_torch.examples import cubic, mimc
from tpusnark_torch.examples import rollup as trollup
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.frontend.builder import Builder as TBuilder

torch.set_num_threads(1)  # the suite's workers fill the cores already

jsetup, jverify = (import_module(f"tpusnark.backend.groth16.{n}") for n in ("setup", "verify"))

P = BN254_FR.modulus
BATCH, ACCOUNTS, DEPTH = 2, 4, 2
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z", "domain_n", "k_wires")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")
REFUSED = (tsolver.UnsatisfiedConstraintError, jsolver.UnsatisfiedConstraintError)


@pytest.fixture(scope="module")
def rollups():
    """(constraint system, assignment) of the batch from each package: the
    port's example on the port's builder, tpusnark's on tpusnark's."""

    def build(mod, builder):
        b = builder(mod.P)
        mod.define_batch(b, BATCH, depth=DEPTH)
        _, transfers = mod.make_batch(BATCH, ACCOUNTS)
        return b.compile(), mod.batch_assignment(transfers)

    return build(trollup, TBuilder), build(jrollup, JBuilder)


@pytest.fixture(scope="module")
def solvers(rollups):
    """name -> solve(assignment) over the port's system (tpusnark's host
    solver over tpusnark's)."""
    (ours, _), (theirs, _) = rollups
    f = get_field(BN254_FR)
    level = LevelSolver(ours, f, "cpu")
    return {
        "port host": lambda a: tsolver.solve(ours, a),
        "port level": lambda a: f.decode(level.solve(a)),
        "tpusnark host": lambda a: jsolver.solve(theirs, a),
    }


def test_rollup_systems_and_operators_equal_tpusnark(rollups):
    (ours, assign), (theirs, jassign) = rollups
    assert assign == jassign
    assert cs_image(ours) == cs_image(theirs)
    assert ours.stats() == theirs.stats()
    # one pair of public roots for the batch; the root between the two
    # transfers is a secret
    assert ours.public_names[1:] == ["root_before", "root_after"]
    assert "root_mid_0" in ours.secret_names and assign["root_mid_0"] not in (0, assign["root_before"])
    # the shape rule keeps a batch this small on the host (it sends batch 31
    # at depth 5, a mean level width of ~221, to the card)
    assert not prefer_device(ours)


@pytest.mark.parametrize("solver", ("port host", "port level"))
def test_rollup_witness_equals_tpusnark(rollups, solvers, solver):
    """Every wire, among them the hint outputs of both transfers (their
    divisions and bit decompositions, which a hint level of the level solver
    writes back side by side)."""
    (_, assign), _ = rollups
    assert solvers[solver](assign) == solvers["tpusnark host"](assign)


TAMPERS = {
    "root_mid_0": lambda a: {**a, "root_mid_0": (a["root_mid_0"] + 1) % P},
    "amount": lambda a: {**a, "t0_amount": a["t0_amount"] + 1},
}


@pytest.mark.parametrize("solver", ("port host", "port level", "tpusnark host"))
@pytest.mark.parametrize("tamper", TAMPERS)
def test_rollup_solvers_refuse_a_tampered_batch(rollups, solvers, solver, tamper):
    (_, assign), _ = rollups
    with pytest.raises(REFUSED):
        solvers[solver](TAMPERS[tamper](assign))


@pytest.mark.parametrize("name", ("cubic", "mimc"))
def test_example_keys_and_proofs_equal_tpusnark(name):
    """The example's main on the CPU (setup and prove under one seeded rng)
    against tpusnark's host setup under the same rng."""
    ours, theirs = {"cubic": (cubic, jcubic), "mimc": (mimc, jmimc)}[name]
    rng = random.Random(41)
    cs, pk, vk, proof, pubs = ours.main(device="cpu", rng=lambda: rng.randrange(1, P))
    b = JBuilder(P)
    theirs.define(b)
    jcs = b.compile()
    assert cs_image(cs) == cs_image(jcs)
    rng = random.Random(41)
    jpk, jvk = jsetup.setup(jcs, rng=lambda: rng.randrange(1, P), use_device=False)
    assert [getattr(pk, k) for k in PK_FIELDS] == [getattr(jpk, k) for k in PK_FIELDS]
    assert [getattr(vk, k) for k in VK_FIELDS] == [getattr(jvk, k) for k in VK_FIELDS]
    wrong = [(pubs[0] + 1) % P] + pubs[1:]
    for verify, key in ((tg16.verify, vk), (jverify.verify, jvk)):
        assert verify(proof, key, pubs)
        assert not verify(proof, key, wrong)
