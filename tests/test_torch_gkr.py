"""The port's interactive-proof protocols and GKR gadget against tpusnark's:
``protocols/{multilinear,sumcheck,gkr}.py`` and ``gadgets/gkr_compile.py``
are tpusnark's code; on seeded inputs their values and proofs are
tpusnark's, each package's verifier accepts the other's proof, and the
compiled GKR circuit (chip_smoke.gkr_circuit: tests/test_gkr_compile.py's
DAG) at 2 and 4 instances has tpusnark's constraints and host-solved
witness, wire for wire, and refuses a wrong output."""

import dataclasses
import random
from importlib import import_module

import pytest
import torch

import chip_smoke
import tpusnark.constraint.solver as jsolver
import tpusnark.frontend.builder as jbuilder
import tpusnark.gadgets.gkr_compile as jcompile
import tpusnark.protocols.gkr as jgkr
import tpusnark.protocols.multilinear as jml
import tpusnark.protocols.sumcheck as jsum
import tpusnark.testing.engine as jengine
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.frontend.builder as tbuilder
import tpusnark_torch.gadgets.gkr_compile as tcompile
import tpusnark_torch.protocols.gkr as tgkr
import tpusnark_torch.protocols.multilinear as tml
import tpusnark_torch.protocols.sumcheck as tsum
import tpusnark_torch.testing.engine as tengine
from tests.test_torch_host import code_without_docstrings, cs_image
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus

COPIES = ("protocols", "protocols.multilinear", "protocols.sumcheck", "protocols.gkr", "gadgets.gkr_compile")


@pytest.mark.parametrize("name", COPIES)
def test_protocol_modules_are_tpusnark_code(name):
    ours = import_module(f"tpusnark_torch.{name}")
    theirs = import_module(f"tpusnark.{name}")
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def table(seed, n_vars):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(1 << n_vars)]


def test_multilinear_values_equal_tpusnark():
    rng = random.Random(3)
    for n_vars in (1, 3, 5):
        e = table(n_vars, n_vars)
        pt = [rng.randrange(P) for _ in range(n_vars)]
        ours, theirs = tml.MultiLin(e, P), jml.MultiLin(e, P)
        assert ours.evaluate(pt) == theirs.evaluate(pt)
        assert ours.fix_first(pt[0]).e == theirs.fix_first(pt[0]).e
        assert tml.eq_table(pt, P).e == jml.eq_table(pt, P).e
    xs_ys = [(x, rng.randrange(P)) for x in range(4)]
    assert tml.interpolate_univariate(xs_ys, 77, P) == jml.interpolate_univariate(xs_ys, 77, P)


@pytest.mark.parametrize("n_vars", (2, 4))
def test_sumcheck_proofs_and_points_equal_tpusnark(n_vars):
    f, g = table(10 + n_vars, n_vars), table(20 + n_vars, n_vars)
    claim = sum(a * b for a, b in zip(f, g)) % P
    ours = tsum.prove([tml.MultiLin(f, P), tml.MultiLin(g, P)], claim, P)
    theirs = jsum.prove([jml.MultiLin(f, P), jml.MultiLin(g, P)], claim, P)
    assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
    point = tsum.verify(claim, theirs, n_vars, P)
    assert point == jsum.verify(claim, ours, n_vars, P)
    bad = jsum.SumcheckProof([list(r) for r in ours.rounds], ours.final_evals)
    bad.rounds[0][0] = (bad.rounds[0][0] + 1) % P
    for mod in (tsum, jsum):
        with pytest.raises(ValueError):
            mod.verify(claim, bad, n_vars, P)
        with pytest.raises(ValueError):
            mod.verify((claim + 1) % P, ours, n_vars, P)
    # the in-circuit verifier on each package's engine
    got = tsum.verify_in_circuit(tengine.TestEngine(P, {}), claim, ours.rounds, ours.final_evals[0], n_vars)
    assert got == jsum.verify_in_circuit(jengine.TestEngine(P, {}), claim, ours.rounds, ours.final_evals[0], n_vars)
    assert got == point


def layered(mod):
    """3 layers, widths 8 -> 8 -> 2; mixed ops (tests/test_sumcheck_gkr.py)."""
    l2 = [mod.Gate(mod.MUL, i, (i + 1) % 8) for i in range(8)]
    l1 = [mod.Gate(mod.ADD, i, (i + 3) % 8) for i in range(8)]
    l0 = [mod.Gate(mod.MUL, 0, 4), mod.Gate(mod.ADD, 2, 6)]
    return mod.LayeredCircuit([l0, l1, l2], n_inputs=8)


def test_gkr_proofs_equal_tpusnark_and_cross_verify():
    ins = table(5, 3)
    outs_t, proof_t = tgkr.prove(layered(tgkr), ins, P)
    outs_j, proof_j = jgkr.prove(layered(jgkr), ins, P)
    assert layered(tgkr).evaluate(ins, P) == layered(jgkr).evaluate(ins, P)
    assert outs_t == outs_j
    assert dataclasses.astuple(proof_t) == dataclasses.astuple(proof_j)
    assert tgkr.verify(layered(tgkr), ins, outs_j, proof_j, P)
    assert jgkr.verify(layered(jgkr), ins, outs_t, proof_t, P)
    bad = [(outs_t[0] + 1) % P] + outs_t[1:]
    for mod, proof in ((tgkr, proof_j), (jgkr, proof_t)):
        with pytest.raises(ValueError):
            mod.verify(layered(mod), ins, bad, proof, P)
    assert tgkr.verify_in_circuit(tengine.TestEngine(P, {}), layered(tgkr), ins, outs_t, proof_t)


@pytest.fixture(scope="module", params=[2, 4])
def compiled(request):
    n = request.param
    ours = chip_smoke.gkr_circuit(n, 11, builder=tbuilder.Builder, api=tcompile.GkrApi)
    theirs = chip_smoke.gkr_circuit(n, 11, builder=jbuilder.Builder, api=jcompile.GkrApi)
    return n, ours, theirs


def test_gkr_compile_system_and_witness_equal_tpusnark(compiled):
    n, (ours, assign, pubs), (theirs, jassign, jpubs) = compiled
    assert (assign, pubs) == (jassign, jpubs) and len(pubs) == 2 * n
    assert cs_image(ours) == cs_image(theirs)
    assert len(ours.constraints) == {2: 56350, 4: 72588}[n]
    assert tsolver.solve(ours, assign) == jsolver.solve(theirs, assign)


def test_gkr_compile_refuses_a_wrong_output(compiled):
    n, (ours, assign, _), (theirs, _, _) = compiled
    # the port's solver on o0 + 1, tpusnark's on the last instance's s + 1
    for mod, cs, name in ((tsolver, ours, "o0"), (jsolver, theirs, f"s{n - 1}")):
        with pytest.raises(mod.UnsatisfiedConstraintError):
            mod.solve(cs, dict(assign, **{name: (assign[name] + 1) % P}))
