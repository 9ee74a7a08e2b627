"""The device solver's split of the prove's ``solve`` phase under
``timings=``: ``solve_levels`` (the host seconds of the levels' launches)
and ``solve_hints`` (those of the hint round trips), on the CPU at a test
size. A device-branch prove writes both, inside ``solve``; a host-branch
prove writes neither; the solver reads no clock without ``timings``; and
the witness, A/B/C and the proof do not change with them.

As in ``test_torch_trace.py``, the key is made on the host (every point a
generator) and each MSM's arithmetic returns the identity: the plain MSMs
take ~25 s a prove on one CPU thread, and none of this is about them."""

import random

import pytest
import torch

import tpusnark_torch.constraint.solver_torch as st
from tpusnark_torch.backend.groth16 import keys as g16keys
from tpusnark_torch.backend.groth16 import prove
from tpusnark_torch.backend.groth16.setup import k_pk_wires_for
from tpusnark_torch.curves.config import get_curve
from tpusnark_torch.fields import spec as tspec
from tpusnark_torch.frontend.builder import Builder
from tpusnark_torch.msm import pippenger
from tpusnark_torch.msm.pippenger import tree_map

torch.set_num_threads(1)  # the suite's workers fill the cores already

CFG = get_curve("bn254")
R = CFG.host.R
PHASES = {"solve", "encode", "h", "msm", "assemble"}
SPLIT = {"solve_levels", "solve_hints"}
ASSIGN = {"x": 5, "z": 7, "y": 1}  # 5 * 7^2 = 245: low bits 1, 0; 245 - 9 is not zero


def circuit():
    """Two hint-bearing levels (bit decompositions, an inverse) around a
    few solved products."""
    b = Builder(R)
    x, z = b.secret("x"), b.secret("z")
    b.to_binary(x, 8)
    xz = b.mul(x, b.mul(z, z))
    bits = b.to_binary(xz, 12)
    b.assert_is_equal(b.add(b.from_binary(bits[:2]), b.is_zero(b.sub(xz, 9))), b.public("y"))
    return b.compile()


def host_key(cs):
    g1, g2 = CFG.host.G1.generator(), CFG.host.G2.generator()
    n = 1 << max(1, (len(cs.constraints) - 1).bit_length())
    kw = k_pk_wires_for(cs)
    return g16keys.ProvingKey(
        alpha_g1=g1, beta_g1=g1, delta_g1=g1, beta_g2=g2, delta_g2=g2,
        a=[g1] * cs.n_wires, b1=[g1] * cs.n_wires, b2=[g2] * cs.n_wires, k=[g1] * len(kw), z=[g1] * (n - 1),
        domain_n=n, k_wires=kw,
    )


def msm_identity(engine, points, scalars):
    x = tree_map(lambda a: a[:, :1].repeat(1, scalars.shape[1]), points[0])
    return engine.ops.identity_like(x)


class NoClock:
    """Stands for the solver module's ``time``: any clock read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with no timings given")


@pytest.fixture(scope="module")
def case():
    cs = circuit()
    return cs, host_key(cs)


@pytest.fixture
def device_branch(monkeypatch):
    monkeypatch.setattr(st, "MIN_TOTAL_INSTRUCTIONS", 1)
    monkeypatch.setattr(st, "MIN_MEAN_LEVEL_WIDTH", 1)
    monkeypatch.setattr(pippenger.MSM, "_msm_core", msm_identity)


def _prove(cs, pk, seed, **kw):
    rng = random.Random(seed)
    return prove(cs, pk, ASSIGN, rng=lambda: rng.randrange(R), device="cpu", **kw)


def test_a_device_branch_prove_writes_the_split_inside_solve(case, device_branch):
    cs, pk = case
    assert st.prefer_device(cs)
    timings: dict = {}
    _prove(cs, pk, 1, timings=timings)
    assert set(timings) == PHASES | SPLIT
    assert timings["solve_levels"] >= 0 and timings["solve_hints"] > 0
    assert timings["solve_levels"] + timings["solve_hints"] <= timings["solve"]
    first = dict(timings)
    _prove(cs, pk, 1, timings=timings)  # a second prove adds to the same keys
    for key in SPLIT:
        assert timings[key] >= first[key]
    assert timings["solve_levels"] + timings["solve_hints"] <= timings["solve"]


def test_a_host_branch_prove_writes_no_split(case, monkeypatch):
    cs, pk = case
    monkeypatch.setattr(pippenger.MSM, "_msm_core", msm_identity)
    assert not st.prefer_device(cs)  # the shape rule's own thresholds
    timings: dict = {}
    _prove(cs, pk, 1, timings=timings)
    assert set(timings) == PHASES


def test_the_solver_reads_no_clock_without_timings(case, device_branch, monkeypatch):
    cs, pk = case
    _prove(cs, pk, 2)  # builds the solver, tables and constants once
    monkeypatch.setattr(st, "time", NoClock())
    _prove(cs, pk, 2)
    st.get_level_solver(cs, tspec.BN254_FR, device="cpu").solve_with_abc(ASSIGN)
    with pytest.raises(AssertionError, match="no timings given"):
        _prove(cs, pk, 2, timings={})


def test_timings_change_neither_the_witness_nor_the_proof(case, device_branch):
    cs, pk = case
    solver = st.get_level_solver(cs, tspec.BN254_FR, device="cpu")
    W0, abc0 = solver.solve_with_abc(ASSIGN)
    W1, abc1 = solver.solve_with_abc(ASSIGN, timings={})
    assert torch.equal(W0, W1)
    assert all(torch.equal(a, b) for a, b in zip(abc0, abc1))
    plain = _prove(cs, pk, 3)
    timed = _prove(cs, pk, 3, timings={})
    assert (plain.ar, plain.bs, plain.krs) == (timed.ar, timed.bs, timed.krs)
