"""The two configurations at their smallest size (ECADD at one call, 2^14;
SHA-256 over its 32 bytes, 2^16): the reference's compile against the
port's, constraint for constraint and by the digest the harness compares,
the seeded inputs against the port's host solver, and the reference's
public columns at tau against the port's own setup scalars.
(A plain prove at these sizes takes tens of minutes on a CPU, so the CPU
runs of the harness itself use the test-size configuration of
``tests/data``; the cells are proved on the card.)"""

import itertools
import json
import random
from pathlib import Path

import pytest

from snarkbench.harness import Spec, compile_circuit
from snarkbench.reference import bn254
from snarkbench.reference.groth16 import MULT_GEN, TrapdoorVerifier, domain_size
from snarkbench.systems.groth16 import r1cs_digest

SMALLEST = {"ecadd64-bn254.serial": {"calls": 1}, "sha256-32B-bn254.serial": {}}


@pytest.fixture(params=sorted(SMALLEST))
def small(request):
    spec = Spec(request.param)
    spec.config = dict(spec.config, **SMALLEST[request.param])
    return spec


def _values(cs, side):
    """Each constraint's three sides as sorted (coefficient, wire) pairs, the
    wires in the finalized order."""
    if side == "program":
        return [
            tuple(tuple(sorted((cs.coeffs[c], v) for c, v in t)) for t in (k.L, k.R, k.O)) for k in cs.constraints
        ]
    order = {"pub": 0, "sec": 1, "int": 2}
    ids = sorted(range(cs.n_wires), key=lambda w: (order[cs.kinds[w]], w))
    perm = {old: new for new, old in enumerate(ids)}
    return [tuple(tuple(sorted((cs.coeffs[c], perm[v]) for c, v in t)) for t in k) for k in cs.constraints]


def test_reference_compile_equals_the_port_compile(small):
    cs = compile_circuit(small, "program", bn254.R)
    rcs = compile_circuit(small, "reference", bn254.R)
    assert cs.public_names == rcs.public_names
    assert cs.n_wires == rcs.n_wires
    assert _values(cs, "program") == _values(rcs, "reference")
    assert r1cs_digest(cs, "program") == r1cs_digest(rcs, "reference")


def test_seeded_statements_satisfy_the_port_host_solver(small):
    from tpusnark_torch.constraint.solver import solve

    cs = compile_circuit(small, "program", bn254.R)
    for st in itertools.islice(small.circuit.inputs(small.config, random.Random(2**31 + 17)), 2):
        assert set(st) == set(cs.public_names[1:]) | set(cs.secret_names)
        solve(cs, st)


def test_reference_public_columns_equal_the_port_setup_scalars(small):
    from tpusnark_torch.backend.groth16.setup import _qap_eval_at_t

    cs = compile_circuit(small, "program", bn254.R)
    rcs = compile_circuit(small, "reference", bn254.R)
    draws = [random.Random(9).randrange(1, bn254.R) for _ in range(5)]
    alpha, beta, _, _, t = draws
    n = domain_size(len(rcs.constraints))
    A, B, C = _qap_eval_at_t(cs, t, n, pow(MULT_GEN, (bn254.R - 1) // n, bn254.R))
    want = [(beta * A[w] + alpha * B[w] + C[w]) % bn254.R for w in range(cs.n_public)]
    assert TrapdoorVerifier(rcs.public_columns(), len(rcs.constraints), draws).k == want


def test_ecadd_inputs_cover_the_edge_cases_and_never_repeat():
    spec = Spec("ecadd64-bn254.serial")
    cfg = dict(spec.config, calls=4)
    batches = list(itertools.islice(spec.circuit.inputs(cfg, random.Random(5)), 3))

    def point(st, name, call):
        return tuple(sum(st[f"{name}{x}{call}_{i}"] << (64 * i) for i in range(4)) for x in "xy")

    for st in batches:
        assert point(st, "r", 2) == (0, 0) and point(st, "q", 2) == bn254.G1.neg(point(st, "p", 2))
        assert point(st, "r", 1) == bn254.G1.double(point(st, "p", 1))
        for call in (0, 3):
            assert point(st, "r", call) == bn254.G1.add(point(st, "p", call), point(st, "q", call))
    for call in range(4):
        assert point(batches[1], "p", call) == bn254.G1.add(point(batches[0], "p", call), bn254.G1_GEN)
    assert len({repr(sorted(st.items())) for st in batches}) == 3


def test_configuration_files_state_their_source_and_cuts():
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        cfg = json.loads((Path(__file__).resolve().parents[2] / entry["file"]).read_text())
        assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["assumed"] and cfg["guarantees"]
