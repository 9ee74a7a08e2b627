"""The port's test-corpus layer against tpusnark's: ``stats.py``,
``testing/{circuits,gobstats,solidity_exec}.py`` are tpusnark's code (and
``latest_stats.json`` its bytes); every CORPUS entry gets tpusnark's
systems and verdicts through the port's engine, Builder and PlonkBuilder;
``stats.collect()`` equals tpusnark's and the port's baseline is clean;
``gobstats.load_stats`` reads a gob blob built here as tpusnark's does; the
Solidity interpreter gives tpusnark's verdicts on the port's Groth16 and
PLONK contracts and tiny proofs made on CPU tensors."""

import os
import random
from importlib import import_module

import pytest
import torch

import tpusnark.constraint.scs as jscs
import tpusnark.constraint.solver as jsolver
import tpusnark.frontend.builder as jbuilder
import tpusnark.frontend.plonk_builder as jpb
import tpusnark.stats as jstats
import tpusnark.testing.circuits as jcircuits
import tpusnark.testing.engine as jengine
import tpusnark.testing.gobstats as jgob
import tpusnark.testing.solidity_exec as jsol
import tpusnark_torch.constraint.scs as tscs
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.frontend.builder as tbuilder
import tpusnark_torch.frontend.plonk_builder as tpb
import tpusnark_torch.stats as tstats
import tpusnark_torch.testing.circuits as tcircuits
import tpusnark_torch.testing.engine as tengine
import tpusnark_torch.testing.gobstats as tgob
import tpusnark_torch.testing.solidity_exec as tsol
from tests.test_torch_host import code_without_docstrings, cs_image, scs_image
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus

COPIES = ("stats", "testing.circuits", "testing.gobstats", "testing.solidity_exec")


@pytest.mark.parametrize("name", COPIES)
def test_testing_modules_are_tpusnark_code(name):
    ours = import_module(f"tpusnark_torch.{name}")
    theirs = import_module(f"tpusnark.{name}")
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def test_latest_stats_is_tpusnarks_file():
    with open(tstats.LATEST, "rb") as f, open(jstats.LATEST, "rb") as g:
        assert f.read() == g.read()
    assert os.path.dirname(tstats.LATEST) == os.path.dirname(tstats.__file__)


# ------------------------------------------------------------------ corpus
def verdicts(entry, engine, builder, plonk_builder, solve, solve_scs):
    """(engine, R1CS, SCS) verdicts on the entry's valid then invalid
    assignments, and the two compiled systems."""
    assignments = entry.valid + entry.invalid

    def solves(fn, cs, a):
        try:
            fn(cs, a)
            return True
        except Exception:
            return False

    b = builder.Builder(P)
    entry.define(b)
    r1cs = b.compile()
    out = {
        "engine": [engine.is_solved(entry.define, P, a) for a in assignments],
        "r1cs": [solves(solve, r1cs, a) for a in assignments],
        "r1cs_image": cs_image(r1cs),
    }
    if not entry.r1cs_only:
        b = plonk_builder.PlonkBuilder(P)
        entry.define(b)
        scs = b.compile()
        out["scs"] = [solves(solve_scs, scs, a) for a in assignments]
        out["scs_image"] = scs_image(scs)
    return out


@pytest.mark.parametrize("name", sorted(jcircuits.CORPUS))
def test_corpus_entry_gives_tpusnark_verdicts(name):
    ours, theirs = tcircuits.CORPUS[name], jcircuits.CORPUS[name]
    assert (ours.valid, ours.invalid, ours.r1cs_only) == (theirs.valid, theirs.invalid, theirs.r1cs_only)
    got = verdicts(ours, tengine, tbuilder, tpb, tsolver.solve, tscs.solve_scs)
    want = verdicts(theirs, jengine, jbuilder, jpb, jsolver.solve, jscs.solve_scs)
    assert got == want
    expect = [True] * len(ours.valid) + [False] * len(ours.invalid)
    assert got["engine"] == got["r1cs"] == expect
    assert got.get("scs", expect) == expect


def test_corpus_names_equal_tpusnark():
    assert sorted(tcircuits.CORPUS) == sorted(jcircuits.CORPUS)


# ------------------------------------------------------------------- stats
def test_stats_collect_equals_tpusnark_and_the_baseline_is_clean():
    ours = tstats.collect()
    assert ours == jstats.collect()
    assert len(ours) >= 20
    assert tstats.check_against_baseline() == []


# ----------------------------------------------------------------- gobstats
def gob_uint(v):
    if v < 0x80:
        return bytes([v])
    body = v.to_bytes((v.bit_length() + 7) // 8, "big")
    return bytes([256 - len(body)]) + body


def gob_int(v):
    return gob_uint(v << 1 if v >= 0 else (~v << 1) | 1)


def gob_blob(table):
    """gob.Encode of map[string][4][8]snippetStats as load_stats reads it:
    a type-definition message (skipped), then the value: its type id, a
    zero delta, the count, and per entry its name and the 4 x 8 structs
    (fields delta-encoded, zero fields omitted, 0-terminated)."""
    typedef = gob_int(-65) + b"\x01\x02type definition body"
    value = gob_int(65) + gob_uint(0) + gob_uint(len(table))
    for name, rows in table.items():
        value += gob_uint(len(name)) + name.encode() + gob_uint(4)
        for row in rows:
            value += gob_uint(8)
            for nb_constraints, nb_wires in row:
                fields = b""
                last = -1
                for i, v in enumerate((nb_constraints, nb_wires)):
                    if v:
                        fields += gob_uint(i - last) + gob_int(v)
                        last = i
                value += fields + gob_uint(0)
    return gob_uint(len(typedef)) + typedef + gob_uint(len(value)) + value


def test_gobstats_loads_a_built_blob_as_tpusnark(tmp_path):
    rng = random.Random(17)
    table = {
        name: [[(rng.choice([0, 1, 300, 70000, 2**40]), rng.choice([0, 5, 2**20])) for _ in range(8)] for _ in range(4)]
        for name in ("math/bits.ToBinary", "std/hash/mimc", "pairing_bn254")
    }
    path = tmp_path / "latest.stats"
    path.write_bytes(gob_blob(table))
    ours = tgob.load_stats(str(path))
    assert ours == jgob.load_stats(str(path))
    assert set(ours) == set(table)
    for name, rows in table.items():
        for backend, row in zip(tgob.BACKENDS, rows):
            assert [ours[name][backend][c] for c in tgob.CURVES] == row
    path.write_bytes(gob_blob(table)[:-3])
    for mod in (tgob, jgob):
        with pytest.raises((AssertionError, IndexError)):
            mod.load_stats(str(path))


# ----------------------------------------------------------- solidity_exec
def cubic(mod):
    b = mod.Builder(P) if hasattr(mod, "Builder") else mod.PlonkBuilder(P)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


@pytest.fixture(scope="module")
def contracts():
    """The port's Groth16 and PLONK contracts and calldata for tiny proofs
    made on CPU tensors."""
    from tpusnark_torch.backend import groth16, plonk
    from tpusnark_torch.backend.groth16 import solidity as g16_sol
    from tpusnark_torch.backend.plonk import solidity as plonk_sol

    st = random.Random(21)
    cs = cubic(tbuilder)
    pk, vk = groth16.setup(cs, rng=lambda: st.randrange(1, P), device="cpu")
    proof = groth16.prove(cs, pk, {"x": 3, "y": 35}, rng=lambda: st.randrange(1, P), device="cpu")
    out = {"groth16": (g16_sol.export_solidity(vk), g16_sol.proof_to_solidity_calldata(proof))}
    cs = cubic(tpb)
    pk, vk = plonk.setup(cs, tau=98765, device="cpu")
    proof = plonk.prove(cs, pk, {"x": 3, "y": 35}, rng=lambda: st.randrange(1, P))
    out["plonk"] = (plonk_sol.export_solidity(vk), plonk_sol.proof_to_solidity_calldata(proof))
    return out


def run(mod, src, words, pubs):
    """True iff mod's interpreter runs verifyProof without a revert."""
    try:
        mod.Contract(src).call("verifyProof", list(words), pubs)
        return True
    except mod.ContractRevert:
        return False


@pytest.mark.parametrize("scheme", ("groth16", "plonk"))
def test_solidity_interpreter_gives_tpusnark_verdicts(contracts, scheme):
    src, words = contracts[scheme]
    assert tsol.tokenize(src) == jsol.tokenize(src)
    bad = list(words)
    bad[0] = (bad[0] + 1) % P
    cases = [(words, [35], True), (words, [36], False), (words, [35 + P], False), (bad, [35], False)]
    for w, pubs, expect in cases:
        assert run(tsol, src, w, pubs) is expect
        assert run(jsol, src, w, pubs) is expect
