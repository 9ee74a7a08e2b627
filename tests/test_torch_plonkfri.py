"""The port's PlonkFRI (tpusnark_torch/backend/plonkfri) against tpusnark's
on tests/test_plonkfri.py's circuits (cubic and product) and chip_smoke's
PLONK chain at 2^9 (its qc column is zero everywhere), with the fast and
the default FRI parameters: setup and prove on CPU tensors give
tpusnark's keys and proofs field for field (every root, opening and FRI
layer), each package's verifier accepts the other's proof and rejects a
wrong public input, a tampered opening and a zeroed root. The containers
and the verifier are tpusnark's code; setup and prove name the card by
default."""

import copy
from importlib import import_module

import pytest
import torch

import chip_smoke
import tpusnark.backend.plonkfri as jpf
import tpusnark.frontend.plonk_builder as jpb
import tpusnark.poly.fri as jfri
import tpusnark_torch.backend.plonkfri as tpf
import tpusnark_torch.frontend.plonk_builder as tpb
import tpusnark_torch.poly.fri as tfri
from chip_smoke import fri_image
from tests.test_torch_host import code_without_docstrings
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
jscheme = import_module("tpusnark.backend.plonkfri.scheme")
tscheme = import_module("tpusnark_torch.backend.plonkfri.scheme")

COPIES = ("verify", "PlonkFriVerifyingKey", "ColumnOpening", "IdentityQuery", "PlonkFriProof")


@pytest.mark.parametrize("name", COPIES)
def test_plonkfri_host_parts_are_tpusnark_code(name):
    assert code_without_docstrings(getattr(tscheme, name)) == code_without_docstrings(getattr(jscheme, name))
    for const in ("FIXED_COLS", "ONLINE_COLS", "H_COLS", "ALL_COLS", "N_IDENTITY_QUERIES"):
        assert getattr(tscheme, const) == getattr(jscheme, const)


def cubic(mod):
    b = mod.PlonkBuilder(P)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile(), {"x": 3, "y": 35}, [35]


def product(mod):
    b = mod.PlonkBuilder(P)
    xs = [b.secret(f"x{i}") for i in range(6)]
    out = b.public("out")
    acc = 1
    for x in xs:
        acc = b.mul(acc, b.add(x, 1))
    b.assert_is_equal(acc, out)
    vals = [3, 1, 4, 1, 5, 9]
    expected = 1
    for v in vals:
        expected = expected * (v + 1) % P
    assign = {f"x{i}": v for i, v in enumerate(vals)}
    assign["out"] = expected
    return b.compile(), assign, [expected]


def chain(mod):
    cs, assign = chip_smoke.plonk_chain(9, P, builder=mod.PlonkBuilder)
    return cs, assign, [assign["y"]]


CIRCUITS = {"cubic": cubic, "product": product, "chain": chain}
FAST = (8, 8, 4)
DEFAULT = (8, 27, 8)


@pytest.fixture(scope="module", params=[(c, p) for c in CIRCUITS for p in (FAST, DEFAULT)], ids=str)
def case(request):
    name, params = request.param
    jcs, jassign, pubs = CIRCUITS[name](jpb)
    tcs, tassign, _ = CIRCUITS[name](tpb)
    jpk, jvk = jpf.setup(jcs, jfri.FriParams(*params))
    tpk, tvk = tpf.setup(tcs, tfri.FriParams(*params), device="cpu")
    jproof = jpf.prove(jcs, jpk, jassign)
    tproof = tpf.prove(tcs, tpk, tassign, device="cpu")
    return dict(name=name, params=params, pubs=pubs, jvk=jvk, tvk=tvk, jpk=jpk, tpk=tpk, jproof=jproof, tproof=tproof)


def test_setup_equals_tpusnark(case):
    jvk, tvk = case["jvk"], case["tvk"]
    assert fri_image(tvk) == fri_image(jvk)
    for name, coeffs in case["jpk"].fixed_coeffs.items():
        assert tscheme._fr.decode(case["tpk"].fixed_coeffs[name]) == coeffs
        cw, tree = case["tpk"].fixed_codewords[name]
        assert tscheme._fr.decode(cw) == case["jpk"].fixed_codewords[name][0]
        assert tree.levels == case["jpk"].fixed_codewords[name][1].levels


def test_proof_equals_tpusnark_field_for_field(case):
    jp, tp = case["jproof"], case["tproof"]
    assert tp.online_roots == jp.online_roots
    assert fri_image(tp.identity_queries) == fri_image(jp.identity_queries)
    assert fri_image(tp.fri_proof) == fri_image(jp.fri_proof)
    assert fri_image(tp.fri_queries) == fri_image(jp.fri_queries)
    assert fri_image(tp) == fri_image(jp)


def test_each_verifier_gives_tpusnark_verdicts(case):
    """Both verifiers accept both proofs where the FRI proof has a layer;
    with none (n = 8 at the default parameters, whose stop degree is 8: the
    codeword is the final layer already) tpusnark's own verifier rejects
    its own proof, and the port's gives the same verdict."""
    pubs = case["pubs"]
    accepts = case["jvk"].n > case["params"][2]
    assert accepts == bool(case["jproof"].fri_proof.layer_roots) == bool(case["tproof"].fri_proof.layer_roots)
    assert accepts or case["name"] != "chain"
    for proof in (case["jproof"], case["tproof"]):
        assert jpf.verify(proof, case["jvk"], pubs) is accepts
        assert tpf.verify(proof, case["tvk"], pubs) is accepts


def tampered(proof, pubs):
    bad_opening = copy.deepcopy(proof)
    op = bad_opening.identity_queries[0].openings["l"]
    op.value = (op.value + 1) % P
    bad_root = copy.deepcopy(proof)
    bad_root.online_roots["z"] = bytes(32)
    return {
        "wrong public input": (proof, [(pubs[0] + 1) % P] + pubs[1:]),
        "tampered opening": (bad_opening, pubs),
        "zeroed root": (bad_root, pubs),
    }


@pytest.mark.parametrize("what", ("wrong public input", "tampered opening", "zeroed root"))
def test_each_verifier_rejects(case, what):
    for proof in (case["jproof"], case["tproof"]):
        bad, pubs = tampered(proof, case["pubs"])[what]
        assert not jpf.verify(bad, case["jvk"], pubs)
        assert not tpf.verify(bad, case["tvk"], pubs)


def test_setup_and_prove_name_the_card_by_default(monkeypatch):
    cs, assign, _ = cubic(tpb)
    pk, _ = tpf.setup(cs, tfri.FriParams(*FAST), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpf.setup(cs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpf.prove(cs, pk, assign)


def test_commitments_are_refused_as_tpusnark_refuses_them():
    b = tpb.PlonkBuilder(P)
    x = b.secret("x")
    b.assert_is_different(x, b.commit(x))
    with pytest.raises(NotImplementedError, match="BSB22"):
        tpf.setup(b.compile(), device="cpu")


def test_launch_count_of_a_prove_follows_the_scheme():
    """chip_smoke's pass count for a 2^14 prove: 4 transforms over n and 5
    over 8n, each as many launches as its plan has passes."""
    from tpusnark_torch.fields.tfield import n_words
    from tpusnark_torch.poly.ntt import max_stages, pass_plan

    cap = max_stages(n_words(BN254_FR))
    want = 4 * len(pass_plan(14, cap)) + 5 * len(pass_plan(17, cap))
    assert chip_smoke.plonkfri_launches_expected(1 << 14, 8, "prove") == want
    assert chip_smoke.plonkfri_launches_expected(1 << 14, 8, "setup") == len(pass_plan(14, cap)) + len(pass_plan(17, cap))
