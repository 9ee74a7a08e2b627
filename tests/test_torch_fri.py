"""The port's FRI (tpusnark_torch/poly/fri.py) against tpusnark's
(tpusnark/poly/fri.py) on seeded inputs: Merkle roots and paths, the LDE
and commit on CPU tensors, the proximity proof field for field under the
same transcript, and each package's verifier on the other's proofs. The
host parts (the tree, the proof containers, the verifier, the final
layer's interpolation) are tpusnark's code."""

import random

import pytest
import torch

import tpusnark.poly.fri as jfri
import tpusnark.protocols.sumcheck as jsum
import tpusnark_torch.poly.fri as tfri
import tpusnark_torch.protocols.sumcheck as tsum
from chip_smoke import fri_image
from tests.test_torch_host import code_without_docstrings
from tpusnark.fields.spec import BN254_FR as JSPEC
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.fields.tfield import get_field

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
fr = get_field(BN254_FR)

HOST_PARTS = ("_h", "_fe", "MerkleTree", "FriParams", "FriLayerOpening", "FriQuery", "FriProof")


@pytest.mark.parametrize("name", HOST_PARTS + ("FriScheme.verify_proximity", "FriScheme._interpolate_final"))
def test_fri_host_parts_are_tpusnark_code(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert code_without_docstrings(get(tfri)) == code_without_docstrings(get(jfri))


def seeded_leaves(n, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(P) for _ in range(n)]
    vals[1] = vals[n // 2] = 0  # B2 gives p for zero: the leaf must be 0's
    vals[2] = P - 1
    return vals


@pytest.mark.parametrize("n", (4, 16, 256))
def test_merkle_roots_and_paths_equal_tpusnark(n):
    vals = seeded_leaves(n, n)
    theirs = jfri.MerkleTree(vals)
    host = tfri.MerkleTree(vals)
    # from Montgomery words: B2, canon, the leaf bytes; lane 1 holds zero as
    # the lazy representative p, which B2 maps to p
    words = fr.encode(vals)
    words[:, 1] = fr._p_words("cpu")
    assert fr.from_mont(words)[:, 1].tolist() == fr._p_words("cpu").tolist()
    ours = tfri.CodewordTree(tfri.leaf_bytes(fr, words))
    assert ours.levels == host.levels == theirs.levels
    for i in range(n):
        assert ours.value(i) == vals[i]
        assert ours.path(i) == theirs.path(i)
        assert jfri.MerkleTree.verify_path(ours.root, i, vals[i], ours.path(i))
    assert not tfri.MerkleTree.verify_path(ours.root, 1, 1, ours.path(1))


def schemes(n, params):
    return (
        jfri.FriScheme(JSPEC, n, jfri.FriParams(*params)),
        tfri.FriScheme(BN254_FR, n, tfri.FriParams(*params), device="cpu"),
    )


@pytest.mark.parametrize("n", (64, 128, 256))
def test_lde_and_commit_equal_tpusnark(n):
    J, T = schemes(n, (8, 6, 4))
    assert (T.N, T.offset, T.omega) == (J.N, J.offset, J.omega)
    coeffs = seeded_leaves(n, 100 + n)[: n - 3]  # degree < n, shorter than n
    root_j, (cw_j, tree_j) = J.commit(coeffs)
    root_t, (cw_t, tree_t) = T.commit(fr.encode(coeffs))
    assert fr.decode(cw_t) == cw_j == J.lde(coeffs)
    assert fr.decode(T.lde(fr.encode(coeffs))) == cw_j
    assert root_t == root_j and tree_t.levels == tree_j.levels
    assert T.ntt.domain.coset_shift == J.dom.mult_gen
    # a batch of columns: one LDE, each root tpusnark's
    rows = [coeffs, [0] * 5, seeded_leaves(n, 7)]
    stack = torch.stack([torch.cat([fr.encode(r), fr.zeros((n - len(r),))], dim=1) for r in rows], dim=1)
    assert [root for root, _ in T.commit_many(stack)] == [J.commit(r)[0] for r in rows]


@pytest.fixture(scope="module", params=[(64, (8, 10, 4)), (256, (8, 27, 8)), (128, (4, 5, 2))], ids=str)
def proofs(request):
    n, params = request.param
    J, T = schemes(n, params)
    coeffs = seeded_leaves(n, n + 1)
    root_j, (cw_j, _) = J.commit(coeffs)
    root_t, (cw_t, _) = T.commit(fr.encode(coeffs))
    pj = J.prove_proximity(cw_j, jsum.Transcript(P))
    pt = T.prove_proximity(cw_t, tsum.Transcript(P))
    return J, T, root_j, root_t, pj, pt


def test_proximity_proof_equals_tpusnark(proofs):
    J, T, root_j, root_t, pj, pt = proofs
    assert root_t == root_j
    assert fri_image(pt) == fri_image(pj)
    assert len(pt.layer_roots) >= 1 and len(pt.queries) == T.params.n_queries


def test_each_verifier_accepts_the_others_proof(proofs):
    J, T, root_j, root_t, pj, pt = proofs
    assert J.verify_proximity(root_j, pt, jsum.Transcript(P))
    assert T.verify_proximity(root_t, pj, tsum.Transcript(P))
    assert T.verify_proximity(root_t, pt, tsum.Transcript(P))


@pytest.mark.parametrize("what", ("value", "sibling", "final"))
def test_each_verifier_rejects_a_changed_layer_value(proofs, what):
    import copy

    J, T, root_j, root_t, pj, pt = proofs
    bad = copy.deepcopy(pt)
    if what == "final":
        bad.final_poly[0] = (bad.final_poly[0] + 1) % P
    else:
        op = bad.queries[1].layers[-1]
        setattr(op, what, (getattr(op, what) + 1) % P)
    assert not J.verify_proximity(root_j, bad, jsum.Transcript(P))
    assert not T.verify_proximity(root_t, bad, tsum.Transcript(P))


def test_fri_scheme_defaults_to_the_card():
    """The scheme names the card by default and needs it first in lde; the
    verifier runs without one."""
    T = tfri.FriScheme(BN254_FR, 64)
    assert T.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.lde(fr.encode([1, 2, 3]))
