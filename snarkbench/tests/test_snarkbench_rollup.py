"""The rollup configuration at test size (batch 1 and 2 over 4 accounts, 2
siblings a proof): the reference's compile against the port's, constraint
for constraint and by the digest the harness compares; the seeded inputs
against the port's host solver; the reference's public columns at tau
against the port's setup scalars; the reference's Keccak-256, MiMC,
Merkle tree and EdDSA against known vectors and the port's host copies;
and the generator's chain of state. (The cell itself, 34 transfers over
16 accounts at 2^20, is compiled and proved on the card.)"""

import itertools
import random

import pytest

from snarkbench.harness import Spec, compile_circuit
from snarkbench.reference import bn254
from snarkbench.reference import rollup as ref
from snarkbench.reference.groth16 import MULT_GEN, TrapdoorVerifier, domain_size
from snarkbench.systems.groth16 import r1cs_digest

CELL = "rollup-bn254.serial"
SEED = 2**33 + 2**31 + 12345  # larger than 32 signed bits hold, as run.py's --seed may be


def _spec(batch: int) -> Spec:
    spec = Spec(CELL)
    spec.config = dict(spec.config, batch=batch, accounts=4, depth=2)
    return spec


@pytest.fixture(scope="module", params=[1, 2], ids=["batch1", "batch2"])
def compiled(request):
    spec = _spec(request.param)
    return spec, compile_circuit(spec, "program", bn254.R), compile_circuit(spec, "reference", bn254.R)


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


def test_reference_compile_equals_the_port_compile(compiled):
    _, cs, rcs = compiled
    assert cs.public_names == rcs.public_names == ["1", "root_before", "root_after"]
    assert cs.secret_names == rcs.secret_names
    assert cs.n_wires == rcs.n_wires
    assert _values(cs, "program") == _values(rcs, "reference")
    assert r1cs_digest(cs, "program") == r1cs_digest(rcs, "reference")


def test_seeded_statements_satisfy_the_port_host_solver(compiled):
    from tpusnark_torch.constraint.solver import solve

    spec, cs, _ = compiled
    for st in itertools.islice(spec.circuit.inputs(spec.config, random.Random(SEED)), 2):
        assert set(st) == set(cs.public_names[1:]) | set(cs.secret_names)
        solve(cs, st)


def test_reference_public_columns_equal_the_port_setup_scalars(compiled):
    from tpusnark_torch.backend.groth16.setup import _qap_eval_at_t

    _, cs, rcs = compiled
    draws = [random.Random(9).randrange(1, bn254.R) for _ in range(5)]
    alpha, beta, _, _, t = draws
    n = domain_size(len(rcs.constraints))
    A, B, C = _qap_eval_at_t(cs, t, n, pow(MULT_GEN, (bn254.R - 1) // n, bn254.R))
    want = [(beta * A[w] + alpha * B[w] + C[w]) % bn254.R for w in range(cs.n_public)]
    assert TrapdoorVerifier(rcs.public_columns(), len(rcs.constraints), draws).k == want


def test_a_wrong_root_breaks_the_port_host_solve():
    from tpusnark_torch.constraint.solver import UnsatisfiedConstraintError, solve

    spec = _spec(1)
    cs = compile_circuit(spec, "program", bn254.R)
    st = next(spec.circuit.inputs(spec.config, random.Random(SEED)))
    with pytest.raises(UnsatisfiedConstraintError):
        solve(cs, dict(st, root_after=(st["root_after"] + 1) % bn254.R))


@pytest.mark.parametrize(
    "msg, digest",
    [
        (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
        (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
    ],
)
def test_keccak256_matches_the_legacy_vectors(msg, digest):
    assert ref.keccak256(msg).hex() == digest


def test_keccak256_matches_the_port_across_block_boundaries():
    from tpusnark_torch.hashes.keccak import keccak256

    rng = random.Random(4)
    for n in (1, 32, 135, 136, 137, 271, 272, 300):
        msg = rng.randbytes(n)
        assert ref.keccak256(msg) == keccak256(msg)


def test_mimc_constants_and_hashes_equal_the_port():
    from tpusnark_torch.hashes.mimc import mimc_constants, mimc_hash

    assert ref.mimc_constants() == mimc_constants()
    rng = random.Random(5)
    for n in (1, 2, 5, 6):
        vals = [rng.randrange(bn254.R) for _ in range(n)]
        assert ref.mimc(vals) == mimc_hash(vals)


def test_merkle_roots_paths_and_updates_equal_the_port():
    from tpusnark_torch.gadgets.merkle import merkle_path, merkle_root

    rng = random.Random(6)
    leaves = [rng.randrange(bn254.R) for _ in range(8)]
    tree = ref.MerkleTree(leaves)
    assert tree.root == merkle_root(leaves, bn254.R)
    for i in range(8):
        assert tree.path(i) == merkle_path(leaves, i, bn254.R)[0]
    leaves[2], leaves[7] = 11, 13
    tree.update({2: 11, 7: 13})
    assert tree.root == merkle_root(leaves, bn254.R) == ref.MerkleTree(leaves).root
    assert tree.path(7) == merkle_path(leaves, 7, bn254.R)[0]


def test_edwards_arithmetic_equals_the_port():
    from tpusnark_torch.curves import edwards

    assert (ref.EDWARDS_A, ref.EDWARDS_D, ref.BASE, ref.ORDER) == (edwards.A, edwards.D, edwards.base(), edwards.ORDER)
    assert ref.on_curve(ref.BASE) and ref.mul(ref.BASE, ref.ORDER) == ref.IDENTITY
    for k in (1, 2, 15, 16, 255, ref.ORDER - 1, 2**253 + 7):
        assert ref.mul_base(k) == ref.mul(ref.BASE, k) == edwards.mul(edwards.base(), k)
    p, q = ref.mul_base(5), ref.mul_base(9)
    assert ref.add(p, q) == edwards.add(p, q) == ref.mul_base(14)


def test_eddsa_signatures_equal_the_port_and_verify_there():
    from tpusnark_torch.curves import edwards

    rng = random.Random(7)
    for _ in range(3):
        kp = ref.keygen(rng)
        port_kp = edwards.EddsaKeypair(sk=kp.sk, pk=edwards.mul(edwards.base(), kp.sk), nonce_key=kp.nonce_key)
        assert kp.pk == port_kp.pk
        msg = rng.randrange(bn254.R)
        big_r, s = ref.sign(kp, msg)
        assert (big_r, s) == edwards.eddsa_sign(port_kp, msg)
        assert edwards.eddsa_verify_native(kp.pk, msg, big_r, s)
        assert ref.verify(kp.pk, msg, big_r, s)
        assert not edwards.eddsa_verify_native(kp.pk, msg + 1, big_r, s)
        assert not ref.verify(kp.pk, msg + 1, big_r, s)


def _balances(st, batch):
    """Each account's balance and nonce as the batch leaves them."""
    out = {}
    for j in range(batch):
        for role in ("sender", "receiver"):
            idx = st[f"t{j}_{role}_after_index"]
            out[idx] = (st[f"t{j}_{role}_after_balance"], st[f"t{j}_{role}_after_nonce"])
    return out


def test_the_generator_chains_its_state_and_never_repeats():
    spec = _spec(3)
    cfg = spec.config
    batches = list(itertools.islice(spec.circuit.inputs(cfg, random.Random(SEED)), 4))
    again = list(itertools.islice(spec.circuit.inputs(cfg, random.Random(SEED)), 4))
    other = next(spec.circuit.inputs(cfg, random.Random(SEED + 1)))
    assert batches == again and batches[0] != other
    assert len({repr(sorted(st.items())) for st in batches}) == 4
    for prev, st in zip(batches, batches[1:]):
        assert st["root_before"] == prev["root_after"]
    for st in batches:
        roots = [st["root_before"], *(st[f"root_mid_{j}"] for j in range(2)), st["root_after"]]
        for j in range(3):
            pre, post = f"t{j}_sender_before_", f"t{j}_sender_after_"
            assert st[f"t{j}_sender_before_index"] != st[f"t{j}_receiver_before_index"]
            assert 1 <= st[f"t{j}_amount"] <= min(1 << 20, st[pre + "balance"])
            assert st[post + "balance"] == st[pre + "balance"] - st[f"t{j}_amount"] >= 0
            assert st[post + "nonce"] == st[pre + "nonce"] + 1
            leaf = ref.mimc([st[pre + k] for k in ("index", "nonce", "balance", "pub_x", "pub_y")])
            node, idx = leaf, st[pre + "index"]
            for i in range(cfg["depth"]):
                sib = st[f"path_t{j}_sender_before_{i}"]
                node = ref.mimc([sib, node] if idx >> i & 1 else [node, sib])
            assert node == roots[j]
            digest = ref.transfer_digest(st[pre + "nonce"], st[f"t{j}_amount"],
                                         (st[pre + "pub_x"], st[pre + "pub_y"]),
                                         (st[f"t{j}_receiver_before_pub_x"], st[f"t{j}_receiver_before_pub_y"]))
            assert ref.verify((st[pre + "pub_x"], st[pre + "pub_y"]), digest,
                              (st[f"t{j}_sig_rx"], st[f"t{j}_sig_ry"]), st[f"t{j}_sig_s"])
        assert all(bal >= 0 for bal, _ in _balances(st, 3).values())
