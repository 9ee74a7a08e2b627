"""The reference on its own: BN254 arithmetic and SHA-256 against known
vectors, the trapdoor Groth16 check on a small circuit, and the import rules
of the benchmark's folder."""

import ast
import hashlib
import random
from pathlib import Path

import pytest

from snarkbench.reference import bn254
from snarkbench.reference.frontend.r1cs import Builder
from snarkbench.reference.groth16 import TrapdoorVerifier, domain_size, lagrange_at
from snarkbench.reference.sha256 import sha256

HERE = Path(__file__).resolve().parent.parent
# 2 G on alt_bn128, the EIP-196 ECADD of (1, 2) with itself
TWO_G = (
    1368015179489954701390400359078579693043519447331113978918064868415326638035,
    9918110051302171585080402603319702774565515993150576347155970296011118125764,
)


def test_bn254_addition_matches_the_eip196_vector_and_its_edge_cases():
    g = bn254.G1_GEN
    assert bn254.G1.add(g, g) == TWO_G
    assert bn254.G1.on_curve(TWO_G)
    assert bn254.G1.add(g, bn254.G1.neg(g)) is None
    assert bn254.G1.add(None, g) == g
    assert bn254.G1.add(TWO_G, bn254.G1.neg(g)) == g


@pytest.mark.parametrize("k", [1, 2, 3, 2**64 + 1, bn254.R - 1, bn254.R, bn254.R + 5, 123456789123456789])
def test_jacobian_scalar_multiplication_equals_the_affine_one(k):
    assert bn254.g1_mul_jacobian(bn254.G1_GEN, k) == bn254.G1.mul(bn254.G1_GEN, k)


@pytest.mark.parametrize(
    "msg, digest",
    [
        (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
        (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
        (
            b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
            "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
        ),
    ],
)
def test_sha256_matches_the_fips_180_4_vectors(msg, digest):
    assert sha256(msg).hex() == digest


def test_sha256_matches_hashlib_across_block_boundaries():
    rng = random.Random(1)
    for n in (1, 31, 32, 55, 56, 63, 64, 65, 200):
        msg = bytes(rng.randrange(256) for _ in range(n))
        assert sha256(msg) == hashlib.sha256(msg).digest()


def test_lagrange_basis_sums_to_one_and_interpolates():
    t, n = 987654321, 8
    lag = lagrange_at(t, n, n)
    assert sum(lag) % bn254.R == 1
    w = pow(5, (bn254.R - 1) // n, bn254.R)
    # sum_j w^j L_j(t) = t for a polynomial of degree < n
    assert sum(pow(w, j, bn254.R) * lag[j] for j in range(n)) % bn254.R == t
    assert domain_size(5) == 8 and domain_size(8) == 8 and domain_size(1) == 1


def _small_circuit():
    b = Builder(bn254.R)
    x = b.secret("x")
    y = b.public("y")
    z = b.public("z")
    b.assert_is_equal(b.mul(x, x), y)
    b.assert_is_equal(b.add(b.mul(y, x), 3), z)
    return b.compile()


def _simulated_proof(verifier, draws, publics, a, b):
    """A proof made with the trapdoor: A = a G1, B = b G2, C chosen so that
    the Groth16 equation holds for `publics`."""
    alpha, beta, _gamma, delta = draws[:4]
    k = (verifier.alpha_beta + verifier.k[0] + sum(x * ki for x, ki in zip(publics, verifier.k[1:]))) % bn254.R
    c = (a * b - k) * pow(delta, -1, bn254.R) % bn254.R
    B = bn254.G2.mul(bn254.G2.generator(), b)
    return (
        bn254.G1.mul(bn254.G1_GEN, a),
        ((B[0].c0, B[0].c1), (B[1].c0, B[1].c1)),
        bn254.G1.mul(bn254.G1_GEN, c),
    )


def test_trapdoor_check_accepts_a_valid_proof_and_refuses_wrong_ones():
    rcs = _small_circuit()
    draws = [11, 22, 33, 44, 55]
    v = TrapdoorVerifier(rcs.public_columns(), len(rcs.constraints), draws)
    x = 7
    publics = [x * x % bn254.R, (x**3 + 3) % bn254.R]
    proof = _simulated_proof(v, draws, publics, 5, 9)
    assert v.check(proof, publics) is None
    assert v.check(proof, [publics[0], publics[1] + 1]) == "the pairing equation fails"
    a, b, c = proof
    assert v.check((bn254.G1.add(a, bn254.G1_GEN), b, c), publics) == "the pairing equation fails"
    assert v.check(proof, publics[:1]) is not None


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                yield node.args[0].value
    # dotted module paths named as data (the configurations' gadget
    # modules, the systems' spans)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "." in node.value:
            if node.value.split(".")[0].isidentifier() and " " not in node.value:
                yield node.value


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "tpusnark"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        tops = {_top(n) for n in _imports(path)}
        assert "tpusnark_torch" not in tops, path
        assert not tops & {"jax", "jaxlib", "flax", "tpusnark"}, path
