"""The port's circuit library (tpusnark_torch's copies of tpusnark's logger,
hashes, twisted Edwards curve and gadgets) against the originals: each copy
is tpusnark's code; Keccak, SHA3, MiMC, EdDSA and the Merkle helpers give
tpusnark's values on seeded inputs (SHA3-256 also hashlib's); and each
gadget (MiMC, Merkle, twisted Edwards add/double/scalar multiplication,
EdDSA, the uints word ops, SHA-256 of 0, 3 and 64 bytes) builds the same
constraint system with either package's builder, constraint for
constraint, whose witness from the port's host solver and from its level
solver (``LevelSolver(device="cpu")``, the plain versions) equals
tpusnark's host solver's, wire for wire. Exact."""

import hashlib
import random
from importlib import import_module

import pytest
import torch

import tpusnark.constraint.solver as jsolver
import tpusnark_torch.constraint.solver as tsolver
from tests.test_torch_host import code_without_docstrings, cs_image
from tpusnark_torch.constraint.solver_torch import LevelSolver
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.fields.tfield import get_field

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
COPIES = (
    "logger",
    "hashes.keccak",
    "hashes.mimc",
    "curves.edwards",
    "gadgets",
    "gadgets.merkle",
    "gadgets.twistededwards",
    "gadgets.eddsa",
    "gadgets.uints",
    "gadgets.sha2",
)


def both(name):
    """(the port's module, tpusnark's) of a relative name."""
    return import_module(f"tpusnark_torch.{name}"), import_module(f"tpusnark.{name}")


@pytest.mark.parametrize("name", COPIES)
def test_circuit_library_modules_are_tpusnark_code(name):
    ours, theirs = both(name)
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def test_keccak_sha3_and_mimc_values_equal_tpusnark():
    ours, theirs = both("hashes.keccak")
    rng = random.Random(12)
    msgs = [b"", b"seed", bytes(rng.randrange(256) for _ in range(135)), bytes(rng.randrange(256) for _ in range(300))]
    for m in msgs:
        assert ours.keccak256(m) == theirs.keccak256(m)
        assert ours.sha3_256(m) == theirs.sha3_256(m) == hashlib.sha3_256(m).digest()
        assert ours.keccak512(m) == theirs.keccak512(m)
    # the well-known Keccak-256 of the empty string (Ethereum's)
    assert ours.keccak256(b"").hex().startswith("c5d2460186f7233c927e7db2dcc703c0")
    tm, jm = both("hashes.mimc")
    assert tm.mimc_constants() == jm.mimc_constants() and len(tm.mimc_constants()) == tm.N_ROUNDS == 110
    for vals in ([0], [7, 11, 13], [rng.randrange(P) for _ in range(6)]):
        assert tm.mimc_hash(vals) == jm.mimc_hash(vals)


def test_eddsa_and_merkle_values_equal_tpusnark():
    te, je = both("curves.edwards")
    for seed in (b"\x00", b"rollup", bytes(range(40))):
        kt, kj = te.eddsa_keygen(seed), je.eddsa_keygen(seed)
        assert (kt.sk, kt.pk, kt.nonce_key) == (kj.sk, kj.pk, kj.nonce_key)
        assert te.on_curve(kt.pk)
        for msg in (0, 998877, P - 1):
            sig = te.eddsa_sign(kt, msg)
            assert sig == je.eddsa_sign(kj, msg)
            assert te.eddsa_verify_native(kt.pk, msg, *sig) and je.eddsa_verify_native(kj.pk, msg, *sig)
            assert not te.eddsa_verify_native(kt.pk, msg + 1, *sig)
            assert not je.eddsa_verify_native(kj.pk, msg + 1, *sig)
    tmk, jmk = both("gadgets.merkle")
    rng = random.Random(13)
    leaves = [rng.randrange(P) for _ in range(16)]
    assert tmk.merkle_root(leaves, P) == jmk.merkle_root(leaves, P)
    for idx in (0, 5, 15):
        assert tmk.merkle_path(leaves, idx, P) == jmk.merkle_path(leaves, idx, P)


# ---- the gadgets' circuits, each built from one package's modules ----------
def mimc_circuit(pkg):
    mimc = import_module(f"{pkg}.hashes.mimc")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    g = mimc.MiMCGadget(b)
    g.write(*(b.secret(f"m{i}") for i in range(2)))
    b.assert_is_equal(g.sum(), b.public("h"))
    vals = [7, 11]
    return b.compile(), dict({f"m{i}": v for i, v in enumerate(vals)}, h=mimc.mimc_hash(vals))


def merkle_circuit(pkg):
    merkle = import_module(f"{pkg}.gadgets.merkle")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    leaves = [101, 202, 303, 404]
    idx = 2
    sibs, _bits = merkle.merkle_path(leaves, idx, P)
    path = [b.secret(f"p{i}") for i in range(len(sibs))]
    pbits = b.to_binary(b.secret("idx"), len(sibs))
    merkle.verify_merkle_proof(b, b.public("root"), b.secret("leaf"), path, pbits)
    assign = {"root": merkle.merkle_root(leaves, P), "leaf": leaves[idx], "idx": idx}
    return b.compile(), dict(assign, **{f"p{i}": s for i, s in enumerate(sibs)})


EDWARDS_BITS = 16  # the scalar multiplications' width (EdDSA's are 254 bits)


def edwards_circuit(pkg):
    ed = import_module(f"{pkg}.curves.edwards")
    gadget = import_module(f"{pkg}.gadgets.twistededwards").EdwardsGadget
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    curve = gadget(b)
    p1 = (b.secret("x1"), b.secret("y1"))
    p2 = (b.secret("x2"), b.secret("y2"))
    s1, s2 = b.secret("s1"), b.secret("s2")
    curve.assert_on_curve(p1)
    curve.assert_on_curve(p2)
    outs = {
        "add": curve.add(p1, p2),
        "double": curve.double(p1),
        "neg": curve.neg(p2),
        "mul": curve.scalar_mul(p1, s1, EDWARDS_BITS),
        "dbl_mul": curve.double_base_scalar_mul(p1, p2, s1, s2, EDWARDS_BITS),
    }
    for name, pt in outs.items():
        curve.assert_on_curve(pt)
        b.assert_is_equal(pt[0], b.public(f"{name}_x"))
        b.assert_is_equal(pt[1], b.public(f"{name}_y"))
    q1, q2 = ed.mul(ed.base(), 5), ed.mul(ed.base(), 77)
    k1, k2 = 0xBEEF, 0x1234
    want = {
        "add": ed.add(q1, q2),
        "double": ed.double(q1),
        "neg": ed.neg(q2),
        "mul": ed.mul(q1, k1),
        "dbl_mul": ed.add(ed.mul(q1, k1), ed.mul(q2, k2)),
    }
    assign = {"x1": q1[0], "y1": q1[1], "x2": q2[0], "y2": q2[1], "s1": k1, "s2": k2}
    for name, pt in want.items():
        assign[f"{name}_x"], assign[f"{name}_y"] = pt
    return b.compile(), assign


def eddsa_circuit(pkg):
    ed = import_module(f"{pkg}.curves.edwards")
    verify_eddsa = import_module(f"{pkg}.gadgets.eddsa").verify_eddsa
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    verify_eddsa(b, (b.secret("rx"), b.secret("ry")), b.secret("s"), b.public("msg"), (b.public("ax"), b.public("ay")))
    kp = ed.eddsa_keygen(b"gadget-test")
    msg = 998877
    R, S = ed.eddsa_sign(kp, msg)
    return b.compile(), {"rx": R[0], "ry": R[1], "s": S, "msg": msg, "ax": kp.pk[0], "ay": kp.pk[1]}


def uints_circuit(pkg):
    u = import_module(f"{pkg}.gadgets.uints")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    a, c = 0xDEADBEEF, 0x12345678
    wa, wc = u.from_var(b, b.secret("a")), u.value_of(b, b.secret("c"))
    k = u.value_of(b, 0x0F0F0F0F)
    results = {
        "xor": (u.xor(b, wa, wc), a ^ c),
        "and": (u.and_(b, wa, wc), a & c),
        "or": (u.or_(b, wa, k), a | 0x0F0F0F0F),
        "not": (u.not_(b, wa), a ^ 0xFFFFFFFF),
        "rotr": (u.rotr(wa, 7), ((a >> 7) | (a << 25)) & 0xFFFFFFFF),
        "rotl": (u.rotl(wa, 13), ((a << 13) | (a >> 19)) & 0xFFFFFFFF),
        "shr": (u.shr(wa, 9), a >> 9),
        "shl": (u.shl(wa, 9), (a << 9) & 0xFFFFFFFF),
        "add": (u.add(b, wa, wc, wc, k), (a + 2 * c + 0x0F0F0F0F) & 0xFFFFFFFF),
    }
    assign = {"a": a, "c": c}
    for name, (word, value) in results.items():
        b.assert_is_equal(u.to_var(b, word), b.public(name))
        assign[name] = value
    u.assert_equal(b, u.add(b, wa), wa)
    for i, byte in enumerate(u.to_bytes_be(b, wa)):
        b.assert_is_equal(byte, b.public(f"byte{i}"))
        assign[f"byte{i}"] = a.to_bytes(4, "big")[i]
    return b.compile(), assign


def sha256_circuit(pkg, n_bytes):
    sha2 = import_module(f"{pkg}.gadgets.sha2")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    rng = random.Random(1000 + n_bytes)
    msg = bytes(rng.randrange(256) for _ in range(n_bytes))
    ins = [b.secret(f"m{i}") for i in range(n_bytes)]
    for v in ins:
        b.to_binary(v, 8)  # the inputs are bytes
    digest = sha2.sha256_of_bytes(b, ins)
    for i, d in enumerate(digest):
        b.assert_is_equal(d, b.public(f"d{i}"))
    assign = {f"m{i}": c for i, c in enumerate(msg)}
    assign.update({f"d{i}": c for i, c in enumerate(hashlib.sha256(msg).digest())})
    return b.compile(), assign


GADGETS = {
    "mimc": mimc_circuit,
    "merkle": merkle_circuit,
    "edwards": edwards_circuit,
    "eddsa": eddsa_circuit,
    "uints": uints_circuit,
    "sha256_0": lambda pkg: sha256_circuit(pkg, 0),
    "sha256_3": lambda pkg: sha256_circuit(pkg, 3),
    "sha256_64": lambda pkg: sha256_circuit(pkg, 64),
}


def level_solve(cs, assign, overrides=None, spec=BN254_FR):
    """The port's level solver on CPU tensors over `spec`, decoded."""
    f = get_field(spec)
    return f.decode(LevelSolver(cs, f, "cpu").solve(assign, hint_overrides=overrides))


@pytest.mark.parametrize("gadget", GADGETS)
def test_gadget_systems_and_witnesses_equal_tpusnark(gadget):
    ours, assign = GADGETS[gadget]("tpusnark_torch")
    theirs, jassign = GADGETS[gadget]("tpusnark")
    assert assign == jassign
    assert cs_image(ours) == cs_image(theirs)
    want = jsolver.solve(theirs, assign)
    assert tsolver.solve(ours, assign) == want
    assert level_solve(ours, assign) == want
    if gadget.startswith("sha256"):
        # the public digest is hashlib's: a wrong byte is refused
        bad = dict(assign, d0=(assign["d0"] + 1) % 256)
        for solve, cs in ((tsolver.solve, ours), (jsolver.solve, theirs)):
            with pytest.raises(Exception, match="constraint"):
                solve(cs, bad)
