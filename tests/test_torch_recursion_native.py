"""The port's native 2-chain (tpusnark_torch's copies of tpusnark's
native_tower, sw_native and recursion_native) against the originals: each
copy is tpusnark's code; the BLS12-377 tower over BW6-761's r (products,
inverses, Frobenius maps, final_exp_3h) and the Miller loop on the port's
TestEngine equal tpusnark's engine and the host module ``curves/bls12377.py``;
the in-circuit Groth16 verifier on both engines accepts a proof simulated
with a known trapdoor and refuses it with the public input + 1, with Ar off
the curve and with another proof's Ar; chip_smoke's outer circuit with one
verifier and the proof points secret (46,451 constraints) builds the same
constraint system with either package, constraint for constraint, whose
witness from the port's host solver equals tpusnark's, wire for wire; and a
circuit of the verifier's parts (tower, G1 and G2 ops) does too, its witness
from the port's level solver (``LevelSolver(device="cpu")``, the plain
versions over the 12-word fr) tpusnark's. The level solver over the whole
outer circuit is in the slow tier. Exact."""

import random
from importlib import import_module

import pytest
import torch

import chip_smoke
import tpusnark.constraint.solver as jsolver
import tpusnark_torch.constraint.solver as tsolver
from tests.test_torch_gadgets import both, level_solve
from tests.test_torch_host import code_without_docstrings, cs_image
from tpusnark_torch.curves import bls12377 as host
from tpusnark_torch.fields.spec import BW6_761_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = host.P
PACKAGES = ("tpusnark_torch", "tpusnark")
COPIES = ("gadgets.native_tower", "gadgets.sw_native", "gadgets.recursion_native")
Y = 35  # the inner proofs' public input


@pytest.mark.parametrize("name", COPIES)
def test_recursion_modules_are_tpusnark_code(name):
    ours, theirs = both(name)
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def test_outer_field_is_the_inner_base_field():
    assert BW6_761_FR.modulus == P == import_module("tpusnark.curves.bls12377").P


# ---- the tower and the Miller loop on each package's TestEngine ------------
def engine(pkg, assignment=None):
    return import_module(f"{pkg}.testing.engine").TestEngine(P, assignment or {})


def rand_fp12(rng, h):
    def f2():
        return h.Fp2(rng.randrange(P), rng.randrange(P))

    return h.Fp12(h.Fp6(f2(), f2(), f2()), h.Fp6(f2(), f2(), f2()))


def ints(v):
    """A gadget value (nested tuples of engine ints) as nested tuples."""
    return tuple(ints(x) for x in v) if isinstance(v, tuple) else int(v)


def host_ints(x):
    """A host Fp2/Fp6/Fp12 element in the gadget's layout."""
    if hasattr(x, "c2"):
        return (host_ints(x.c0), host_ints(x.c1), host_ints(x.c2))
    if hasattr(x, "c1") and not isinstance(x.c0, int):
        return (host_ints(x.c0), host_ints(x.c1))
    return (x.c0 % P, x.c1 % P)


def tower_op(pkg, op, seed):
    """(op on pkg's engine, the host module's value), in the gadget's layout."""
    h = import_module(f"{pkg}.curves.bls12377")
    tower = import_module(f"{pkg}.gadgets.native_tower")
    eng = engine(pkg)
    f12 = tower.NFp12(eng)
    rng = random.Random(seed)
    a, b = rand_fp12(rng, h), rand_fp12(rng, h)
    av, bv = f12.const(a), f12.const(b)
    if op == "fp2_inv":
        x = h.Fp2(rng.randrange(P), rng.randrange(P))
        return tower.NFp2(eng).inv(f12.f2.const(x)), x.inv()
    if op == "miller":
        verifier = import_module(f"{pkg}.gadgets.recursion_native").NativeGroth16Verifier(eng)
        p1 = h.G1.mul(h.G1.generator(), rng.randrange(1, h.R))
        q1 = h.G2.mul(h.G2.generator(), rng.randrange(1, h.R))
        return verifier.miller((p1[0], p1[1]), verifier.g2.constant(q1)), h.miller_loop(p1, q1)
    got, want = {
        "mul": (lambda: f12.mul(av, bv), lambda: a * b),
        "square": (lambda: f12.square(av), lambda: a.square()),
        "inv": (lambda: f12.inv(av), lambda: a.inv()),
        "conj": (lambda: f12.conj(av), lambda: a.conj()),
        "frobenius": (lambda: f12.frobenius(av, 1), lambda: a.pow(P)),
        "frobenius2": (lambda: f12.frobenius(av, 2), lambda: a.pow(P * P)),
        "final_exp_3h": (lambda: f12.final_exp_3h(av), lambda: h.final_exp(a).pow(3)),
    }[op]
    return got(), want()


TOWER_OPS = ("fp2_inv", "mul", "square", "inv", "conj", "frobenius", "frobenius2", "final_exp_3h", "miller")


@pytest.mark.parametrize("op", TOWER_OPS)
def test_tower_and_miller_on_the_engine_equal_tpusnark_and_the_host(op):
    seed = 11 + TOWER_OPS.index(op)
    (ours, want), (theirs, jwant) = (tower_op(pkg, op, seed) for pkg in PACKAGES)
    assert ints(ours) == ints(theirs) == host_ints(want) == host_ints(jwant)


def test_final_exp_3h_identity():
    """The decomposition behind final_exp_3h: 3h = (x-1)^2 (x+p) (x^2+p^2-1) + 3."""
    x = host.X_SEED
    assert (P**4 - P**2 + 1) % host.R == 0
    assert (x - 1) ** 2 * (x + P) * (x**2 + P**2 - 1) + 3 == 3 * ((P**4 - P**2 + 1) // host.R)


# ---- the in-circuit verifier ------------------------------------------------
def simulated(pkg, seed, n_proofs=2):
    """pkg's BLS12-377 verifying key with one public input, and n_proofs
    proofs of y = Y made with the trapdoor: Ar = a G1, Bs = b G2, Krs =
    ((ab - alpha beta - (k0 + Y k1) gamma) / delta) G1."""
    h = import_module(f"{pkg}.curves.bls12377")
    keys = import_module(f"{pkg}.backend.groth16.keys")
    rng = random.Random(seed)
    r, g1, g2 = h.R, h.G1.generator(), h.G2.generator()
    alpha, beta, gamma, delta, k0, k1 = (rng.randrange(1, r) for _ in range(6))
    vk = keys.VerifyingKey(
        alpha_g1=h.G1.mul(g1, alpha),
        beta_g2=h.G2.mul(g2, beta),
        gamma_g2=h.G2.mul(g2, gamma),
        delta_g2=h.G2.mul(g2, delta),
        k=[h.G1.mul(g1, k0), h.G1.mul(g1, k1)],
    )
    proofs = []
    for _ in range(n_proofs):
        a, b = rng.randrange(1, r), rng.randrange(1, r)
        c = (a * b - alpha * beta - (k0 + Y * k1) * gamma) * pow(delta, -1, r) % r
        proofs.append(keys.Proof(ar=h.G1.mul(g1, a), krs=h.G1.mul(g1, c), bs=h.G2.mul(g2, b)))
    return vk, proofs


def test_simulated_proofs_pass_the_host_verifier():
    from tpusnark_torch.backend.groth16.verify import verify

    vk, proofs = simulated("tpusnark_torch", 41)
    assert verify(proofs[0], vk, [Y], curve="bls12-377")


VERIFIER_CASES = ("valid", "y + 1", "Ar.y + 1", "Ar of another proof")


def verify_on_engine(pkg, case):
    """None if pkg's in-circuit verifier passes on its engine, else the name
    of what it raised."""
    gadget = import_module(f"{pkg}.gadgets.recursion_native")
    vk, (pf, other) = simulated(pkg, 41)
    ar, y = (pf.ar[0], pf.ar[1]), Y
    if case == "y + 1":
        y += 1
    elif case == "Ar.y + 1":
        ar = (ar[0], (ar[1] + 1) % P)
    elif case == "Ar of another proof":
        ar = (other.ar[0], other.ar[1])
    bs = ((pf.bs[0].c0, pf.bs[0].c1), (pf.bs[1].c0, pf.bs[1].c1))
    try:
        gadget.NativeGroth16Verifier(engine(pkg)).assert_proof(
            gadget.NativeVkConst.from_vk(vk), ar, bs, (pf.krs[0], pf.krs[1]), [y]
        )
    except Exception as e:
        return type(e).__name__
    return None


@pytest.mark.parametrize("case", VERIFIER_CASES)
def test_assert_proof_on_the_engine_equals_tpusnark(case):
    ours, theirs = (verify_on_engine(pkg, case) for pkg in PACKAGES)
    assert ours == theirs == (None if case == "valid" else "CircuitNotSatisfiedError")


# ---- the outer circuit: one verifier, the proof points secret --------------
@pytest.fixture(scope="module")
def outer():
    """{pkg: (cs, assignment)} of chip_smoke's outer circuit with one
    verifier, built from each package's builder and gadget."""
    out = {}
    for pkg in PACKAGES:
        vk, proofs = simulated(pkg, 41, 1)
        cs = chip_smoke.recursion_circuit(
            vk,
            1,
            builder=import_module(f"{pkg}.frontend.builder").Builder,
            gadget=import_module(f"{pkg}.gadgets.recursion_native"),
        )
        out[pkg] = cs, chip_smoke.recursion_assignment(proofs, [Y])
    return out


def test_outer_circuit_and_witness_equal_tpusnark(outer):
    (ours, assign), (theirs, jassign) = outer["tpusnark_torch"], outer["tpusnark"]
    assert assign == jassign
    assert len(ours.constraints) == 46451 and ours.n_wires == 45431
    assert cs_image(ours) == cs_image(theirs)
    assert tsolver.solve(ours, assign) == jsolver.solve(theirs, assign)
    for bad in (dict(assign, y0=Y + 1), dict(assign, ar_y0=(assign["ar_y0"] + 1) % P)):
        with pytest.raises(tsolver.UnsatisfiedConstraintError):
            tsolver.solve(ours, bad)
        with pytest.raises(jsolver.UnsatisfiedConstraintError):
            jsolver.solve(theirs, bad)


@pytest.mark.slow  # 2,772 levels at ~30 ms a level of plain 12-word products: ~85 s
def test_outer_witness_from_the_level_solver(outer):
    cs, assign = outer["tpusnark_torch"]
    assert level_solve(cs, assign, spec=BW6_761_FR) == tsolver.solve(cs, assign)


def as_secrets(b, tag, value, assign):
    """Nested tuples of ints -> the same nesting of secret inputs tag0,
    tag1, ..., their values put in `assign`."""
    if isinstance(value, tuple):
        return tuple(as_secrets(b, tag, v, assign) for v in value)
    name = f"{tag}{sum(k.startswith(tag) for k in assign)}"
    assign[name] = value
    return b.secret(name)


def parts_circuit(pkg):
    """The verifier's parts over secret inputs, each equal to the host
    module's value: an Fp12 product, inverse and Frobenius map, a unified
    G1 add of two points on the curve, and a G2 doubling and add with their
    hinted Fp2 inverses."""
    h = import_module(f"{pkg}.curves.bls12377")
    tower = import_module(f"{pkg}.gadgets.native_tower")
    sw = import_module(f"{pkg}.gadgets.sw_native")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    rng = random.Random(51)
    assign = {}
    a, c = rand_fp12(rng, h), rand_fp12(rng, h)
    f12 = tower.NFp12(b)
    av, cv = as_secrets(b, "a", host_ints(a), assign), as_secrets(b, "c", host_ints(c), assign)
    f12.assert_eq_const(f12.mul(av, cv), a * c)
    f12.assert_eq_const(f12.inv(av), a.inv())
    f12.assert_eq_const(f12.frobenius(av, 1), a.pow(P))
    g1 = sw.NativeG1(b)
    p1, p2 = (h.G1.mul(h.G1.generator(), rng.randrange(1, h.R)) for _ in range(2))
    v1, v2 = as_secrets(b, "p", (p1[0], p1[1]), assign), as_secrets(b, "q", (p2[0], p2[1]), assign)
    g1.assert_on_curve(v1)
    (x, y), z = g1.add_unified((v1, 0), (v2, 0))
    want = h.G1.add(p1, p2)
    for got, w in ((x, want[0]), (y, want[1]), (z, 0)):
        b.assert_is_equal(got, w)
    g2 = sw.NativeG2(b)
    q1, q2 = (h.G2.mul(h.G2.generator(), rng.randrange(1, h.R)) for _ in range(2))
    w1 = as_secrets(b, "s", (host_ints(q1[0]), host_ints(q1[1])), assign)
    w2 = as_secrets(b, "t", (host_ints(q2[0]), host_ints(q2[1])), assign)
    g2.assert_on_curve(w1)
    for (pt, _), want in ((g2.double(w1), h.G2.add(q1, q1)), (g2.add(w1, w2), h.G2.add(q1, q2))):
        g2.f2.assert_eq(pt[0], g2.f2.const(want[0]))
        g2.f2.assert_eq(pt[1], g2.f2.const(want[1]))
    return b.compile(), assign


def test_verifier_parts_circuit_and_witnesses_equal_tpusnark():
    (ours, assign), (theirs, jassign) = (parts_circuit(pkg) for pkg in PACKAGES)
    assert assign == jassign
    assert cs_image(ours) == cs_image(theirs)
    want = jsolver.solve(theirs, assign)
    assert tsolver.solve(ours, assign) == want
    assert level_solve(ours, assign, spec=BW6_761_FR) == want
    bad = dict(assign, p1=(assign["p1"] + 1) % P)  # the first G1 point off the curve
    with pytest.raises(tsolver.UnsatisfiedConstraintError):
        level_solve(ours, bad, spec=BW6_761_FR)
