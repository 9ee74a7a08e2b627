"""The port's emulated arithmetic (tpusnark_torch's copies of tpusnark's
emulated, sw_emulated, fields_tower, pairing, recursion, kzg_verifier,
recursion_plonk and evmprecompiles) against the originals: each copy is
tpusnark's code; on both packages' TestEngine the emulated field ops mod
BN254's p and secp256k1's r, the emulated curve ops over secp256k1 and BN254
(add_unsafe, double, a 16-bit scalar_mul, add_unified's cases,
scalar_mul_flagged on zero and nonzero scalars), ECDSA, the E2/E6/E12 tower
and its Frobenius maps, the twist Frobenius points, the emulated Groth16
verifier's on-curve checks, the KZG verifier's G1 combination and the
identity and expmod precompiles give tpusnark's values and the host
oracles' (plain Python, the port's ``curves/ref.py``), exactly; one Miller
loop on each package's engine equals the port's ``curves/ref.miller_loop``;
a PLONK proof made by the port on the CPU with the MiMC transcript hashes
passes the port's and tpusnark's host verifiers under those hashes and no
other; and chip_smoke's ECADD batch at 3 calls (a random addition, a
doubling, an annihilation) builds the same constraint system with either
package, constraint for constraint, whose witness from the port's host
solver and from its level solver (``LevelSolver(device="cpu")``) equals
tpusnark's, wire for wire, and each solver refuses each of chip_smoke's
tampered assignments. Inner proofs are simulated with a known trapdoor or
made by the port on the CPU, never by tpusnark's prover.

The slow tier (TPUSNARK_SLOW_TESTS=1) holds the counterparts of tpusnark's
slow tests of these modules, on the port's engine: the final
exponentiation and pairing_check, the emulated Groth16 verifier, the KZG
opening, the PLONK recursion verifier and ecrecover (each millions of
emulated operations, minutes)."""

import dataclasses
import hashlib
import random
from importlib import import_module

import pytest
import torch

import chip_smoke
import tpusnark.constraint.solver as jsolver
import tpusnark_torch.constraint.solver as tsolver
from tests.test_torch_gadgets import both, level_solve
from tests.test_torch_host import code_without_docstrings, cs_image
from tests.test_torch_std import outcome
from tpusnark_torch.curves import ref
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus  # the circuits' native field
FP = ref.P  # BN254's base field, the emulated one
PACKAGES = ("tpusnark_torch", "tpusnark")
COPIES = (
    "gadgets.emulated",
    "gadgets.sw_emulated",
    "gadgets.fields_tower",
    "gadgets.pairing",
    "gadgets.recursion",
    "gadgets.kzg_verifier",
    "gadgets.recursion_plonk",
    "gadgets.evmprecompiles",
)
SECP = import_module("tpusnark_torch.gadgets.sw_emulated").SECP256K1
CURVES = {"secp256k1": SECP, "bn254": import_module("tpusnark_torch.gadgets.recursion").BN254_G1}


@pytest.mark.parametrize("name", COPIES)
def test_emulated_modules_are_tpusnark_code(name):
    ours, theirs = both(name)
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def engine(pkg, assignment=None):
    return import_module(f"{pkg}.testing.engine").TestEngine(P, assignment or {})


# ---- the emulated field ------------------------------------------------------
MODULI = {"bn254_fp": FP, "secp256k1_r": SECP.order}


def field_values(pkg, r, seed):
    """Each op's value on pkg's engine, as ints."""
    em = import_module(f"{pkg}.gadgets.emulated")
    prm = em.EmuParams.for_modulus(r)
    F = em.EmulatedField(engine(pkg), prm)
    rng = random.Random(seed)
    out = []
    for _ in range(4):
        av, bv = rng.randrange(r), rng.randrange(1, r)
        a, b = F.from_limbs(prm.decompose(av)), F.from_limbs(prm.decompose(bv))
        out.append(
            [
                F.to_value(F.reduce(F.add(a, b))),
                F.to_value(F.reduce(F.sub(a, b))),
                F.to_value(F.reduce(F.neg(a))),
                F.to_value(F.mul(a, b)),
                F.to_value(F.square(a)),
                F.to_value(F.inverse(b)),
                F.to_value(F.div(a, b)),
                F.to_value(F.div_unchecked(a, b)),
                F.to_value(F.select(1, a, b)),
                F.to_value(F.select(0, a, b)),
                int(F.is_zero(F.sub(a, F.constant(av)))),
                int(F.is_zero(F.sub(a, F.constant(av + 1)))),
            ]
        )
        F.assert_is_equal(F.mul(a, b), F.constant(av * bv % r))
    # a long unreduced chain: overflow tracking and the automatic reduce
    acc = F.constant(1)
    for i in range(40):
        e = F.constant(rng.randrange(r))
        acc = F.add(acc, e) if i % 3 else F.mul(acc, e)
    out.append(F.to_value(F.reduce(acc)))
    return out


def field_oracle(r, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(4):
        av, bv = rng.randrange(r), rng.randrange(1, r)
        inv = pow(bv, r - 2, r)
        out.append([(av + bv) % r, (av - bv) % r, -av % r, av * bv % r, av * av % r, inv, av * inv % r, av * inv % r, av, bv, 1, 0])
    acc = 1
    for i in range(40):
        v = rng.randrange(r)
        acc = (acc + v) % r if i % 3 else acc * v % r
    out.append(acc)
    return out


@pytest.mark.parametrize("modulus", MODULI)
def test_emulated_field_on_the_engine_equals_tpusnark_and_python(modulus):
    r, seed = MODULI[modulus], 11 + len(modulus)
    assert field_values("tpusnark_torch", r, seed) == field_values("tpusnark", r, seed) == field_oracle(r, seed)


def test_emulated_field_refuses_unequal_values_and_zero_inverse():
    for pkg in PACKAGES:
        em = import_module(f"{pkg}.gadgets.emulated")
        prm = em.EmuParams.for_modulus(FP)
        F = em.EmulatedField(engine(pkg), prm)
        a = F.from_limbs(prm.decompose(5))
        assert outcome(lambda: F.assert_is_equal(a, F.constant(6))) == "refused: AssertionError"
        assert outcome(lambda: F.inverse(F.constant(0))).startswith("refused")
        # a value of r itself is no canonical zero: is_zero refuses it
        r_limbs = [(FP >> (64 * i)) & (2**64 - 1) for i in range(4)]
        assert outcome(lambda: F.is_zero(em.EmuElement(r_limbs, 0))) == "refused: AssertionError"


# ---- the emulated curve -------------------------------------------------------
def affine_add(c, p1, p2):
    """Plain Python affine addition on the curve `c` (a CurveSpec); None is
    the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2), p = p1, p2, c.p
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def affine_mul(c, k, pt):
    acc = None
    while k:
        if k & 1:
            acc = affine_add(c, acc, pt)
        pt = affine_add(c, pt, pt)
        k >>= 1
    return acc


CURVE_OPS = ("add_unsafe", "double", "scalar_mul", "add_unified", "scalar_mul_flagged")


def curve_values(pkg, curve, op, seed):
    """(op's points on pkg's engine as (x, y, flag) ints, the plain Python
    values); the identity is (0, 0, 1) in both."""
    sw = import_module(f"{pkg}.gadgets.sw_emulated")
    spec = sw.CurveSpec(**dataclasses.asdict(CURVES[curve]))
    eng = engine(pkg)
    cv = sw.EmulatedCurve(eng, spec)
    F = cv.F
    rng = random.Random(seed)
    gen = (spec.gx, spec.gy)
    a = affine_mul(spec, rng.randrange(2, spec.order), gen)
    b = affine_mul(spec, rng.randrange(2, spec.order), gen)
    pa, pb = cv.constant_point(*a), cv.constant_point(*b)

    def pt(e, flag=0):
        return (F.to_value(F.reduce(e.x)), F.to_value(F.reduce(e.y)), int(eng.constant_value(flag)))

    def want(q):
        return (0, 0, 1) if q is None else (*q, 0)

    if op == "add_unsafe":
        cv.assert_on_curve(pa)
        return [pt(cv.add_unsafe(pa, pb))], [want(affine_add(spec, a, b))]
    if op == "double":
        return [pt(cv.double(pa))], [want(affine_add(spec, a, a))]
    k = rng.randrange(2, 1 << 16)
    bits = [(k >> i) & 1 for i in range(16)]
    if op == "scalar_mul":
        return [pt(cv.scalar_mul(cv.generator(), bits))], [want(affine_mul(spec, k, gen))]
    if op == "scalar_mul_flagged":
        got = [pt(*cv.scalar_mul_flagged(pa, bits)), pt(*cv.scalar_mul_flagged(pa, [0] * 16))]
        return got, [want(affine_mul(spec, k, a)), want(None)]
    z = cv.zero_point()
    cases = ((pa, pb, 0, 0), (pa, pa, 0, 0), (pa, cv.neg(pa), 0, 0), (pa, z, 0, 1), (z, pb, 1, 0), (z, z, 1, 1))
    plain = (affine_add(spec, a, b), affine_add(spec, a, a), None, a, b, None)
    return [pt(*cv.add_unified(*c)) for c in cases], [want(q) for q in plain]


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("op", CURVE_OPS)
def test_emulated_curve_on_the_engine_equals_tpusnark_and_python(op, curve):
    seed = 21 + CURVE_OPS.index(op)
    (ours, want), (theirs, jwant) = (curve_values(pkg, curve, op, seed) for pkg in PACKAGES)
    assert ours == theirs == want == jwant


def ecdsa_signature(seed, msg):
    """(pub, h, r, s) of a from-scratch ECDSA signature over secp256k1."""
    rng = random.Random(seed)
    gen = (SECP.gx, SECP.gy)
    priv = rng.randrange(1, SECP.order)
    h = int.from_bytes(hashlib.sha256(msg).digest(), "big") % SECP.order
    while True:
        k = rng.randrange(1, SECP.order)
        r = affine_mul(SECP, k, gen)[0] % SECP.order
        s = pow(k, -1, SECP.order) * (h + r * priv) % SECP.order
        if r and s:
            return affine_mul(SECP, priv, gen), h, r, s


def test_ecdsa_on_the_engine_accepts_and_rejects_as_tpusnark():
    pub, h, r, s = ecdsa_signature(31, b"tpu-native ecdsa")
    got = {}
    for pkg in PACKAGES:
        sw = import_module(f"{pkg}.gadgets.sw_emulated")
        prm = import_module(f"{pkg}.gadgets.emulated").EmuParams.for_modulus(SECP.order)

        def check(r_):
            cv = sw.EmulatedCurve(engine(pkg), sw.SECP256K1)
            return sw.ecdsa_verify_sig(cv.api, cv, cv.constant_point(*pub), prm.decompose(h), prm.decompose(r_), prm.decompose(s))

        got[pkg] = (outcome(lambda: check(r)), outcome(lambda: check((r + 1) % SECP.order)))
    assert got["tpusnark_torch"] == got["tpusnark"] == (True, "refused: AssertionError")


# ---- the tower, the twist and the Miller loop ----------------------------------
def flat(x):
    """A host Fp2/Fp6/Fp12 element (either package's) as nested int tuples."""
    if hasattr(x, "c2"):
        return (flat(x.c0), flat(x.c1), flat(x.c2))
    if not isinstance(x.c0, int):
        return (flat(x.c0), flat(x.c1))
    return (x.c0 % FP, x.c1 % FP)


def rand_ints(rng, depth):
    """Nested int tuples of an Fp2 (depth 1), Fp6 (2) or Fp12 (3)."""
    if depth == 1:
        return (rng.randrange(FP), rng.randrange(FP))
    return tuple(rand_ints(rng, depth - 1) for _ in range(3 if depth == 2 else 2))


def host_elem(h, v, depth):
    if depth == 1:
        return h.Fp2(*v)
    cls = h.Fp6 if depth == 2 else h.Fp12
    return cls(*(host_elem(h, c, depth - 1) for c in v))


TOWER_OPS = (
    "e2_mul", "e2_square", "e2_add", "e2_sub", "e2_mul_xi", "e2_inv",
    "e6_mul", "e6_inv",
    "e12_mul", "e12_square", "e12_conj", "e12_inv", "e12_frobenius", "e12_frobenius_square",
)


def tower_op(pkg, op, seed):
    """(op on pkg's engine, the host module's value), as nested int tuples."""
    h = import_module(f"{pkg}.curves.ref")
    t = import_module(f"{pkg}.gadgets.fields_tower").Fp12Tower(engine(pkg))
    depth = {"e2": 1, "e6": 2, "e12": 3}[op.split("_")[0]]
    rng = random.Random(seed)
    a, b = (host_elem(h, rand_ints(rng, depth), depth) for _ in range(2))
    if depth == 1:
        ea, eb = t.e2_from_host(a), t.e2_from_host(b)
        fn = getattr(t, op)
        got = fn(ea, eb) if op in ("e2_mul", "e2_add", "e2_sub") else fn(ea)
        want = {"e2_mul": a * b, "e2_square": a.square(), "e2_add": a + b, "e2_sub": a - b, "e2_mul_xi": a.mul_xi(), "e2_inv": a.inv()}[op]
        if op == "e2_inv":
            t.e2_assert_eq(t.e2_mul(ea, got), t.e2(1, 0))
        return flat(t.e2_value(got)), flat(want)
    if depth == 2:
        ea, eb = (t.e6(*(t.e2_from_host(c) for c in (x.c0, x.c1, x.c2))) for x in (a, b))
        got = t.e6_mul(ea, eb) if op == "e6_mul" else t.e6_inv(ea)
        want = a * b if op == "e6_mul" else a.inv()
        return tuple(flat(t.e2_value(c)) for c in (got.c0, got.c1, got.c2)), flat(want)
    ea, eb = t.e12_from_host(a), t.e12_from_host(b)
    got = {
        "e12_mul": lambda: t.e12_mul(ea, eb),
        "e12_square": lambda: t.e12_square(ea),
        "e12_conj": lambda: t.e12_conj(ea),
        "e12_inv": lambda: t.e12_inv(ea),
        "e12_frobenius": lambda: t.e12_frobenius(ea),
        "e12_frobenius_square": lambda: t.e12_frobenius_square(ea),
    }[op]()
    want = {
        "e12_mul": lambda: a * b,
        "e12_square": lambda: a.square(),
        "e12_conj": lambda: a.conj(),
        "e12_inv": lambda: a.inv(),
        "e12_frobenius": lambda: a.pow(FP),
        "e12_frobenius_square": lambda: a.pow(FP * FP),
    }[op]()
    if op == "e12_inv":
        t.e12_assert_eq(t.e12_mul(ea, got), t.e12_one())
    return flat(t.e12_value(got)), flat(want)


@pytest.mark.parametrize("op", TOWER_OPS)
def test_tower_on_the_engine_equals_tpusnark_and_the_host(op):
    seed = 41 + TOWER_OPS.index(op)
    (ours, want), (theirs, jwant) = (tower_op(pkg, op, seed) for pkg in PACKAGES)
    assert ours == theirs == want == jwant


def pairing_points(seed):
    rng = random.Random(seed)
    return ref.G1.mul(ref.G1.generator(), rng.randrange(1, ref.R)), ref.G2.mul(ref.G2.generator(), rng.randrange(1, ref.R))


def test_twist_frobenius_points_equal_tpusnark_and_lie_on_the_twist():
    _, q = pairing_points(51)
    got = {}
    for pkg in PACKAGES:
        pg = import_module(f"{pkg}.gadgets.pairing").PairingGadget(engine(pkg))
        Q = pg.g2_point(*q)
        got[pkg] = [(flat(pg.e2_value(R.x)), flat(pg.e2_value(R.y))) for R in (pg._twist_frob(Q), pg._twist_frob2_neg(Q))]
    assert got["tpusnark_torch"] == got["tpusnark"]
    for x, y in got["tpusnark_torch"]:
        assert ref.G2.on_curve((ref.Fp2(*x), ref.Fp2(*y)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_miller_loop_on_the_engine_equals_the_ports_host_miller_loop(pkg, monkeypatch):
    """One Miller loop (~15 s an engine) on each package's engine against
    curves/ref.miller_loop: both equal it, so each other; it makes 19,688
    emulated products."""
    p, q = pairing_points(52)
    field = import_module(f"{pkg}.gadgets.emulated").EmulatedField
    product, products = field._mul_reduced, []
    monkeypatch.setattr(field, "_mul_reduced", lambda self, a, b: products.append(1) or product(self, a, b))
    pg = import_module(f"{pkg}.gadgets.pairing").PairingGadget(engine(pkg))
    assert flat(pg.e12_value(pg.miller_loop(pg.g1_point(*p), pg.g2_point(*q)))) == flat(ref.miller_loop(p, q))
    assert len(products) == 19_688


def emulated_costs(pkg):
    """(constraints of one emulated BN254 Fp product of two range-checked
    inputs, without the inputs' range checks; of one more bit of an
    emulated scalar multiplication) with pkg's builder."""
    Builder = import_module(f"{pkg}.frontend.builder").Builder
    em = import_module(f"{pkg}.gadgets.emulated")
    evm = import_module(f"{pkg}.gadgets.evmprecompiles")

    def size(build):
        b = Builder(P)
        build(b)
        return len(b.compile().constraints)

    def product(b, mul=True):
        F = em.EmulatedField(b, em.EmuParams.for_modulus(FP))
        x, y = (F.from_limbs([b.secret(f"{v}{i}") for i in range(4)]) for v in "xy")
        if mul:
            F.mul(x, y)

    def scalar_mul(bits):
        def build(b):
            C = evm.bn_g1(b)
            pt = C.from_limbs(*([b.secret(f"{v}{i}") for i in range(4)] for v in "xy"))
            evm.ecmul(b, C, pt, [b.secret(f"s{i}") for i in range(bits)])

        return size(build)

    return size(product) - size(lambda b: product(b, False)), scalar_mul(3) - scalar_mul(2)


def test_emulated_product_and_scalar_bit_costs_equal_tpusnark():
    """What keeps the pairing gadgets, ECMUL and ECDSA off the card: every
    64-bit limb and signed carry is range-checked one bit at a time."""
    assert emulated_costs("tpusnark_torch") == emulated_costs("tpusnark") == (1_333, 22_956)


# ---- the verifiers' host-side parts ------------------------------------------
Y = 35  # the inner statements' public input


def simulated(pkg, seed):
    """pkg's BN254 verifying key with one public input and a proof of y = Y
    made with the trapdoor: Ar = a G1, Bs = b G2, Krs = ((ab - alpha beta -
    (k0 + Y k1) gamma) / delta) G1."""
    h = import_module(f"{pkg}.curves.ref")
    keys = import_module(f"{pkg}.backend.groth16.keys")
    rng = random.Random(seed)
    r, g1, g2 = h.R, h.G1.generator(), h.G2.generator()
    alpha, beta, gamma, delta, k0, k1, a, b = (rng.randrange(1, r) for _ in range(8))
    vk = keys.VerifyingKey(
        alpha_g1=h.G1.mul(g1, alpha),
        beta_g2=h.G2.mul(g2, beta),
        gamma_g2=h.G2.mul(g2, gamma),
        delta_g2=h.G2.mul(g2, delta),
        k=[h.G1.mul(g1, k0), h.G1.mul(g1, k1)],
    )
    c = (a * b - alpha * beta - (k0 + Y * k1) * gamma) * pow(delta, -1, r) % r
    return vk, keys.Proof(ar=h.G1.mul(g1, a), krs=h.G1.mul(g1, c), bs=h.G2.mul(g2, b))


def test_simulated_proof_passes_the_host_verifier():
    from tpusnark_torch.backend.groth16.verify import verify

    vk, proof = simulated("tpusnark_torch", 61)
    assert verify(proof, vk, [Y], curve="bn254")
    assert not verify(proof, vk, [Y + 1], curve="bn254")


def on_curve_checks(pkg, tamper):
    """The emulated verifier's curve-membership constraints of Ar and Krs
    (tests/test_recursion.py's fast tier) on pkg's engine."""
    vk, proof = simulated(pkg, 61)
    v = import_module(f"{pkg}.gadgets.recursion").Groth16Verifier(engine(pkg))
    ar = (proof.ar[0], proof.ar[1] + tamper)
    pv = v.proof_from_values(ar, proof.bs, proof.krs)
    F = v.pg.F

    def check():
        for pt in (pv.ar, pv.krs):
            F.assert_is_equal(F.mul(pt.y, pt.y), F.add(F.mul(F.mul(pt.x, pt.x), pt.x), F.constant(3)))
        return [F.to_value(c) for c in (pv.ar.x, pv.ar.y, pv.krs.x, pv.krs.y)]

    return outcome(check)


def test_verifier_on_curve_checks_equal_tpusnark():
    for tamper in (0, 1):
        ours, theirs = (on_curve_checks(pkg, tamper) for pkg in PACKAGES)
        assert ours == theirs
    assert on_curve_checks("tpusnark_torch", 1) == "refused: AssertionError"


def kzg_opening(seed, n=8):
    """(SRS's G2 pair, C, z, y, proof) of a KZG opening of a random
    polynomial of n coefficients, made with the trapdoor tau: C = f(tau) G1,
    proof = ((f(tau) - y) / (tau - z)) G1."""
    rng = random.Random(seed)
    tau, z = rng.randrange(2, ref.R), rng.randrange(2, ref.R)
    coeffs = [rng.randrange(ref.R) for _ in range(n)]

    def f(x):
        return sum(c * pow(x, i, ref.R) for i, c in enumerate(coeffs)) % ref.R

    y = f(z)
    g1, g2 = ref.G1.generator(), ref.G2.generator()
    q = (f(tau) - y) * pow(tau - z, -1, ref.R) % ref.R
    return (g2, ref.G2.mul(g2, tau)), ref.G1.mul(g1, f(tau)), z, y, ref.G1.mul(g1, q)


def kzg_combination(pkg, opening):
    """The KZG verifier's in-circuit G1 side, C - y G + z H, on pkg's
    engine (tests/test_kzg_verifier.py's fast tier)."""
    _, C, z, y, proof = opening
    api = engine(pkg, {"z": z, "y": y})
    v = import_module(f"{pkg}.gadgets.kzg_verifier").KZGVerifier(api)
    curve, F = v.curve, v.pg.F
    nbits = P.bit_length()
    yG = curve.scalar_mul(curve.generator(), api.to_binary(api.public("y"), nbits))
    zH = curve.scalar_mul(curve.constant_point(*proof), api.to_binary(api.public("z"), nbits))
    lhs = curve.add_unsafe(curve.add_unsafe(curve.constant_point(*C), curve.neg(yG)), zH)
    return F.to_value(lhs.x), F.to_value(lhs.y)


def test_kzg_g1_combination_equals_tpusnark_and_the_host():
    opening = kzg_opening(71)
    _, C, z, y, proof = opening
    want = ref.G1.add(ref.G1.add(C, ref.G1.neg(ref.G1.mul(ref.G1.generator(), y))), ref.G1.mul(proof, z))
    assert kzg_combination("tpusnark_torch", opening) == kzg_combination("tpusnark", opening) == want


@pytest.fixture(scope="module")
def mimc_plonk():
    """The cubic x^3 + x + 5 == y proved by the port's PLONK on the CPU with
    the MiMC transcript hashes (tests/test_recursion_plonk.py's inner
    proof): (proof, vk)."""
    from tpusnark_torch.backend import plonk
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.frontend.plonk_builder import PlonkBuilder
    from tpusnark_torch.utils.mimc_transcript import MiMCFrHash

    b = PlonkBuilder(P)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    pk, vk = plonk.setup(cs, tau=424242, device="cpu")
    st = random.Random(9)
    cfg = ProverConfig().with_rng(lambda: st.randrange(1, P)).with_challenge_hash(MiMCFrHash).with_kzg_fold_hash(MiMCFrHash)
    return plonk.prove(cs, pk, {"x": 3, "y": Y}, config=cfg), vk


def test_mimc_plonk_proof_passes_the_host_verifiers_under_mimc_only(mimc_plonk):
    proof, vk = mimc_plonk
    for pkg in PACKAGES:
        plonk = import_module(f"{pkg}.backend.plonk")
        config = import_module(f"{pkg}.backend.config")
        mimc = import_module(f"{pkg}.utils.mimc_transcript").MiMCFrHash
        vcfg = config.VerifierConfig().with_challenge_hash(mimc).with_kzg_fold_hash(mimc)
        assert plonk.verify(proof, vk, [Y], config=vcfg), pkg
        assert not plonk.verify(proof, vk, [Y + 1], config=vcfg), pkg
        assert not plonk.verify(proof, vk, [Y]), pkg  # SHA-256 challenges


def test_identity_and_expmod_equal_tpusnark_and_python():
    mod = 0xFFFFFFFB  # prime
    rng = random.Random(81)
    base, exp = rng.randrange(2, mod), rng.randrange(1, 1 << 20)
    got = {}
    for pkg in PACKAGES:
        evm = import_module(f"{pkg}.gadgets.evmprecompiles")
        em = import_module(f"{pkg}.gadgets.emulated")
        eng = engine(pkg)
        prm = em.EmuParams.for_modulus(mod)
        out = evm.expmod(eng, prm.decompose(base), [(exp >> i) & 1 for i in range(20)], mod)
        F = em.EmulatedField(eng, prm)
        got[pkg] = (evm.identity(eng, [1, 2, 3]), F.to_value(F.reduce(out)))
    assert got["tpusnark_torch"] == got["tpusnark"] == ([1, 2, 3], pow(base, exp, mod))


# ---- chip_smoke's ECADD batch at 3 calls ----------------------------------------
ECADD_CALLS = 3  # one random addition, one doubling, one annihilation
ECADD_SEED = 91


@pytest.fixture(scope="module")
def ecadd():
    """(the port's system, tpusnark's, the assignment)."""
    from tpusnark.frontend.builder import Builder as JBuilder
    from tpusnark.gadgets import evmprecompiles as jevm

    ours = chip_smoke.ecadd_circuit(ECADD_CALLS)
    theirs = chip_smoke.ecadd_circuit(ECADD_CALLS, builder=JBuilder, gadget=jevm)
    return ours, theirs, chip_smoke.ecadd_inputs(ECADD_CALLS, ECADD_SEED)[0]


def test_ecadd_inputs_are_eip196s_sums():
    assign, pubs = chip_smoke.ecadd_inputs(4, ECADD_SEED)
    prm = import_module("tpusnark_torch.gadgets.emulated").EmuParams.for_modulus(FP)

    def value(name, call):
        return prm.recompose([assign[f"{name}{call}_{i}"] for i in range(4)])

    for call in range(4):
        p, q = (value("px", call), value("py", call)), (value("qx", call), value("qy", call))
        r = ref.G1.add(p, q)
        assert ref.G1.on_curve(p) and ref.G1.on_curve(q)
        assert (value("rx", call), value("ry", call), assign[f"rz{call}"]) == ((*r, 0) if r else (0, 0, 1))
        assert pubs[9 * call : 9 * call + 9] == [assign[f"{c}{call}_{i}"] for c in ("rx", "ry") for i in range(4)] + [assign[f"rz{call}"]]
    assert value("qx", 1) == value("px", 1) and value("qy", 1) == value("py", 1)  # doubling
    assert assign["rz2"] == 1 and value("qy", 2) == FP - value("py", 2)  # annihilation


def test_ecadd_system_equals_tpusnark(ecadd):
    ours, theirs, _ = ecadd
    assert cs_image(ours) == cs_image(theirs)
    # 26,638 constraints a call (chip_smoke's 32 calls: 852,416, a 2^20 domain)
    assert len(ours.constraints) == 26_638 * ECADD_CALLS
    assert ours.n_public == 1 + 9 * ECADD_CALLS


def test_ecadd_witness_equals_tpusnark_on_both_solvers(ecadd):
    ours, theirs, assign = ecadd
    want = jsolver.solve(theirs, assign)
    assert tsolver.solve(ours, assign) == want
    assert level_solve(ours, assign) == want
    assert chip_smoke._branch(ours) == "device"


TAMPERED = tuple(chip_smoke.ecadd_tampered(chip_smoke.ecadd_inputs(ECADD_CALLS, ECADD_SEED)[0], ECADD_CALLS, 0, P))


@pytest.mark.parametrize("what", TAMPERED)
def test_ecadd_tampered_assignment_refused_by_each_solver(ecadd, what):
    """chip_smoke's tampered assignments (Q off the curve, a wrong claimed
    R.x, flag 0 on the annihilation): the emulated field's hints refuse the
    first two (their quotient has a remainder), the native check the third."""
    ours, theirs, assign = ecadd
    bad = chip_smoke.ecadd_tampered(assign, ECADD_CALLS, 0, P)[what]
    got = {}
    for name, solve in (
        ("port host", lambda: tsolver.solve(ours, bad)),
        ("port level", lambda: level_solve(ours, bad)),
        ("tpusnark host", lambda: jsolver.solve(theirs, bad)),
    ):
        with pytest.raises(Exception) as err:
            solve()
        got[name] = type(err.value).__name__
    want = "UnsatisfiedConstraintError" if what.startswith("flag") else "AssertionError"
    assert set(got.values()) == {want}, got


# ---- the slow tier: the pairing-bearing gadgets and ecrecover --------------------
@pytest.mark.slow
def test_final_exp_and_pairing_check_on_the_engine():
    from tpusnark_torch.gadgets.pairing import PairingGadget

    p, q = pairing_points(52)
    pg = PairingGadget(engine("tpusnark_torch"))
    m = ref.miller_loop(p, q)
    assert flat(pg.e12_value(pg.final_exp(pg.e12_from_host(m)))) == flat(ref.final_exp(m))
    Q = pg.g2_point(*q)
    pg.pairing_check([(pg.g1_point(*p), Q), (pg.g1_point(*ref.G1.neg(p)), Q)])
    with pytest.raises(AssertionError):
        pg.pairing_check([(pg.g1_point(*p), Q), (pg.g1_point(*p), Q)])


@pytest.mark.slow
@pytest.mark.parametrize("y", (Y, Y + 1))
def test_emulated_groth16_verifier_on_the_engine(y):
    from tpusnark_torch.gadgets.recursion import Groth16Verifier

    vk, proof = simulated("tpusnark_torch", 61)
    api = engine("tpusnark_torch", {"y": y})
    v = Groth16Verifier(api)
    check = lambda: v.assert_proof(vk, v.proof_from_values(proof.ar, proof.bs, proof.krs), [api.public("y")])  # noqa: E731
    if y == Y:
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.mark.slow
@pytest.mark.parametrize("dy", (0, 1))
def test_kzg_opening_on_the_engine(dy):
    from tpusnark_torch.gadgets.kzg_verifier import KZGVerifier

    g2s, C, z, y, proof = kzg_opening(71)
    api = engine("tpusnark_torch", {"z": z, "y": (y + dy) % P})
    v = KZGVerifier(api)
    check = lambda: v.assert_opening(g2s, v.g1_var(C), api.public("z"), api.public("y"), v.g1_var(proof))  # noqa: E731
    if not dy:
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.mark.slow
@pytest.mark.parametrize("tampered", (False, True))
def test_plonk_recursion_verifier_on_the_engine(mimc_plonk, tampered):
    from tpusnark_torch.gadgets.recursion_plonk import PlonkRecursionVerifier

    proof, vk = mimc_plonk
    if tampered:
        proof = dataclasses.replace(proof, claimed_values=[(proof.claimed_values[0] + 1) % P] + list(proof.claimed_values[1:]))
    eng = engine("tpusnark_torch", {"y": Y})
    v = PlonkRecursionVerifier(eng, vk)
    check = lambda: v.assert_proof(v.proof_from_host(proof), [eng.public("y")])  # noqa: E731
    if not tampered:
        check()
    else:
        with pytest.raises(Exception):
            check()


@pytest.mark.slow
def test_ecrecover_on_the_engine():
    from tpusnark_torch.gadgets.emulated import EmuParams, EmulatedField
    from tpusnark_torch.gadgets.evmprecompiles import ecrecover

    rng = random.Random(101)
    gen = (SECP.gx, SECP.gy)
    priv = rng.randrange(1, SECP.order)
    h = int.from_bytes(hashlib.sha256(b"evm ecrecover").digest(), "big") % SECP.order
    while True:
        k = rng.randrange(1, SECP.order)
        R = affine_mul(SECP, k, gen)
        r = R[0] % SECP.order
        s = pow(k, -1, SECP.order) * (h + r * priv) % SECP.order
        if r and s and R[0] < SECP.order:
            break
    eng = engine("tpusnark_torch")
    prm = EmuParams.for_modulus(SECP.order)
    Q = ecrecover(eng, prm.decompose(h), R[1] & 1, prm.decompose(r), prm.decompose(s))
    F = EmulatedField(eng, EmuParams.for_modulus(SECP.p))
    assert (F.to_value(F.reduce(Q.x)), F.to_value(F.reduce(Q.y))) == affine_mul(SECP, priv, gen)
