"""The port's host layer (tpusnark_torch's copies of tpusnark's JAX-free
modules) against the originals: every FieldSpec constant, Domain values,
get_curve fields, the host curves' group laws and pairings, the builder and
the solver on a circuit with hints, the setup helpers, the key containers,
and the verifiers' verdicts on one good and one bad proof per curve. Exact.
The copies exist so that the port imports nothing of tpusnark; these tests
catch drift between the two.

The verifier tests need no prover: with the toxic waste known, a valid
Groth16 proof is three scalar multiples of the generators (``toy_proof``)."""

import ast
import dataclasses
import inspect
import random
import textwrap
from importlib import import_module

import numpy as np
import pytest
import torch

import tpusnark.backend.config as jconfig
import tpusnark.backend.groth16.bls381 as jbls381
import tpusnark.backend.groth16.keys as jkeys
import tpusnark.constraint.hints as jhints
import tpusnark.constraint.solver as jsolver
import tpusnark.curves.config as jcurves
import tpusnark.fields.spec as jspec
import tpusnark.frontend.builder as jbuilder
import tpusnark.poly.domain as jdomain
import tpusnark_torch.backend.config as tconfig
import tpusnark_torch.backend.groth16.bls381 as tbls381
import tpusnark_torch.backend.groth16.keys as tkeys
import tpusnark_torch.constraint.hints as thints
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.curves.config as tcurves
import tpusnark_torch.fields.spec as tspec
import tpusnark_torch.frontend.builder as tbuilder
import tpusnark_torch.poly.domain as tdomain
from tpusnark_torch.fields.tfield import get_field

torch.set_num_threads(1)  # the suite's workers fill the cores already

# the groth16 packages export functions named setup and verify, which hide
# the submodules of those names from "import ... as"
jsetup, jverify = (import_module(f"tpusnark.backend.groth16.{n}") for n in ("setup", "verify"))
tsetup, tverify = (import_module(f"tpusnark_torch.backend.groth16.{n}") for n in ("setup", "verify"))

ALL_CURVES = ("bn254", "bls12-381", "bls12-377", "bw6-761", "bls24-315", "bls24-317", "bw6-633")
HOST_CURVES = ALL_CURVES  # every curve has its host module in the port
SPEC_FIELDS = [f.name for f in dataclasses.fields(jspec.FieldSpec)]


def spec_values(spec):
    return {name: getattr(spec, name) for name in SPEC_FIELDS}


def spec_names(mod):
    return sorted(k for k, v in vars(mod).items() if type(v).__name__ == "FieldSpec")


def test_every_field_spec_constant_equals_tpusnark():
    names = spec_names(jspec)
    assert names == spec_names(tspec) and len(names) == 15  # seven curves' fr and fp, and the tiny field
    for name in names:
        ours, theirs = getattr(tspec, name), getattr(jspec, name)
        assert spec_values(ours) == spec_values(theirs), name
        assert np.array_equal(ours.p_limbs, theirs.p_limbs)
        xs = [0, 1, theirs.modulus - 1, 12345 % theirs.modulus]
        assert np.array_equal(ours.encode(xs), theirs.encode(xs))
        assert ours.decode(theirs.encode(xs)) == xs == theirs.decode(ours.encode(xs))
        assert np.array_equal(ours.encode(xs, mont=False), theirs.encode(xs, mont=False))
    assert (tspec.LIMB_BITS, tspec.LIMB_MASK) == (jspec.LIMB_BITS, jspec.LIMB_MASK)
    big = [0, 1, 2**200 + 7, 2**383]
    assert np.array_equal(tspec.ints_to_limbs(big, 24), jspec.ints_to_limbs(big, 24))
    assert tspec.limbs_to_ints(jspec.ints_to_limbs(big, 24)) == big
    assert tspec.limbs_to_int(jspec.int_to_limbs(big[2], 16)) == big[2]


@pytest.mark.parametrize("curve", HOST_CURVES)
def test_domain_values_equal_tpusnark(curve):
    for n in (1, 8, 16):
        ours = tdomain.Domain(tcurves.get_curve(curve).fr_spec, n)
        theirs = jdomain.Domain(jcurves.get_curve(curve).fr_spec, n)
        for name in ("n", "generator", "generator_inv", "n_inv", "coset_shift"):
            assert getattr(ours, name) == getattr(theirs, name), (n, name)
        assert ours.powers == theirs.powers and ours.powers_inv == theirs.powers_inv
        assert ours.coset_powers() == theirs.coset_powers()
        assert ours.coset_powers(inv=True) == theirs.coset_powers(inv=True)
        xs = [(7 * i + 3) % 1009 for i in range(n)]
        assert ours.ntt_ref(xs) == theirs.ntt_ref(xs) and ours.intt_ref(xs) == theirs.intt_ref(xs)
    assert np.array_equal(tdomain.bit_reverse_perm(32), jdomain.bit_reverse_perm(32))


@pytest.mark.parametrize("curve", ALL_CURVES)
def test_get_curve_fields_equal_tpusnark(curve):
    ours, theirs = tcurves.get_curve(curve), jcurves.get_curve(curve)
    names = [f.name for f in dataclasses.fields(theirs)]
    assert names == [f.name for f in dataclasses.fields(ours)]
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name.endswith("_spec"):
            a, b = spec_values(a), spec_values(b)
        assert a == b, name
    # the port's own host module, tpusnark's code under the same name
    assert ours.host.__name__ == theirs.host.__name__.replace("tpusnark.", "tpusnark_torch.")
    assert ours.host is not theirs.host
    assert (ours.host.P, ours.host.R) == (theirs.host.P, theirs.host.R)
    with pytest.raises(ValueError, match="unknown curve"):
        tcurves.get_curve("secp256k1")


def plain(v):
    """A host value (int, Fp2-like, point tuple, None) as nested ints."""
    if v is None or isinstance(v, int):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(plain(x) for x in v)
    if hasattr(v, "c0"):
        return (plain(v.c0), plain(v.c1))
    if hasattr(v, "v"):  # tower.prime_field
        return v.v
    return tuple(plain(x) for x in v.c)  # bw6761.Fp6, tower extensions


@pytest.mark.parametrize("curve", HOST_CURVES)
def test_host_curve_group_laws_equal_tpusnark(curve):
    ours, theirs = tcurves.get_curve(curve).host, jcurves.get_curve(curve).host
    rng = random.Random(5)
    for group in ("G1", "G2"):
        G, J = getattr(ours, group), getattr(theirs, group)
        g, jg = G.generator(), J.generator()
        assert plain(g) == plain(jg)
        k, m = rng.randrange(1, ours.R), rng.randrange(1, ours.R)
        P, JP = G.mul(g, k), J.mul(jg, k)
        Q, JQ = G.mul(g, m), J.mul(jg, m)
        assert plain(P) == plain(JP)
        assert plain(G.add(P, Q)) == plain(J.add(JP, JQ)) == plain(G.mul(g, (k + m) % ours.R))
        assert plain(G.double(P)) == plain(J.double(JP))
        assert plain(G.neg(P)) == plain(J.neg(JP))
        assert G.add(P, G.neg(P)) is None and G.add(None, P) == P and G.mul(g, ours.R) is None
        if curve != "bn254":
            assert G.is_on_curve(P) and G.in_subgroup(P) and J.in_subgroup(JP)
    if curve == "bn254":
        assert ours.G1.on_curve(ours.G1.generator()) and ours.G2.in_subgroup(ours.G2.generator())


@pytest.mark.parametrize("curve", ("bn254", "bls12-381", "bls12-377", "bw6-633"))
def test_host_pairings_equal_tpusnark(curve):
    ours, theirs = tcurves.get_curve(curve).host, jcurves.get_curve(curve).host
    a, b = 5, 7
    P, Q = ours.G1.mul(ours.G1.generator(), a), ours.G2.mul(ours.G2.generator(), b)
    JP, JQ = theirs.G1.mul(theirs.G1.generator(), a), theirs.G2.mul(theirs.G2.generator(), b)
    if curve == "bn254":
        pairs = [(P, Q), (ours.G1.neg(ours.G1.mul(ours.G1.generator(), a * b)), ours.G2.generator())]
        jpairs = [(JP, JQ), (theirs.G1.neg(theirs.G1.mul(theirs.G1.generator(), a * b)), theirs.G2.generator())]
        assert ours.pairing_check(pairs) and theirs.pairing_check(jpairs)
        assert not ours.pairing_check(pairs[:1])
    else:
        e, je = ours.pairing(P, Q), theirs.pairing(JP, JQ)
        assert e == ours.pairing(ours.G1.generator(), ours.G2.generator()).pow(a * b)
        assert not e.is_one() and je == theirs.pairing(theirs.G1.generator(), theirs.G2.generator()).pow(a * b)


def code_of(obj):
    """The code of a module or function without comments and without its
    leading docstring, for holding a copy against its original."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    body = tree.body[0].body if isinstance(tree.body[0], ast.FunctionDef) else tree.body
    if isinstance(body[0], ast.Expr) and isinstance(getattr(body[0], "value", None), ast.Constant):
        del body[0]
    return ast.dump(tree)


def test_bw6761_host_module_is_tpusnark_code():
    """A BW6-761 Miller loop takes a minute of Python integers, so the
    pairing is held against tpusnark's by its pieces (one line function, one
    curve step over Fp6, the final exponentiation) and by its source."""
    ours, theirs = tcurves.get_curve("bw6-761").host, jcurves.get_curve("bw6-761").host
    assert code_of(ours) == code_of(theirs)
    names = ("P", "R", "TRACE", "ZETA")
    assert [getattr(ours, n) for n in names] == [getattr(theirs, n) for n in names]
    p, q = ours.G1.mul(ours.G1.generator(), 11), ours.G2.mul(ours.G2.generator(), 13)
    pxy = (ours.Fp6.from_fp(p[0]), ours.Fp6.from_fp(p[1]))
    jpxy = (theirs.Fp6.from_fp(p[0]), theirs.Fp6.from_fp(p[1]))
    t, jt = ours._untwist(q), theirs._untwist(q)
    assert plain(ours._line(t, t, pxy)) == plain(theirs._line(jt, jt, jpxy))
    assert plain(ours._ec6_add(t, t)) == plain(theirs._ec6_add(jt, jt))
    f = ours.Fp6(tuple(range(3, 9)))
    assert plain(ours.final_exp(f)) == plain(theirs.final_exp(theirs.Fp6(tuple(range(3, 9)))))
    assert ours.final_exp(f).pow(ours.R).is_one()


@pytest.mark.parametrize("name", ("tower", "bls24", "bls24315", "bls24317", "bw6633"))
def test_bls24_and_bw6633_host_modules_are_tpusnark_code(name):
    """The tower, the BLS24 factory and the three curves' modules are
    tpusnark's code; their constants and a G2 scalar multiple agree."""
    ours = import_module(f"tpusnark_torch.curves.{name}")
    theirs = import_module(f"tpusnark.curves.{name}")
    assert code_of(ours) == code_of(theirs)
    if name in ("bls24315", "bls24317", "bw6633"):
        for const in ("P", "R", "G1_GEN", "G2_GEN"):
            assert plain(getattr(ours, const)) == plain(getattr(theirs, const)), const
        k = 0x1234567
        assert plain(ours.G2.mul(ours.G2.generator(), k)) == plain(theirs.G2.mul(theirs.G2.generator(), k))


def circuit(mod, p):
    """A circuit through the builder's arithmetic, boolean and hint paths."""
    b = mod.Builder(p)
    x, z = b.secret("x"), b.secret("z")
    y = b.public("y")
    cube = b.mul(x, x, x)
    inv = b.inverse(b.add(x, 1))
    quot = b.div(cube, z)
    bits = b.to_binary(x, 8)
    b.assert_is_boolean(bits[0])
    sel = b.select(b.is_zero(b.sub(z, 4)), quot, inv)
    acc = b.mul_acc(sel, x, b.from_binary(bits[:4]))
    b.assert_is_less_or_equal(x, 200, nbits=8)
    b.assert_is_equal(b.add(cube, x, 5, b.xor(bits[0], bits[1])), y)
    b.assert_is_different(acc, 0)
    return b.compile()


def cs_image(cs):
    return dict(
        modulus=cs.modulus,
        coeffs=cs.coeffs,
        constraints=[(c.L, c.R, c.O) for c in cs.constraints],
        public=cs.public_names,
        secret=cs.secret_names,
        wires=(cs.n_wires, cs.n_public, cs.n_secret, cs.n_internal),
        hints=[(i[1].inputs, i[1].outputs, i[1].fn.__name__) for i in cs.instructions if i[0] == "hint"],
        order=[(i[0], i[2]) for i in cs.instructions],
    )


@pytest.mark.parametrize("curve", HOST_CURVES)
def test_builder_and_solver_equal_tpusnark(curve):
    p = tcurves.get_curve(curve).host.R
    ours, theirs = circuit(tbuilder, p), circuit(jbuilder, p)
    assert cs_image(ours) == cs_image(theirs)
    assign = {"x": 3, "z": 4, "y": 27 + 3 + 5 + 0}
    W = tsolver.solve(ours, assign)
    assert W == jsolver.solve(theirs, assign) == tsolver.solve(theirs, assign) == jsolver.solve(ours, assign)
    assert tsolver.compute_abc(ours, W) == jsolver.compute_abc(theirs, W)
    with pytest.raises(Exception, match="constraint") as ours_err:
        tsolver.solve(ours, {**assign, "y": 1})
    with pytest.raises(Exception, match="constraint") as their_err:
        jsolver.solve(theirs, {**assign, "y": 1})
    assert type(ours_err.value).__name__ == type(their_err.value).__name__
    assert thints.fnv1a("inv_hint") == jhints.fnv1a("inv_hint")
    assert thints.inv_hint(p, [5]) == jhints.inv_hint(p, [5])


def test_prover_config_resolves_like_tpusnark():
    rng = lambda: 7  # noqa: E731
    for mod in (tconfig, jconfig):
        cfg = mod.resolve(None, rng)
        assert cfg.rng is rng and cfg.solver_logs and cfg.hints == {} and cfg.hint_overrides == {}
        cfg = mod.resolve(mod.ProverConfig().with_rng(lambda: 1).with_hint_overrides({"h": 1}), rng)
        assert cfg.rng is rng and cfg.hint_overrides == {"h": 1}
        assert mod.resolve(mod.ProverConfig().with_rng(rng)).rng is rng
    ours = {f.name for f in dataclasses.fields(tconfig.ProverConfig)}
    assert ours <= {f.name for f in dataclasses.fields(jconfig.ProverConfig)}


def test_key_containers_have_tpusnark_fields():
    for name in ("Proof", "ProvingKey", "VerifyingKey"):
        ours = [(f.name, f.default) for f in dataclasses.fields(getattr(tkeys, name))]
        theirs = [(f.name, f.default) for f in dataclasses.fields(getattr(jkeys, name))]
        assert ours == theirs, name
    assert tkeys.ProvingKey is not jkeys.ProvingKey
    assert not hasattr(tkeys.ProvingKey, "device")  # the device tables are the port's own


@pytest.mark.parametrize("curve", HOST_CURVES)
def test_setup_helpers_equal_tpusnark(curve):
    cfg = tcurves.get_curve(curve)
    p = cfg.host.R
    cs = circuit(tbuilder, p)
    n = tsetup._next_pow2(len(cs.constraints))
    assert n == jsetup._next_pow2(len(cs.constraints)) and tsetup._next_pow2(1) == 1
    omega = tdomain.Domain(cfg.fr_spec, n).generator
    t = random.Random(3).randrange(1, p)
    assert tsetup.lagrange_coeffs_at(t, n, omega, p) == jsetup.lagrange_coeffs_at(t, n, omega, p)
    assert tsetup._qap_eval_at_t(cs, t, n, omega) == jsetup._qap_eval_at_t(circuit(jbuilder, p), t, n, omega)
    assert tsetup.k_pk_wires_for(cs) == jsetup.k_pk_wires_for(cs) == list(range(cs.n_public, cs.n_wires))


def toy_proof(curve, keys_mod, seed=9):
    """(proof, vk, public inputs) of x^3 + x + 5 == y over `curve`, made on
    the host from known toxic waste: every element is a scalar multiple of a
    generator, with the exponents Groth16's prover reaches by MSMs."""
    cfg = tcurves.get_curve(curve)
    host, p = cfg.host, cfg.host.R
    b = tbuilder.Builder(p)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    W = tsolver.solve(cs, {"x": 3, "y": 35})
    rng = random.Random(seed)
    alpha, beta, gamma, delta, t, r, s = (rng.randrange(1, p) for _ in range(7))
    n = tsetup._next_pow2(len(cs.constraints))
    A, B, C = tsetup._qap_eval_at_t(cs, t, n, tdomain.Domain(cfg.fr_spec, n).generator)
    dot = lambda v: sum(w * c for w, c in zip(W, v)) % p  # noqa: E731
    inv = lambda v: pow(v, -1, p)  # noqa: E731
    zt = (pow(t, n, p) - 1) % p
    h = (dot(A) * dot(B) - dot(C)) * inv(zt) % p
    a, bb = (alpha + dot(A) + r * delta) % p, (beta + dot(B) + s * delta) % p
    k = [(beta * A[w] + alpha * B[w] + C[w]) % p for w in range(cs.n_wires)]
    priv = sum(W[w] * k[w] for w in range(cs.n_public, cs.n_wires)) % p
    c = ((priv + h * zt) * inv(delta) + a * s + bb * r - r * s * delta) % p
    g1, g2 = host.G1.generator(), host.G2.generator()
    proof = keys_mod.Proof(ar=host.G1.mul(g1, a), krs=host.G1.mul(g1, c), bs=host.G2.mul(g2, bb))
    vk = keys_mod.VerifyingKey(
        alpha_g1=host.G1.mul(g1, alpha),
        beta_g2=host.G2.mul(g2, beta),
        gamma_g2=host.G2.mul(g2, gamma),
        delta_g2=host.G2.mul(g2, delta),
        k=[host.G1.mul(g1, k[w] * inv(gamma) % p) for w in range(cs.n_public)],
        beta_g1=host.G1.mul(g1, beta),
        delta_g1=host.G1.mul(g1, delta),
    )
    return proof, vk, [35]


def verdicts(curve, proof, vk, pubs):
    """[port's verdict, tpusnark's verdict] per verifier of the curve."""
    out = [(tverify.verify(proof, vk, pubs, curve=curve), jverify.verify(proof, vk, pubs, curve=curve))]
    if curve == "bls12-381":
        for B in (tbls381, jbls381):
            vkb = B.VerifyingKeyBLS(
                alpha_g1=vk.alpha_g1,
                beta_g1=vk.beta_g1,
                beta_g2=vk.beta_g2,
                gamma_g2=vk.gamma_g2,
                delta_g1=vk.delta_g1,
                delta_g2=vk.delta_g2,
                k=vk.k,
            )
            out.append(B.verify(B.ProofBLS(ar=proof.ar, bs=proof.bs, krs=proof.krs), vkb, pubs))
    return out


def check_verifiers(curve):
    proof, vk, pubs = toy_proof(curve, tkeys)
    good = verdicts(curve, proof, vk, pubs)
    assert good[0] == (True, True) and all(good[1:])
    bad = verdicts(curve, proof, vk, [36])
    assert bad[0] == (False, False) and not any(bad[1:])
    for mod in (tverify, jverify):
        with pytest.raises(mod.InvalidProofError, match="wrong number of public inputs"):
            mod.verify(proof, vk, [35, 1], curve=curve)
    off = dataclasses.replace(proof, ar=(proof.ar[0], (proof.ar[1] + 1) % tcurves.get_curve(curve).host.P))
    for mod in (tverify, jverify):
        with pytest.raises(mod.InvalidProofError, match="not on curve"):
            mod.verify(off, vk, pubs, curve=curve)


@pytest.mark.parametrize("curve", ("bn254", "bls12-381", "bls12-377", "bw6-633"))
def test_verifiers_give_tpusnark_verdicts_on_a_good_and_a_bad_proof(curve):
    check_verifiers(curve)


@pytest.mark.slow
def test_verifiers_give_tpusnark_verdicts_on_a_good_and_a_bad_proof_bw6761():
    """Four pairing checks of four BW6-761 Miller loops each: many minutes."""
    check_verifiers("bw6-761")


def test_bw6761_verifier_refuses_malformed_proofs_before_any_pairing():
    """The port's BW6-761 verifier runs tpusnark's curve-generic code (same
    source); its checks ahead of the pairing give tpusnark's errors."""
    assert code_of(tverify._verify_any) == code_of(jverify._verify_any)
    proof, vk, pubs = toy_proof("bw6-761", tkeys)
    host = tcurves.get_curve("bw6-761").host
    assert host.G1.in_subgroup(proof.ar) and host.G2.in_subgroup(proof.bs)
    off = dataclasses.replace(proof, krs=(proof.krs[0], (proof.krs[1] + 1) % host.P))
    for mod in (tverify, jverify):
        with pytest.raises(mod.InvalidProofError, match="not on curve"):
            mod.verify(off, vk, pubs, curve="bw6-761")
        with pytest.raises(mod.InvalidProofError, match="wrong number of public inputs"):
            mod.verify(proof, vk, [], curve="bw6-761")


def test_commitment_sections_are_refused_by_the_port_verifier():
    """A vk with a commitment section and a proof without one: the port's
    verifier gives tpusnark's verdict (the same error)."""
    proof, vk, pubs = toy_proof("bn254", tkeys)
    vk.public_and_commitment_committed = [[1]]
    vk.k = vk.k + [vk.k[0]]
    errors = []
    for mod in (tverify, jverify):
        with pytest.raises(mod.InvalidProofError, match="BSB22") as err:
            mod.verify(proof, vk, pubs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def code_without_docstrings(mod):
    """code_of a module (or a function or class) with every docstring
    dropped: the copies cite the reference's sources under another root."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(mod)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            del body[0]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ("utils.hash_to_field", "curves.pedersen", "curves.marshal"))
def test_bsb22_host_modules_are_tpusnark_code(name):
    """The BSB22 copies (hash-to-field, Pedersen, point encoding) are
    tpusnark's code; their values agree on seeded inputs."""
    ours = import_module(f"tpusnark_torch.{name}")
    theirs = import_module(f"tpusnark.{name}")
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)
    host = tcurves.get_curve("bn254").host
    pts = [host.G1.mul(host.G1.generator(), k) for k in (5, 77, 123456789)] + [None]
    if name == "utils.hash_to_field":
        for msg, count in ((b"", 1), (b"abc" * 40, 3)):
            got = ours.hash_to_field(msg, ours.COMMITMENT_DST, host.R, count)
            assert got == theirs.hash_to_field(msg, theirs.COMMITMENT_DST, host.R, count)
        assert ours.expand_message_xmd(b"m", b"d", 200) == theirs.expand_message_xmd(b"m", b"d", 200)
    elif name == "curves.marshal":
        for pt in pts:
            assert ours.g1_raw(pt) == theirs.g1_raw(pt) and ours.g1_compress(pt) == theirs.g1_compress(pt)
            assert ours.g1_decode(theirs.g1_compress(pt)) == theirs.g1_decode(ours.g1_compress(pt)) == (pt, 32)
        q = host.G2.mul(host.G2.generator(), 99)
        assert ours.g2_compress(q) == theirs.g2_compress(q) and ours.g2_raw(q) == theirs.g2_raw(q)
    else:
        rng_t, rng_j = random.Random(5), random.Random(5)
        pks_t, vk_t = ours.pedersen_setup([pts[:2], pts[2:]], lambda: rng_t.randrange(1, host.R))
        pks_j, vk_j = theirs.pedersen_setup([pts[:2], pts[2:]], lambda: rng_j.randrange(1, host.R))
        assert [(k.basis, k.basis_exp_sigma) for k in pks_t] == [(k.basis, k.basis_exp_sigma) for k in pks_j]
        assert (vk_t.g2, vk_t.g2_sigma_neg) == (vk_j.g2, vk_j.g2_sigma_neg)
        vals = [[3, 4], [5, 6]]
        coms = [ours.pedersen_commit(k, v) for k, v in zip(pks_t, vals)]
        assert coms == [theirs.pedersen_commit(k, v) for k, v in zip(pks_j, vals)]
        pok = ours.pedersen_batch_prove(pks_t, vals, b"seed")
        assert pok == theirs.pedersen_batch_prove(pks_j, vals, b"seed")
        folded = ours.pedersen_fold_commitments(coms, b"seed")
        assert folded == theirs.pedersen_fold_commitments(coms, b"seed")
        assert vk_t.verify(folded, pok) and not vk_t.verify(folded, coms[0])


# ---------------------------------------------------------------- PLONK's host layer
def plonk_circuit(mod, p):
    """A Plonkish circuit through PlonkBuilder's arithmetic, boolean, hint and
    BSB22 paths."""
    b = mod.PlonkBuilder(p)
    x, z = b.secret("x"), b.secret("z")
    y = b.public("y")
    cube = b.mul(x, x, x)
    bits = b.to_binary(x, 8)
    sel = b.select(b.is_zero(b.sub(z, 4)), b.div(cube, z), b.inverse(b.add(x, 1)))
    c = b.commit(x, sel)
    b.assert_is_different(x, c)
    b.assert_is_equal(b.add(cube, x, 5, b.xor(bits[0], bits[1])), y)
    return b.compile()


def scs_image(cs):
    gates = [(g.xa, g.xb, g.xc, g.qL, g.qR, g.qO, g.qM, g.qC) for g in cs.gates]
    return dict(
        modulus=cs.modulus,
        coeffs=cs.coeffs,
        gates=gates,
        public=cs.public_names,
        secret=cs.secret_names,
        wires=(cs.n_wires, cs.n_public, cs.n_secret),
        hints=[(i[1].inputs, i[1].outputs, i[1].fn.__name__) for i in cs.instructions if i[0] == "hint"],
        order=[(i[0], i[2]) for i in cs.instructions if i[0] == "gate"],
        commitments=[(cm.commitment_index, cm.committed) for cm in cs.commitments],
        skip=cs.commitment_skip_rows(),
    )


PLONK_COPIES = (
    "utils.transcript",
    "constraint.scs",
    "frontend.plonk_builder",
    "backend.plonk.verify",
    "backend.plonk.marshal",
    "backend.plonk.solidity",
)


@pytest.mark.parametrize("name", PLONK_COPIES)
def test_plonk_host_modules_are_tpusnark_code(name):
    """The PLONK copies (transcript, sparse constraint system, builder,
    verifier, proof bytes, Solidity export) are tpusnark's code."""
    ours = import_module(f"tpusnark_torch.{name}")
    theirs = import_module(f"tpusnark.{name}")
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def test_plonk_builder_scs_and_transcript_values_equal_tpusnark():
    import tpusnark.constraint.scs as jscs
    import tpusnark.frontend.plonk_builder as jpb
    import tpusnark.utils.transcript as jtr
    import tpusnark_torch.constraint.scs as tscs
    import tpusnark_torch.frontend.plonk_builder as tpb
    import tpusnark_torch.utils.transcript as ttr

    p = tcurves.get_curve("bn254").host.R
    ours, theirs = plonk_circuit(tpb, p), plonk_circuit(jpb, p)
    assert scs_image(ours) == scs_image(theirs)
    assign = {"x": 3, "z": 4, "y": 27 + 3 + 5 + 0}
    fixed = {"bsb22_placeholder": lambda _p, ins: [12345]}
    W = tscs.solve_scs(ours, assign, hint_overrides=fixed)
    assert W == jscs.solve_scs(theirs, assign, hint_overrides=fixed) == tscs.solve_scs(theirs, assign, hint_overrides=fixed)
    for mod, cs in ((tscs, ours), (jscs, theirs)):
        with pytest.raises(mod.UnsatisfiedGateError):
            mod.solve_scs(cs, {**assign, "y": 1}, hint_overrides=fixed)
    assert ours.gate_arrays()[1] == theirs.gate_arrays()[1]
    host = tcurves.get_curve("bn254").host
    pts = [host.G1.mul(host.G1.generator(), k) for k in (3, 99)] + [None]

    def challenges(mod):
        tr = mod.Transcript(["gamma", "beta"])
        for pt in pts:
            tr.bind("gamma", mod.g1_bytes(pt))
        tr.bind("beta", mod.fr_bytes(77))
        fold = mod.kzg_fold_challenge(5, pts, [1, 2], [mod.fr_bytes(3)], p)
        return tr.challenge_int("gamma", p), tr.challenge_int("beta", p), fold

    assert challenges(ttr) == challenges(jtr)


def test_plonk_setup_helpers_equal_tpusnark():
    jps = import_module("tpusnark.backend.plonk.setup")
    tps = import_module("tpusnark_torch.backend.plonk.setup")
    import tpusnark.frontend.plonk_builder as jpb
    import tpusnark_torch.frontend.plonk_builder as tpb

    p = tcurves.get_curve("bn254").host.R
    for n in (1, 8, 9, 1 << 17):
        assert tps._next_pow2(n) == jps._next_pow2(n)
    for n in (8, 16, 1 << 17):
        assert tps.pick_cosets(n, p) == jps.pick_cosets(n, p)
    ours, theirs = plonk_circuit(tpb, p), plonk_circuit(jpb, p)
    n = tps._next_pow2(max(8, ours.n_gates))
    assert tps.build_permutation(ours, n) == jps.build_permutation(theirs, n)
    cols = tps.selector_columns(ours, n, "cpu")
    fr = get_field(tspec.BN254_FR)
    (_, _, _), q = theirs.gate_arrays()
    for name, vals in q.items():
        assert fr.decode(cols[name]) == vals + [0] * (n - theirs.n_gates), name


def test_plonk_containers_and_config_have_tpusnark_fields():
    jkeys_p = import_module("tpusnark.backend.plonk.keys")
    tkeys_p = import_module("tpusnark_torch.backend.plonk.keys")
    for name in ("PlonkVerifyingKey", "PlonkProof"):
        ours = [(f.name, f.default) for f in dataclasses.fields(getattr(tkeys_p, name))]
        assert ours == [(f.name, f.default) for f in dataclasses.fields(getattr(jkeys_p, name))], name
    ours = [f.name for f in dataclasses.fields(tkeys_p.PlonkProvingKey)]
    theirs = [f.name for f in dataclasses.fields(jkeys_p.PlonkProvingKey)]
    # the permutation values as setup made them on the device, not host lists
    assert ours == ["s_lag" if name == "s_evals_int" else name for name in theirs]
    assert [f.name for f in dataclasses.fields(tconfig.ProverConfig)] == [
        f.name for f in dataclasses.fields(jconfig.ProverConfig)
    ]
    for mod in (tconfig, jconfig):
        cfg = mod.ProverConfig().with_challenge_hash("h").with_kzg_fold_hash("k")
        assert (cfg.challenge_hash, cfg.kzg_fold_hash) == ("h", "k")
        vcfg = mod.VerifierConfig().with_challenge_hash("h").with_kzg_fold_hash("k")
        assert (vcfg.challenge_hash, vcfg.kzg_fold_hash) == ("h", "k")


# ------------------------------------------------ the ceremony and its shipping
@pytest.mark.parametrize("name", ("curves.hash_to_g2", "backend.groth16.marshal", "backend.groth16.solidity"))
def test_ceremony_and_shipping_host_modules_are_tpusnark_code(name):
    """The copies of hash-to-G2 (the ceremony's proof-of-knowledge base),
    Groth16's gnark byte layout and its Solidity export are tpusnark's code."""
    ours = import_module(f"tpusnark_torch.{name}")
    theirs = import_module(f"tpusnark.{name}")
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


# the port's own: the device rescale and its sync (tpusnark's rescale runs
# its JAX code inside _scale_g1/_scale_g2), and the imports they use
MPC_PORT_ONLY = {"_scale", "_sync", "torch", "time", "VarBaseMul", "get_curve", "g1_to_device", "g2_to_device"}
MPC_PORT_ONLY |= {"curve_ops", "compute_device", "get_field", "to_affine", "to_host"}
MPC_RESCALE = {"_scale_g1", "_scale_g2"}


def methods_of(cls) -> dict:
    """name -> function of the methods a class defines in its source (the
    dataclass-made dunders left out), properties as their getters."""
    out = {}
    for k, v in vars(cls).items():
        v = v.fget if isinstance(v, property) else v.__func__ if isinstance(v, staticmethod) else v
        if inspect.isfunction(v) and not k.startswith("__"):
            out[k] = v
    return out


def test_mpcsetup_is_tpusnark_code_but_the_rescale():
    """Every function and method of the port's mpcsetup but the rescale
    (_scale_g1, _scale_g2 and the two contribute methods, which take a
    device) is tpusnark's code; the dataclasses have tpusnark's fields and
    the shape rule tpusnark's threshold."""
    tm = import_module("tpusnark_torch.backend.groth16.mpcsetup")
    jm = import_module("tpusnark.backend.groth16.mpcsetup")
    names = {n for n in vars(tm) if not n.startswith("__")}
    assert names == {n for n in vars(jm) if not n.startswith("__")} | MPC_PORT_ONLY
    assert tm._DEVICE_THRESHOLD == jm._DEVICE_THRESHOLD == 1 << 9
    compared = 0
    for name in sorted(names - MPC_PORT_ONLY - MPC_RESCALE):
        ours, theirs = getattr(tm, name), getattr(jm, name)
        if inspect.isfunction(theirs) and theirs.__module__ == jm.__name__:
            assert code_without_docstrings(ours) == code_without_docstrings(theirs), name
            compared += 1
        elif inspect.isclass(theirs) and theirs.__module__ == jm.__name__:
            assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
            assert methods_of(ours).keys() == methods_of(theirs).keys()
            for m, fn in sorted(methods_of(theirs).items()):
                if m != "contribute":
                    assert code_without_docstrings(methods_of(ours)[m]) == code_without_docstrings(fn), f"{name}.{m}"
                    compared += 1
    assert compared >= 25


def test_hash_to_g2_values_equal_tpusnark():
    ours = import_module("tpusnark_torch.curves.hash_to_g2")
    theirs = import_module("tpusnark.curves.hash_to_g2")
    host = tcurves.get_curve("bn254").host
    assert ours.G2_COFACTOR == theirs.G2_COFACTOR
    for msg, dst in ((b"hello", b"dst-a"), (b"", bytes([1])), (bytes(range(160)), bytes([3]))):
        q = ours.hash_to_g2(msg, dst)
        assert q == theirs.hash_to_g2(msg, dst) and host.G2.in_subgroup(q)


def test_marshal_and_solidity_of_a_host_proof_equal_tpusnark():
    """On the host-made toy proof: the port's marshal gives tpusnark's bytes
    and reads them back; the exported contract text and calldata are
    tpusnark's."""
    tmarshal = import_module("tpusnark_torch.backend.groth16.marshal")
    jmarshal = import_module("tpusnark.backend.groth16.marshal")
    tsol = import_module("tpusnark_torch.backend.groth16.solidity")
    jsol = import_module("tpusnark.backend.groth16.solidity")
    proof, vk, _ = toy_proof("bn254", tkeys)
    for raw in (False, True):
        assert tmarshal.proof_to_bytes(proof, raw) == jmarshal.proof_to_bytes(proof, raw)
        assert tmarshal.vk_to_bytes(vk, raw) == jmarshal.vk_to_bytes(vk, raw)
        assert tmarshal.proof_from_bytes(tmarshal.proof_to_bytes(proof, raw)) == proof
        assert tmarshal.vk_from_bytes(jmarshal.vk_to_bytes(vk, raw)) == vk
    assert tsol.export_solidity(vk) == jsol.export_solidity(vk)
    assert tsol.proof_to_solidity_calldata(proof) == jsol.proof_to_solidity_calldata(proof)
