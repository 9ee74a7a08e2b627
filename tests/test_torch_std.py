"""The port's standard gadgets (tpusnark_torch's copies of tpusnark's test
engine, bits, cmp, selector, bitslice, multicommit, lookup, rangecheck,
keccakf, sha3 and the MiMC transcript hash) against the originals: each copy
is tpusnark's code; bits, cmp, selector and bitslice give tpusnark's values
on both packages' TestEngine, and the values that plain Python gives; the
lookup, range-check and multicommit circuits build the same constraint
system with either package's builder, constraint for constraint, whose
witness from the port's host solver and from its level solver
(``LevelSolver(device="cpu")``, the plain versions) equals tpusnark's host
solver's, wire for wire, and each solver refuses a value out of range and a
forged lookup value; Keccak-f and the sponges on the port's engine equal
tpusnark's engine, the port's host Keccak and hashlib; MiMCFrHash's digests
equal tpusnark's. Exact."""

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
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
PACKAGES = ("tpusnark_torch", "tpusnark")
COPIES = (
    "testing.engine",
    "gadgets.bits",
    "gadgets.cmp",
    "gadgets.selector",
    "gadgets.bitslice",
    "gadgets.multicommit",
    "gadgets.lookup",
    "gadgets.rangecheck",
    "gadgets.keccakf",
    "gadgets.sha3",
    "utils.mimc_transcript",
)


@pytest.mark.parametrize("name", COPIES)
def test_std_modules_are_tpusnark_code(name):
    ours, theirs = both(name)
    assert code_without_docstrings(ours) == code_without_docstrings(theirs)


# ---- the gadgets on each package's TestEngine ------------------------------
def engine(pkg, assignment=None):
    return import_module(f"{pkg}.testing.engine").TestEngine(P, assignment or {})


def outcome(fn):
    """fn()'s value, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as e:
        return f"refused: {type(e).__name__}"


REFUSED = "refused: CircuitNotSatisfiedError"


def bits_values(pkg):
    bits = import_module(f"{pkg}.gadgets.bits")
    eng = engine(pkg)
    rng = random.Random(21)
    out = {}
    for v in (0, 1, 2, 3**20 - 1, rng.randrange(3**30)):
        digits = bits.to_ternary(eng, v, 30)
        out["ternary", v] = (digits, bits.from_ternary(eng, digits))
        out["naf", v] = bits.to_naf(eng, v, 50)
    out["ternary too short"] = outcome(lambda: bits.to_ternary(eng, 3**5, 5))
    out["naf too short"] = outcome(lambda: bits.to_naf(eng, 1 << 10, 8))
    out["ternary digit 3"] = outcome(lambda: bits.from_ternary(eng, [1, 3]))
    return out


def cmp_values(pkg):
    cmp = import_module(f"{pkg}.gadgets.cmp")
    eng = engine(pkg)
    c = cmp.BoundedComparator(eng, 64)
    rng = random.Random(22)
    pairs = [(3, 5), (5, 3), (7, 7), (0, (1 << 64) - 1)] + [(rng.getrandbits(64), rng.getrandbits(64)) for _ in range(4)]
    out = {(a, b): (c.is_less(a, b), c.is_less_eq(a, b), c.min_(a, b), c.max_(a, b), cmp.is_equal(eng, a, b)) for a, b in pairs}
    out["assert_is_less 5 3"] = outcome(lambda: c.assert_is_less(5, 3))
    out["assert_is_less_eq 3 5"] = outcome(lambda: c.assert_is_less_eq(3, 5))
    out["assert_is_less_eq 6 5"] = outcome(lambda: c.assert_is_less_eq(6, 5))
    return out


def selector_values(pkg):
    sel = import_module(f"{pkg}.gadgets.selector")
    eng = engine(pkg)
    ins = [10, 20, 30, 40]
    keys, vals = [3, 7, 9], [30, 70, 90]
    out = {f"mux {s}": sel.mux(eng, s, *ins) for s in range(4)}
    out["mux 4"] = outcome(lambda: sel.mux(eng, 4, *ins))
    out.update({f"map {k}": sel.map_lookup(eng, k, keys, vals) for k in keys})
    out["map 8"] = outcome(lambda: sel.map_lookup(eng, 8, keys, vals))
    out.update({f"in {n}": sel.is_in_slice(eng, n, [5, 6, 5, 9]) for n in (5, 6, 9, 7)})
    return out


def bitslice_values(pkg):
    bs = import_module(f"{pkg}.gadgets.bitslice")
    eng = engine(pkg)
    rng = random.Random(23)
    v = rng.getrandbits(200)
    out = {f"split {s}": bs.partition(eng, v, s, nbits=200) for s in (0, 1, 17, 64, 128, 200)}
    out["default width"] = bs.partition(eng, (1 << 253) - 1, 100)
    out["too wide"] = outcome(lambda: bs.partition(eng, 1 << 200, 64, nbits=200))
    return out, v


def test_bits_on_the_engine_equal_tpusnark():
    ours, theirs = bits_values("tpusnark_torch"), bits_values("tpusnark")
    assert ours == theirs
    for key, val in ours.items():
        if isinstance(key, str):
            continue
        kind, v = key
        if kind == "ternary":
            digits, back = val
            assert back == v and digits == [(v // 3**i) % 3 for i in range(30)]
        else:
            d = [x - P if x > 1 else x for x in val]
            assert sum(x << i for i, x in enumerate(d)) == v
            assert all(not (a and b) for a, b in zip(d, d[1:]))  # non-adjacent
    assert ours["ternary too short"] == ours["naf too short"] == ours["ternary digit 3"] == REFUSED


def test_cmp_on_the_engine_equal_tpusnark():
    ours, theirs = cmp_values("tpusnark_torch"), cmp_values("tpusnark")
    assert ours == theirs
    for key, val in ours.items():
        if isinstance(key, tuple):
            a, b = key
            assert val == (int(a < b), int(a <= b), min(a, b), max(a, b), int(a == b))
    assert ours["assert_is_less 5 3"] == ours["assert_is_less_eq 6 5"] == REFUSED
    assert ours["assert_is_less_eq 3 5"] is None


def test_selector_on_the_engine_equals_tpusnark():
    ours, theirs = selector_values("tpusnark_torch"), selector_values("tpusnark")
    assert ours == theirs
    assert [ours[f"mux {s}"] for s in range(4)] == [10, 20, 30, 40]
    assert [ours[f"map {k}"] for k in (3, 7, 9)] == [30, 70, 90]
    assert [ours[f"in {n}"] for n in (5, 6, 9, 7)] == [1, 1, 1, 0]
    assert ours["mux 4"] == ours["map 8"] == REFUSED


def test_bitslice_on_the_engine_equals_tpusnark():
    (ours, v), (theirs, _) = bitslice_values("tpusnark_torch"), bitslice_values("tpusnark")
    assert ours == theirs
    for s in (0, 1, 17, 64, 128, 200):
        lo, hi = ours[f"split {s}"]
        assert (lo, hi) == (v & ((1 << s) - 1), v >> s)
    assert ours["default width"] == ((1 << 100) - 1, (1 << 153) - 1)
    assert ours["too wide"] == REFUSED


# ---- circuits: lookup, range check, multicommit ----------------------------
def lookup_circuit(pkg):
    """A table of one variable and six constant entries, eight variable
    indices and a constant one; each looked-up value equal to a public
    output."""
    lookup = import_module(f"{pkg}.gadgets.lookup")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    table = lookup.LookupTable(b)
    table.insert(b.secret("e0"))
    entries = [777, 17, 23, 99, 41, 5, 1000]
    for v in entries[1:]:
        table.insert(v)
    inds = [0, 1, 2, 3, 3, 6, 0, 5]
    outs = table.lookup(*(b.secret(f"i{k}") for k in range(len(inds))), 3)
    for k, o in enumerate(outs):
        b.assert_is_equal(o, b.public(f"o{k}"))
    assign = {"e0": entries[0], **{f"i{k}": i for k, i in enumerate(inds)}}
    assign.update({f"o{k}": entries[i] for k, i in enumerate(inds + [3])})
    return b.compile(), assign


def rangecheck_circuit(pkg):
    """chip_smoke's range check at 64 values of 64 bits."""
    return chip_smoke.rangecheck_circuit(
        64,
        64,
        P,
        chip_smoke.SEED + 90,
        builder=import_module(f"{pkg}.frontend.builder").Builder,
        checker=import_module(f"{pkg}.gadgets.rangecheck"),
    )


def rangecheck_narrow_circuit(pkg):
    """Widths that 4-bit limbs do not divide (the top limb's shifted
    lookup): v < 2^10 and w < 2^7."""
    rangecheck = import_module(f"{pkg}.gadgets.rangecheck")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    rc = rangecheck.range_checker(b, base_bits=4)
    v, w = b.secret("v0"), b.secret("w")
    rc.check(v, 10)
    rc.check(w, 7)
    b.assert_is_equal(b.add(v, w), b.public("sum"))
    return b.compile(), {"v0": 1000, "w": 100, "sum": 1100}


def multicommit_circuit(pkg):
    """Two gadgets' callbacks, each given its own challenge derived from one
    BSB22 commitment, multiply it into a public output."""
    multicommit = import_module(f"{pkg}.gadgets.multicommit")
    b = import_module(f"{pkg}.frontend.builder").Builder(P)
    x, y = b.secret("x"), b.secret("y")
    got = {}
    multicommit.with_commitment(b, lambda api, c: got.__setitem__("a", api.mul(c, x)), x)
    multicommit.with_commitment(b, lambda api, c: got.__setitem__("b", api.mul(c, y)), y)
    b.defer_(lambda api: api.assert_is_different(got["a"], got["b"]))
    cs = b.compile()
    assert len(cs.commitments) == 1
    return cs, {"x": 5, "y": 5}


CIRCUITS = {
    "lookup": lookup_circuit,
    "rangecheck": rangecheck_circuit,
    "rangecheck_narrow": rangecheck_narrow_circuit,
    "multicommit": multicommit_circuit,
}


def solvers(ours, theirs, pkg_overrides=None):
    """(name, solve(assignment)) of the three solvers: the port's host and
    level solvers on its system, tpusnark's host solver on tpusnark's;
    pkg_overrides(pkg) gives each package's hint overrides."""
    ov = pkg_overrides or (lambda pkg: None)
    return (
        ("port host", lambda a: tsolver.solve(ours, a, hint_overrides=ov("tpusnark_torch"))),
        ("port level", lambda a: level_solve(ours, a, ov("tpusnark_torch"))),
        ("tpusnark host", lambda a: jsolver.solve(theirs, a, hint_overrides=ov("tpusnark"))),
    )


@pytest.mark.parametrize("circuit", CIRCUITS)
def test_std_systems_and_witnesses_equal_tpusnark(circuit):
    ours, assign = CIRCUITS[circuit]("tpusnark_torch")
    theirs, jassign = CIRCUITS[circuit]("tpusnark")
    assert assign == jassign
    assert cs_image(ours) == cs_image(theirs)
    assert [c.__dict__ for c in ours.commitments] == [c.__dict__ for c in theirs.commitments]
    want = jsolver.solve(theirs, assign)
    assert tsolver.solve(ours, assign) == want
    assert level_solve(ours, assign) == want


def refusals(ours, theirs, bad, pkg_overrides=None):
    """{solver: the name of the exception it raised on `bad`}."""
    out = {}
    for name, solve in solvers(ours, theirs, pkg_overrides):
        with pytest.raises(Exception) as err:
            solve(bad)
        out[name] = type(err.value).__name__
    return out


@pytest.mark.parametrize("circuit", ("rangecheck", "rangecheck_narrow"))
def test_rangecheck_refuses_a_value_out_of_range(circuit):
    ours, assign = CIRCUITS[circuit]("tpusnark_torch")
    theirs, _ = CIRCUITS[circuit]("tpusnark")
    # the limbs of 2^64 and of p - 1 drop their top bits, and the
    # recomposition fails; 2^10's top 4-bit limb, shifted for its 2 bits,
    # indexes past the table
    unsat = "UnsatisfiedConstraintError"
    width, top = (64, unsat) if circuit == "rangecheck" else (10, "ValueError")
    for v, want in ((1 << width, top), (P - 1, unsat)):  # just out of range, and a wrap around p
        bad = dict(assign, v0=v, sum=(assign["sum"] - assign["v0"] + v) % P)
        assert set(refusals(ours, theirs, bad).values()) == {want}


def test_lookup_refuses_a_forged_value_and_an_index_out_of_range():
    ours, assign = lookup_circuit("tpusnark_torch")
    theirs, _ = lookup_circuit("tpusnark")

    def overrides(pkg):
        real = import_module(f"{pkg}.gadgets.lookup").lookup_hint

        def forged(p, ins):  # the first query's value off by one
            outs = real(p, ins)
            return [(outs[0] + 1) % p] + outs[1:]

        return {real: forged}

    forged = dict(assign, o0=(assign["o0"] + 1) % P)  # the public output agrees with the forgery
    assert set(refusals(ours, theirs, forged, overrides).values()) == {"UnsatisfiedConstraintError"}
    assert set(refusals(ours, theirs, dict(assign, i0=7)).values()) == {"ValueError"}


# ---- Keccak-f and the sponges; MiMC's transcript hash ----------------------
def engine_keccak_f(pkg, words):
    u = import_module(f"{pkg}.gadgets.uints")
    keccakf = import_module(f"{pkg}.gadgets.keccakf")
    eng = engine(pkg)
    return [u.to_var(eng, w) for w in keccakf.keccak_f(eng, [u.from_const(w, 64) for w in words])]


def host_keccak_f(words):
    from tpusnark_torch.hashes.keccak import _keccak_f

    a = [[words[x + 5 * y] for y in range(5)] for x in range(5)]
    _keccak_f(a)
    return [a[x][y] for y in range(5) for x in range(5)]


SPONGES = [(variant, n) for variant in ("keccak-256", "sha3-256") for n in (0, 5, 136)]


def test_keccak_f_on_the_engine_equals_tpusnark_and_the_host():
    rng = random.Random(31)
    for words in ([0] * 25, [rng.getrandbits(64) for _ in range(25)]):
        ours = engine_keccak_f("tpusnark_torch", words)
        assert ours == engine_keccak_f("tpusnark", words) == host_keccak_f(words)


@pytest.mark.parametrize("variant,n", SPONGES)
def test_sponges_on_the_engine_equal_tpusnark_the_host_and_hashlib(variant, n):
    from tpusnark_torch.hashes import keccak as hk

    rng = random.Random(32 + n)
    data = bytes(rng.randrange(256) for _ in range(n))
    ours, theirs = (
        bytes(import_module(f"{pkg}.gadgets.sha3").sponge(engine(pkg), list(data), variant)) for pkg in PACKAGES
    )
    assert ours == theirs
    if variant == "sha3-256":
        assert ours == hk.sha3_256(data) == hashlib.sha3_256(data).digest()
    else:
        assert ours == hk.keccak256(data)


def test_mimc_transcript_hash_equals_tpusnark():
    ours, theirs = both("utils.mimc_transcript")
    rng = random.Random(33)
    for sizes in ([], [0], [1], [31], [32], [33], [100], [5, 64, 7]):
        payloads = [bytes(rng.randrange(256) for _ in range(n)) for n in sizes]
        h_ours, h_theirs = ours.MiMCFrHash(), theirs.MiMCFrHash()
        for data in payloads:
            h_ours.update(data)
            h_theirs.update(data)
        assert h_ours.digest() == h_theirs.digest() and len(h_ours.digest()) == h_ours.digest_size
    v = rng.getrandbits(256)
    assert ours.word_pair(v) == theirs.word_pair(v) == (v >> 128, v & ((1 << 128) - 1))
