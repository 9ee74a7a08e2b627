"""The port's field arithmetic (tpusnark_torch.fields.tfield, plain versions
on the CPU) against tpusnark's Field (JAX on the CPU) and Python ints, on
the same seeded inputs, for the fields with kernels, every width and R: BN254
fr and fp and BLS12-377 fr (8 words), BLS12-381 fr and BLS24-317 fr (9 words;
their R = 2^288 is not tpusnark's 2^272), BLS24-315 fp and BW6-633 fr (10
words), BLS12-381 fp, BLS12-377 fp and BW6-761 fr (12 words), BW6-633 fp (20
words) and BW6-761 fp (24 words, where a product has 48 word rows of
carries); the constants of all fourteen. Exact: values are compared as ints mod p. Also the
constants of csrc/mont.cuh against FieldSpec, the R of 17-limb specs across
convert.py, and the wrappers' refusals."""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import (
    BLS12_377_FP,
    BLS12_377_FR,
    BLS12_381_FP,
    BLS12_381_FR,
    BLS24_315_FP,
    BLS24_315_FR,
    BLS24_317_FP,
    BLS24_317_FR,
    BN254_FP,
    BN254_FR,
    BW6_633_FP,
    BW6_633_FR,
    BW6_761_FP,
    BW6_761_FR,
)
from tpusnark_torch.fields.spec import FieldSpec
from tpusnark_torch import kernels
from tpusnark_torch.convert import from_torch, limbs_to_words, to_torch, words_to_limbs
from tpusnark_torch.fields import tfield
from tpusnark_torch.fields.tfield import Field, n_words

torch.set_num_threads(1)  # the suite's workers fill the cores already

SPECS = {
    s.name: s
    for s in (
        BN254_FR,
        BN254_FP,
        BLS12_381_FR,
        BLS12_381_FP,
        BLS12_377_FR,
        BLS12_377_FP,
        BW6_761_FR,
        BW6_761_FP,
        BLS24_315_FR,
        BLS24_315_FP,
        BLS24_317_FR,
        BLS24_317_FP,
        BW6_633_FR,
        BW6_633_FP,
    )
}
# the specs the arithmetic tests run over: every width and R once (BLS24-315
# fr has BN254's 8 words, BLS24-317 fp BLS24-315 fp's 10; the header test
# checks their constants)
ARITH = sorted(set(SPECS) - {"bls24_315_fr", "bls24_317_fp"})
# a spec that no kernel serves: the Mersenne prime 2^89 - 1 over 8 limbs
MADE_UP = FieldSpec("made_up_fp", (1 << 89) - 1, 8)
N = 48


def raw_values(p, seed, words, n=N):
    """Representatives in the lazy range [0, 2p): edge cases, then random."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    rand = [int.from_bytes(rng.bytes(4 * words), "little") % (2 * p) for _ in range(n - len(edge))]
    return edge + rand


def to_words(vals, words):
    buf = b"".join(v.to_bytes(4 * words, "little") for v in vals)
    w = np.frombuffer(buf, dtype="<u4").reshape(-1, words)
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32))


def both(spec, seed):
    """(port Field, tpusnark Field, raw ints, port tensor, tpusnark array):
    the same values mod p on both sides."""
    f = Field(spec)
    vals = raw_values(spec.modulus, seed, f.n)
    t = to_words(vals, f.n)
    return f, JField(spec), vals, t, jnp.asarray(words_to_limbs(t, spec))


def dec_port(f, t, mont=True):
    return f.decode(t, mont=mont)


def dec_jax(jf, a, mont=True):
    return jf.to_ints(np.asarray(a), mont=mont)


BINARY = {
    "add": lambda x, y, p: (x + y) % p,
    "sub": lambda x, y, p: (x - y) % p,
    "mul": lambda x, y, p: x * y % p,
}


@pytest.mark.parametrize("name", ARITH)
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_matches_tpusnark(name, op):
    spec = SPECS[name]
    f, jf, xs, a, ja = both(spec, 1)
    _, _, ys, b, jb = both(spec, 2)
    p, rinv = spec.modulus, f.r_inv
    got = dec_port(f, getattr(f, op)(a, b))
    want_jax = dec_jax(jf, getattr(jf, op)(ja, jb))
    want = [BINARY[op](x * rinv, y * rinv, p) for x, y in zip(xs, ys)]
    assert got == want_jax == want


@pytest.mark.parametrize("name", ARITH)
@pytest.mark.parametrize("op", ["neg", "double", "square", "to_mont", "canon"])
def test_unary_matches_tpusnark(name, op):
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 3)
    got, want = dec_port(f, getattr(f, op)(a)), dec_jax(jf, getattr(jf, op)(ja))
    if op == "to_mont":
        # reads the words as an integer: with another R the bits differ
        assert got == dec_port(f, a, mont=False) and want == dec_jax(jf, ja, mont=False)
        if spec.n_limbs % 2:
            return
    assert got == want


@pytest.mark.parametrize("name", ARITH)
def test_from_mont_matches_tpusnark(name):
    spec = SPECS[name]
    f, jf, xs, a, ja = both(spec, 4)
    got = f.from_mont(a)
    # output <= p; p only for a representation of zero
    assert max(f.decode(got, mont=False)) < spec.modulus
    assert dec_port(f, got, mont=False) == dec_jax(jf, jf.from_mont(ja), mont=False)
    assert dec_port(f, got, mont=False) == [x * f.r_inv % spec.modulus for x in xs]


# one spec of every word count and R
WIDTHS = ["bn254_fp", "bls12_381_fr", "bls24_315_fp", "bls12_381_fp", "bw6_633_fp", "bw6_761_fp"]


@pytest.mark.parametrize("name", WIDTHS)
def test_mul_and_from_mont_at_1024_lanes_equal_tpusnark_word_for_word(name):
    """The plain product at the lane counts the card's checks hold the
    kernels against it (thousands of lanes) gives tpusnark's words, and
    Python's integers."""
    spec = SPECS[name]
    f, jf, p = Field(spec), JField(spec), spec.modulus
    xs, ys = (raw_values(p, seed, f.n, n=1024) for seed in (9, 10))
    a, b = to_words(xs, f.n), to_words(ys, f.n)
    ja, jb = (jnp.asarray(words_to_limbs(t, spec)) for t in (a, b))
    prod, red = f.mul(a, b), f.from_mont(a)
    jprod, jred = jf.mul(ja, jb), jf.from_mont(ja)
    if spec.n_limbs % 2 == 0:  # the same R: the same lazy words
        assert np.array_equal(words_to_limbs(prod, spec), np.asarray(jprod))
        assert np.array_equal(words_to_limbs(red, spec), np.asarray(jred))
    else:
        assert f.decode(prod) == jf.to_ints(jprod)
    assert f.decode(red, mont=False) == jf.to_ints(jred, mont=False) == [x * f.r_inv % p for x in xs]
    assert f.decode(prod) == [x * y * f.r_inv * f.r_inv % p for x, y in zip(xs, ys)]
    assert max(word_ints(prod)) < 2 * p


def word_ints(t):
    """The integers the words of t hold (no reduction)."""
    w = t.numpy().view(np.uint32).astype(object)
    return [sum(int(w[k, i]) << (32 * k) for k in range(w.shape[0])) for i in range(w.shape[1])]


@pytest.mark.parametrize("name", ARITH)
def test_lazy_range_and_words_agree_with_tpusnark(name):
    """mul/add/sub keep [0, 2p). Where the port's R is tpusnark's (an even
    limb count) they give tpusnark's representatives bit for bit."""
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 5)
    _, _, _, b, jb = both(spec, 6)
    for op in ("mul", "add", "sub"):
        got = getattr(f, op)(a, b)
        want = getattr(jf, op)(ja, jb)
        assert max(word_ints(got)) < 2 * spec.modulus
        if spec.n_limbs % 2 == 0:
            assert np.array_equal(words_to_limbs(got, spec), np.asarray(want))
        else:
            assert f.decode(got) == jf.to_ints(want)


@pytest.mark.parametrize("name", ARITH)
def test_inv_mul_const_is_zero_select(name):
    spec = SPECS[name]
    p = spec.modulus
    f, jf = Field(spec), JField(spec)
    xs = [0, 1, p - 1, 12345, 2**200 + 7]
    a, ja = f.encode(xs), jf.array(xs)
    assert dec_port(f, f.inv(a)) == dec_jax(jf, jf.inv(ja)) == [pow(x, -1, p) if x else 0 for x in xs]
    assert dec_port(f, f.mul_const(a, 9)) == dec_jax(jf, jf.mul_const(ja, 9))
    zero_p = to_words([0, p, 1, 2 * p - 1], f.n)
    assert f.is_zero(zero_p).tolist() == [True, True, False, False]
    if spec.n_limbs % 2 == 0:  # the same bits are the same lazy values
        assert f.is_zero(zero_p).tolist() == np.asarray(jf.is_zero(jnp.asarray(words_to_limbs(zero_p, spec)))).tolist()
    cond = torch.tensor([True, False, True, False, False])
    assert dec_port(f, f.select(cond, a, f.neg(a))) == [x if c else (-x) % p for x, c in zip(xs, cond.tolist())]


@pytest.mark.parametrize("name", ARITH)
def test_segment_sum_matches_tpusnark(name):
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 7)
    ids = np.random.default_rng(8).integers(0, 5, size=N)
    got = f.segment_sum(a, torch.from_numpy(ids), 6, max_segment=N)
    want = jf.segment_sum(ja, jnp.asarray(ids), 6, max_segment=N)
    assert dec_port(f, got) == dec_jax(jf, want)
    sums = [0] * 6
    for x, i in zip(raw_values(spec.modulus, 7, f.n), ids):
        sums[i] = (sums[i] + x * f.r_inv) % spec.modulus
    assert dec_port(f, got) == sums


@pytest.mark.parametrize("name", ARITH)
def test_encoding_round_trip_and_layout_conversion(name):
    """The port's words of canonical values are tpusnark's limbs converted
    by convert.py, both ways, at every word count."""
    spec = SPECS[name]
    f = Field(spec)
    p = spec.modulus
    xs = [0, 1, p - 1, 2**255 % p]
    t = f.encode(xs)
    assert t.dtype == torch.int32 and t.shape == (n_words(spec), 4)
    assert f.decode(t) == xs
    limbs = spec.encode(xs).T  # tpusnark's (n_limbs, N) Montgomery limbs
    assert np.array_equal(limbs_to_words(limbs, spec), t.numpy())
    assert np.array_equal(words_to_limbs(t, spec), limbs)


def test_17_limb_montgomery_radix_is_re_encoded():
    """BLS12-381 fr: tpusnark's 17 limbs hold x * 2^272 mod p, the port's 9
    words x * 2^288 mod p. convert.py re-encodes (a reinterpretation of the
    bits would be off by 2^16), and both sides decode to x after a round
    trip through the other's layout, for lazy inputs in [0, 2p) too."""
    spec = BLS12_381_FR
    p = spec.modulus
    f, jf = Field(spec), JField(spec)
    assert (f.r, spec.r) == ((1 << 288) % p, (1 << 272) % p)
    xs = [0, 1, p - 1, 12345, 2**254 + 3]
    ja = jf.array(xs)  # (17, N) limbs, Montgomery with 2^272
    t = to_torch(ja, spec)
    assert t.shape == (9, len(xs)) and f.decode(t) == xs
    assert jf.to_ints(from_torch(f.encode(xs), spec)) == xs
    lazy = to_words([v * 2**288 % p + p for v in xs[1:4]], 9)  # x R + p < 2p
    assert jf.to_ints(from_torch(lazy, spec)) == xs[1:4]
    padded = np.zeros((18, len(xs)), dtype=np.uint32)
    padded[:17] = np.asarray(ja)  # the bits alone, read as 9 words
    wrong = torch.from_numpy(limbs_to_words(padded, BN254_FR)[:9].copy())
    assert f.decode(wrong)[1:] != xs[1:]


def _word_rows(vals, rows):
    """Integers -> (rows, N) int64 words, as the plain versions hold them."""
    return torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals] for k in range(rows)], dtype=torch.int64)


def _rows_value(w, i):
    return sum(int(w[k, i]) << (32 * k) for k in range(w.shape[0]))


def test_24_word_products_with_long_carry_ripples_equal_python_ints():
    """BW6-761's fp has 24 words, so a product has 48 word rows. A carry
    resolution that weighs rows by 3^j in int64 is sound up to 39 rows and
    overflows here; operands whose carries ripple across more rows than that
    ((p - 1)^2, 2^k - 1 patterns) must still equal Python's integers."""
    spec = BW6_761_FP
    f = Field(spec)
    assert f.n == 24 and tfield.MAX_WORDS >= 24
    p, rinv = spec.modulus, f.r_inv
    ones = [(1 << k) - 1 for k in (760, 761, 736, 700)]  # 2^k - 1 < 2p: runs of full words
    xs = [p - 1, 2 * p - 1, p - 1, 1, *ones, (1 << 761) - (1 << 31), 0]
    ys = [p - 1, 2 * p - 1, 2 * p - 1, 2 * p - 1, *ones[::-1], (1 << 32) + 1, 2 * p - 1]
    assert max(xs + ys) < 2 * p
    a, b = to_words(xs, 24), to_words(ys, 24)
    assert f.decode(f.mul(a, b)) == [x * y * rinv * rinv % p for x, y in zip(xs, ys)]
    assert f.decode(f.add(a, b)) == [(x + y) * rinv % p for x, y in zip(xs, ys)]
    assert f.decode(f.sub(a, b)) == [(x - y) * rinv % p for x, y in zip(xs, ys)]
    assert f.decode(f.from_mont(a), mont=False) == [x * rinv % p for x in xs]
    assert max(word_ints(f.mul(a, b))) < 2 * p
    # the carry resolution itself on 48 rows: a carry (and a borrow) that
    # enters at the bottom and ripples through every row, and one that dies
    full = (1 << (32 * 48)) - 1
    vals = [full, full - (1 << 32 * 40), 1 << (32 * 47), 12345]
    cols = _word_rows(vals, 48)
    cols[0] += 1  # + 1: every word of `full` carries into the next
    words, carry = tfield._normalize(cols)
    for i, v in enumerate(vals):
        assert _rows_value(words, i) + (int(carry[i]) << (32 * 48)) == v + 1
    zero_rows = torch.zeros_like(cols)
    diff, borrow = tfield._sub_words(zero_rows, _word_rows([1, 0, 1 << (32 * 47), full], 48))
    assert borrow.tolist() == [True, False, True, True]
    assert [_rows_value(diff, i) for i in range(4)] == [full, 0, full + 1 - (1 << (32 * 47)), 1]


@pytest.mark.parametrize("rows", [16, 24, 39, 40, 48])
def test_carry_resolution_agrees_on_both_sides_of_39_rows(rows):
    """Carries are resolved at every row count the fields reach (weights of
    3^j in int64 were sound only up to 39 rows): random columns with planted
    runs of 2^32 - 1 normalise to the integer they hold on either side of
    39."""
    rng = np.random.default_rng(rows)
    cols = torch.from_numpy(rng.integers(0, 1 << 40, size=(rows, 64), dtype=np.int64))
    cols[2 : rows - 1, :32] = 0xFFFFFFFF  # long runs that pass a carry on
    cols[1, :16] = 1 << 32  # ... and a carry to pass
    want = [sum(int(cols[k, i]) << (32 * k) for k in range(rows)) for i in range(64)]
    words, carry = tfield._normalize(cols)
    assert int(words.max()) <= 0xFFFFFFFF and int(words.min()) >= 0
    assert [_rows_value(words, i) + (int(carry[i]) << (32 * rows)) for i in range(64)] == want


def _header_fields():
    """{id: (name, words, p words, 2p words, inv)} parsed from mont.cuh."""
    text = (Path(kernels.CSRC) / "mont.cuh").read_text()
    table = text[text.index("MODS[") :]
    out = {}
    for m in re.finditer(r"// field (\d+): (\w+), (\d+) words\s*\{\{([^}]*)\},\s*\{([^}]*)\},\s*(0x[0-9a-f]+)u", table):
        fid, name, words, p, p2, inv = m.groups()
        ints = [[int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", g)] for g in (p, p2)]
        out[int(fid)] = (name, int(words), *ints, int(inv, 16))
    enum = dict((k, int(v)) for k, v in re.findall(r"(\w+) = (\d+)", text[text.index("enum FieldId") :].split("}")[0]))
    words_of = re.search(r"words_of\(int f\) \{\s*return ([^;]*);", text).group(1)
    return out, enum, words_of


def test_header_constants_equal_field_specs():
    """Every modulus, 2p and -p^-1 mod 2^32 in csrc/mont.cuh, and the
    field ids and word counts, agree with FieldSpec and kernels.SPECS, so a
    typo there cannot pass as a kernel bug."""
    fields, enum, words_of = _header_fields()
    assert sorted(fields) == sorted(fid for fid, _ in kernels.SPECS.values())
    for name, (fid, words) in kernels.SPECS.items():
        spec = SPECS[name]
        hname, hwords, p, p2, inv = fields[fid]
        assert (hname, hwords, words) == (name, n_words(spec), n_words(spec))
        assert enum[name.upper()] == fid
        value = lambda ws: sum(w << (32 * k) for k, w in enumerate(ws))  # noqa: E731
        assert len(p) == len(p2) == words
        assert value(p) == spec.modulus and value(p2) == 2 * spec.modulus
        assert inv == -pow(spec.modulus, -1, 1 << 32) % (1 << 32)
        # words_of(f): the ternary chain of the header, read for this id
        cases = dict(re.findall(r"f == (\w+) \? (\d+)", words_of))
        default = int(words_of.rsplit(":", 1)[1])
        assert int(cases.get(name.upper(), default)) == words


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take only CUDA tensors; the Field sends CPU
    tensors to the plain versions and never to a wrapper."""
    before = dict(kernels.LAUNCHES)
    for spec in (BN254_FR, BLS12_381_FR, BLS12_377_FR, BW6_761_FR):
        a = torch.zeros((n_words(spec), 4), dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernels.field_binary("mul", spec, a, a)
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernels.butterfly(spec, a, a, a)
        Field(spec).mul(a, a)
    g = torch.zeros((12, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.curve_op("add", False, BLS12_381_FP, [g] * 6, [0] * 12)
    g = torch.zeros((24, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):  # G2 over Fp: 6 components, 24 words of 3b
        kernels.curve_op("add", True, BW6_761_FP, [g] * 6, [0] * 24)
    assert kernels.LAUNCHES == before


def test_kernels_refuse_fields_and_ops_without_kernels(monkeypatch):
    """A spec or op without a kernel is refused before any build, so this
    runs without nvcc: a made-up field, neg of a scalar field, add and sub
    of a base field under a G2 over Fp, NTT butterflies over a base field,
    the curve kernels over another field."""

    def no_build():
        raise AssertionError("nothing may be built")

    monkeypatch.setattr(kernels, "build", no_build)
    a = torch.zeros((12, 4), dtype=torch.int32)
    w = torch.zeros((20, 4), dtype=torch.int32)
    m = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="no CUDA kernels for field made_up_fp"):
        kernels.field_binary("mul", MADE_UP, m, m)
    with pytest.raises(ValueError, match="no CUDA kernels for field made_up_fp"):
        kernels.field_unary("from_mont", MADE_UP, m)
    with pytest.raises(ValueError, match="no CUDA kernel neg for field bls12_377_fr"):
        kernels.field_unary("neg", BLS12_377_FR, a[:8])
    with pytest.raises(ValueError, match="no CUDA kernel neg for field bls12_381_fr"):
        kernels.field_unary("neg", BLS12_381_FR, a[:9])
    # a base field adds and subtracts only in an Fp2 (or Fp4) inversion: none
    # over the BW6 curves'
    g = torch.zeros((24, 4), dtype=torch.int32)
    for op in ("add", "sub"):
        with pytest.raises(ValueError, match=f"no CUDA kernel {op} for field bw6_761_fp"):
            kernels.field_binary(op, BW6_761_FP, g, g)
        with pytest.raises(ValueError, match=f"no CUDA kernel {op} for field bw6_633_fp"):
            kernels.field_binary(op, BW6_633_FP, w, w)
        assert f"{op}[bw6_761_fp]" not in kernels.LAUNCHES and f"{op}[bls12_377_fp]" in kernels.LAUNCHES
        assert f"{op}[bw6_633_fp]" not in kernels.LAUNCHES and f"{op}[bls24_315_fp]" in kernels.LAUNCHES
    assert set(kernels.LAUNCHES) == {k for c in kernels.CURVES for k in kernels.instances(c)}
    with pytest.raises(ValueError, match="no NTT kernels"):
        kernels.butterfly(BLS12_381_FP, a, a, a)
    with pytest.raises(ValueError, match="no NTT kernels"):
        kernels.butterfly(BW6_761_FP, w, w, w)
    with pytest.raises(ValueError, match="no CUDA curve kernels over made_up_fp"):
        kernels.curve_op("add", True, MADE_UP, [m] * 6, [0] * 4)
    with pytest.raises(ValueError, match="no NTT kernels"):
        kernels.butterfly(BW6_633_FP, w, w, w)
    with pytest.raises(ValueError, match="expected 12 coordinate components"):  # G2 over Fp2
        kernels.curve_op("add", True, BLS12_377_FP, [a] * 6, [0] * 24)
    with pytest.raises(ValueError, match="expected 6 coordinate components"):  # G2 over Fp
        kernels.curve_op("add", True, BW6_761_FP, [w] * 12, [0] * 48)
    assert kernels.curve_of(BLS12_381_FP) == "bls12-381" and kernels.curve_of(MADE_UP) is None
    assert kernels.curve_of(BW6_633_FP) == "bw6-633" and kernels.curve_of(BLS24_317_FP) == "bls24-317"
    assert kernels.curve_of(BLS12_377_FP) == "bls12-377" and kernels.curve_of(BW6_761_FP) == "bw6-761"


def test_broadcast_shape_equals_torch_and_imports_no_sympy():
    """The field ops' broadcast of unequal operand shapes (a product by a
    row broadcast over a batch, as PLONK's quotient takes it) is
    torch.broadcast_shapes' without its first-call import of sympy, which
    took 3.5 s of a first PLONK prove on the card's host."""
    from tpusnark_torch.fields.tfield import broadcast_shape

    for a, b in (((8, 15, 7), (8, 1, 7)), ((8, 3, 1), (8, 1, 5)), ((8, 4), (8, 4)), ((2, 1), (3, 2, 5))):
        assert broadcast_shape(a, b) == torch.broadcast_shapes(a, b)
    with pytest.raises(ValueError, match="do not broadcast"):
        broadcast_shape((8, 3), (8, 4))
    code = (
        "import sys; import torch; from tpusnark_torch.fields.tfield import broadcast_shape; "
        "broadcast_shape((8, 15, 7), (8, 1, 7)); print('sympy' in sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
