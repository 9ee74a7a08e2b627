"""The port's field arithmetic (tpusnark_torch.fields.tfield, plain versions
on the CPU) against tpusnark's Field (JAX on the CPU) and Python ints, on
the same seeded inputs. Exact: values are compared as ints mod p."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.fields.jfield import Field as JField
from tpusnark.fields.spec import BN254_FP, BN254_FR
from tpusnark_torch import kernels
from tpusnark_torch.convert import limbs_to_words, words_to_limbs
from tpusnark_torch.fields.tfield import Field

SPECS = {"fr": BN254_FR, "fp": BN254_FP}
N = 48


def raw_values(p, seed):
    """Representatives in the lazy range [0, 2p): edge cases, then random."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    rand = [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(N - len(edge))]
    return edge + rand


def to_words(vals):
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    w = np.frombuffer(buf, dtype="<u4").reshape(-1, 8)
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32))


def both(spec, seed):
    """(port Field, tpusnark Field, raw ints, port tensor, tpusnark array)."""
    p = spec.modulus
    vals = raw_values(p, seed)
    t = to_words(vals)
    return Field(spec), JField(spec), vals, t, jnp.asarray(words_to_limbs(t))


def dec_port(f, t, mont=True):
    return f.decode(t, mont=mont)


def dec_jax(jf, a, mont=True):
    return jf.to_ints(np.asarray(a), mont=mont)


BINARY = {
    "add": lambda x, y, p: (x + y) % p,
    "sub": lambda x, y, p: (x - y) % p,
    "mul": lambda x, y, p: x * y % p,
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_matches_tpusnark(name, op):
    spec = SPECS[name]
    f, jf, xs, a, ja = both(spec, 1)
    _, _, ys, b, jb = both(spec, 2)
    p, rinv = spec.modulus, pow(spec.r, -1, spec.modulus)
    got = dec_port(f, getattr(f, op)(a, b))
    want_jax = dec_jax(jf, getattr(jf, op)(ja, jb))
    want = [BINARY[op](x * rinv, y * rinv, p) for x, y in zip(xs, ys)]
    assert got == want_jax == want


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("op", ["neg", "double", "square", "to_mont", "canon"])
def test_unary_matches_tpusnark(name, op):
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 3)
    assert dec_port(f, getattr(f, op)(a)) == dec_jax(jf, getattr(jf, op)(ja))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_from_mont_matches_tpusnark(name):
    spec = SPECS[name]
    f, jf, xs, a, ja = both(spec, 4)
    got = f.from_mont(a)
    # output <= p; p only for a representation of zero
    assert max(f.decode(got, mont=False)) < spec.modulus
    assert dec_port(f, got, mont=False) == dec_jax(jf, jf.from_mont(ja), mont=False)
    assert dec_port(f, got, mont=False) == [x * pow(spec.r, -1, spec.modulus) % spec.modulus for x in xs]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_lazy_range_and_words_agree_with_tpusnark(name):
    """mul/add/sub keep [0, 2p) and give the same representatives as
    tpusnark's limbs (R = 2^256 in both layouts)."""
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 5)
    _, _, _, b, jb = both(spec, 6)
    for op in ("mul", "add", "sub"):
        got = getattr(f, op)(a, b)
        assert np.array_equal(words_to_limbs(got), np.asarray(getattr(jf, op)(ja, jb)))
        vals = [int.from_bytes(words_to_limbs(got)[:, i].astype("<u2").tobytes(), "little") for i in range(N)]
        assert max(vals) < 2 * spec.modulus


@pytest.mark.parametrize("name", sorted(SPECS))
def test_inv_mul_const_is_zero_select(name):
    spec = SPECS[name]
    p = spec.modulus
    f, jf = Field(spec), JField(spec)
    xs = [0, 1, p - 1, 12345, 2**200 + 7]
    a, ja = f.encode(xs), jf.array(xs)
    assert dec_port(f, f.inv(a)) == dec_jax(jf, jf.inv(ja)) == [pow(x, -1, p) if x else 0 for x in xs]
    assert dec_port(f, f.mul_const(a, 9)) == dec_jax(jf, jf.mul_const(ja, 9))
    zero_p = to_words([0, p, 1, 2 * p - 1])
    assert f.is_zero(zero_p).tolist() == np.asarray(jf.is_zero(jnp.asarray(words_to_limbs(zero_p)))).tolist()
    cond = torch.tensor([True, False, True, False, False])
    assert dec_port(f, f.select(cond, a, f.neg(a))) == [x if c else (-x) % p for x, c in zip(xs, cond.tolist())]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_segment_sum_matches_tpusnark(name):
    spec = SPECS[name]
    f, jf, _, a, ja = both(spec, 7)
    ids = np.random.default_rng(8).integers(0, 5, size=N)
    got = f.segment_sum(a, torch.from_numpy(ids), 6, max_segment=N)
    want = jf.segment_sum(ja, jnp.asarray(ids), 6, max_segment=N)
    assert dec_port(f, got) == dec_jax(jf, want)


def test_encoding_round_trip_and_layout_conversion():
    f = Field(BN254_FR)
    xs = [0, 1, BN254_FR.modulus - 1, 2**255 % BN254_FR.modulus]
    t = f.encode(xs)
    assert t.dtype == torch.int32 and t.shape == (8, 4)
    assert f.decode(t) == xs
    limbs = BN254_FR.encode(xs).T  # tpusnark's (16, N) Montgomery limbs
    assert np.array_equal(limbs_to_words(limbs), t.numpy())
    assert np.array_equal(words_to_limbs(t), limbs)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take only CUDA tensors; the Field sends CPU
    tensors to the plain versions and never to a wrapper."""
    a = torch.zeros((8, 4), dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.field_binary("mul", BN254_FR, a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.butterfly(a, a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.curve_op("add", False, [a] * 6)
    Field(BN254_FR).mul(a, a)
    assert kernels.LAUNCHES == before
