"""The card's Montgomery arithmetic (tpusnark_torch/csrc/mont.cuh) as a word
by word model, and the field layer's launch operands.

(a) A Python model of the kernels' schedule: the product's two accumulators
(even and odd words of a row, after Emmart and Weems) and the REDC of
from_mont, on 32-bit words with the PTX carry flag (mad.lo.cc, madc.hi.cc,
addc, ...). Where the source ends a chain on an instruction that does not
set the flag, the model asserts that the carry it drops is 0. The model is
held against tpusnark's Field (JAX on the CPU) for all fourteen specs, on the
edge values and on seeded random lazy words: word for word where the port's
R = 2^(32 words) is tpusnark's (an even limb count), by value for the two
17-limb specs (BLS12-381 and BLS24-317 fr, R = 2^288 against 2^272), and
word for word against the port's plain versions and (T + m p)/R in Python
integers for all of them.
(b) Field.mul by a broadcast constant and Field.from_mont of a column slice
(compute_h_dev's h[:, : n - 1]) equal tpusnark on the CPU.
(c) On the card's path, Field hands the kernel wrappers views: a constant as
a stride-0 view of its own words, a column slice with its row stride; it
copies neither (the wrappers are faked, as the card is absent here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.fields.jfield import Field as JField
from tpusnark_torch import kernels
from tpusnark_torch.convert import words_to_limbs
from tpusnark_torch.fields import spec as port_specs
from tpusnark_torch.fields import tfield
from tpusnark_torch.fields.tfield import Field
from tpusnark.fields import spec as jax_specs

torch.set_num_threads(1)  # the suite's workers fill the cores already

M32 = 0xFFFFFFFF
NAMES = sorted(kernels.SPECS)


def jspec(name):
    return getattr(jax_specs, name.upper())


# ---------------------------------------------------------------- the model
class Chain:
    """32-bit PTX integer arithmetic with the carry flag CC."""

    def __init__(self):
        self.cc = 0

    def _put(self, s, cin, cout):
        s += self.cc if cin else 0
        if cout:
            self.cc = s >> 32
        else:
            assert s >> 32 == 0, "a chain's last instruction dropped a carry"
        return s & M32

    def mad_lo(self, a, b, c, cin=False, cout=True):
        return self._put((a * b & M32) + c, cin, cout)

    def mad_hi(self, a, b, c, cin=False, cout=True):
        return self._put((a * b >> 32) + c, cin, cout)

    def add(self, a, b, cin=False, cout=True):
        return self._put(a + b, cin, cout)


def model_mul(a, b, p, inv, n):
    """mont.cuh's mul_unrolled on word lists a, b (little-endian, n words)."""
    pw = [(p >> (32 * k)) & M32 for k in range(n)]
    cc = Chain()

    def reduce_row(e, o):
        m = e[0] * inv & M32
        for j in range(1, n, 2):  # odd words of p into o
            o[j - 1] = cc.mad_lo(m, pw[j], o[j - 1], cin=j > 1)
            o[j] = cc.mad_hi(m, pw[j], o[j], cin=True, cout=j != n - 1)
        if n % 2:
            o[n - 1] = cc.add(o[n - 1], 0, cin=True, cout=False)
        for j in range(0, n, 2):  # even words of p into e
            e[j] = cc.mad_lo(m, pw[j], e[j], cin=j > 0)
            e[j + 1] = cc.mad_hi(m, pw[j], e[j + 1], cin=True, cout=j + 1 != n)
        if n % 2 == 0:
            e[n] = cc.add(e[n], 0, cin=True, cout=False)
        assert e[0] == 0

    e, o = [0] * (n + 1), [0] * n
    for j in range(n):  # row 0: the products alone
        lo, hi = a[j] * b[0] & M32, a[j] * b[0] >> 32
        if j % 2 == 0:
            e[j], e[j + 1] = lo, hi
        else:
            o[j - 1], o[j] = lo, hi
    reduce_row(e, o)
    for i in range(1, n):
        bi, e2, o2 = b[i], [0] * (n + 1), [0] * n
        e2[0] = cc.add(o[0], e[1])
        for j in range(1, n, 2):
            o2[j - 1] = cc.mad_lo(a[j], bi, e[j + 1], cin=True)
            top = j + 2 > n
            o2[j] = cc.mad_hi(a[j], bi, 0 if top else e[j + 2], cin=True, cout=not top)
        if n % 2:
            o2[n - 1] = cc.add(0, 0, cin=True, cout=False)
        e2[0] = cc.mad_lo(a[0], bi, e2[0])
        e2[1] = cc.mad_hi(a[0], bi, o[1], cin=True)
        for j in range(2, n, 2):
            e2[j] = cc.mad_lo(a[j], bi, o[j], cin=True)
            top = j + 1 == n
            e2[j + 1] = cc.mad_hi(a[j], bi, 0 if top else o[j + 1], cin=True, cout=not top)
        if n % 2 == 0:
            e2[n] = cc.add(0, 0, cin=True, cout=False)
        reduce_row(e2, o2)
        e, o = e2, o2
    r = [cc.add(e[1], o[0])]
    r += [cc.add(e[k + 1], o[k], cin=True) for k in range(1, n - 1)]
    r.append(cc.add(e[n], o[n - 1], cin=True, cout=False))
    return r


def model_redc(a, p, inv, n):
    """mont.cuh's redc: n rounds of m = t0 inv, t = (t + m p) / 2^32."""
    pw = [(p >> (32 * k)) & M32 for k in range(n)]
    cc = Chain()
    t = list(a) + [0]
    for _ in range(n):
        m = t[0] * inv & M32
        for j in range(n):
            t[j] = cc.mad_lo(m, pw[j], t[j], cin=j > 0)
        t[n] = cc.add(t[n], 0, cin=True, cout=False)
        for j in range(n):
            t[j + 1] = cc.mad_hi(m, pw[j], t[j + 1], cin=j > 0, cout=j + 1 < n)
        assert t[0] == 0
        t = t[1:] + [0]
    return t[:n]


def words(x, n):
    return [(x >> (32 * k)) & M32 for k in range(n)]


def value(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


def lazy_values(p, n, seed, count=48):
    """Edge values, words of all ones below 2p, then seeded values in [0, 2p)."""
    rng = np.random.default_rng(seed)
    ones = [(1 << (32 * k)) - 1 for k in range(1, n + 1) if (1 << (32 * k)) - 1 < 2 * p]
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1] + ones
    return edge + [int.from_bytes(rng.bytes(4 * n), "little") % (2 * p) for _ in range(count)]


def to_tensor(vals, n):
    return torch.from_numpy(np.array([words(v, n) for v in vals], dtype=np.uint32).T.copy().view(np.int32))


def jax_words(arr, n):
    """tpusnark's (limbs, N) output as the port's n-word lists (even limb
    counts: the same bits)."""
    limbs = np.asarray(arr).astype(np.uint64)
    vals = [sum(int(limbs[k, i]) << (16 * k) for k in range(limbs.shape[0])) for i in range(limbs.shape[1])]
    return [words(v, n) for v in vals]


def operands(name):
    """(xs, ys): each edge value against 0, 1, p - 1, p, p + 1 and 2p - 1 on
    either side, then seeded pairs. Both tests of tpusnark below use these
    lane counts, so its compiled functions are shared."""
    p, (fid, n) = jspec(name).modulus, kernels.SPECS[name]
    vals = lazy_values(p, n, seed=fid)
    edge = vals[: len(vals) - 48]
    pairs = [q for x in edge for y in edge[:6] for q in ((x, y), (y, x))] + list(zip(vals, reversed(vals)))
    return [x for x, _ in pairs], [y for _, y in pairs]


@pytest.mark.parametrize("name", NAMES)
def test_carry_chain_model_equals_tpusnark_word_for_word(name):
    spec = jspec(name)
    pspec = getattr(port_specs, name.upper())
    _, n = kernels.SPECS[name]
    p, R = spec.modulus, 1 << (32 * n)
    inv = -pow(p, -1, 1 << 32) % (1 << 32)
    xs, ys = operands(name)
    pairs = list(zip(xs, ys))
    got = [model_mul(words(x, n), words(y, n), p, inv, n) for x, y in pairs]
    red = [model_redc(words(x, n), p, inv, n) for x in xs]
    # (T + m p) / R in Python integers, m = -T p^-1 mod R
    pinv = pow(p, -1, R)
    assert [value(g) for g in got] == [(x * y + (-x * y * pinv % R) * p) // R for x, y in pairs]
    assert [value(r) for r in red] == [(x + (-x * pinv % R) * p) // R for x in xs]
    assert max(value(g) for g in got) < 2 * p and max(value(r) for r in red) <= p
    # the port's plain versions, word for word
    f = Field(pspec)
    a, b = to_tensor(xs, n), to_tensor(ys, n)
    assert got == [words(v, n) for v in _ints(f.mul(a, b))]
    assert red == [words(v, n) for v in _ints(f.from_mont(a))]
    # tpusnark
    jf = JField(spec)
    ja, jb = (jnp.asarray(words_to_limbs(t, pspec)) for t in (a, b))
    jprod, jred = jf.mul(ja, jb), jf.from_mont(ja)
    if spec.n_limbs % 2 == 0:
        assert got == jax_words(jprod, n)
        assert red == jax_words(jred, n)
    else:  # another R: the same values
        rinv = f.r_inv
        assert [value(g) * rinv % p for g in got] == jf.to_ints(jprod)
        assert [value(r) % p for r in red] == jf.to_ints(jred, mont=False)


def _ints(t):
    w = t.numpy().view(np.uint32).astype(object)
    return [sum(int(w[k, i]) << (32 * k) for k in range(w.shape[0])) for i in range(w.shape[1])]


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr", "bw6_761_fp"])
def test_redc_of_any_word_below_r_is_at_most_p(name):
    """from_mont takes any input below R (reduce_columns gives it the low
    words of a wide sum): the model's REDC stays at most p, and is p only for
    a multiple of p."""
    spec = jspec(name)
    _, n = kernels.SPECS[name]
    p, R = spec.modulus, 1 << (32 * n)
    inv = -pow(p, -1, 1 << 32) % (1 << 32)
    rng = np.random.default_rng(3)
    xs = [R - 1, R - 2, R - p, (R - 1) // p * p, 3 * p, 2 * p] + [
        int.from_bytes(rng.bytes(4 * n), "little") for _ in range(32)
    ]
    for x in xs:
        r = value(model_redc(words(x, n), p, inv, n))
        assert r == x * pow(R, -1, p) % p or (r == p and x % p == 0)
        assert r <= p
    f = Field(getattr(port_specs, name.upper()))
    assert [value(words(v, n)) for v in _ints(f.from_mont(to_tensor(xs, n)))] == [
        value(model_redc(words(x, n), p, inv, n)) for x in xs
    ]


# ------------------------------------------------- broadcast and strided
@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr"])
def test_broadcast_product_and_column_slice_equal_tpusnark(name):
    """mul by one constant for every lane (NTT.intt's 1/n, compute_h_dev's
    1/Z_H, reduce_columns' R^2) and from_mont of h[:, : n - 1] equal
    tpusnark's on the CPU."""
    pspec, spec = getattr(port_specs, name.upper()), jspec(name)
    f, jf = Field(pspec), JField(spec)
    n, p = f.n, spec.modulus
    xs, ys = operands(name)
    lanes = len(xs)  # the lane count of the test above: its tpusnark functions are compiled
    h = to_tensor(xs + ys[:1], n)  # one lane more, sliced off as compute_h_dev does
    cols = h[:, :lanes]
    c = f.const(123456789, mont=True)
    prod = f.mul(cols, f.broadcast_const(c, cols))
    red = f.from_mont(cols)
    assert prod.shape == red.shape == cols.shape and cols.stride() == (lanes + 1, 1)
    jh = jnp.asarray(words_to_limbs(h, pspec))[:, :lanes]
    jc = jf.array([123456789] * lanes)
    jprod, jred = jf.mul(jh, jc), jf.from_mont(jh)
    if spec.n_limbs % 2 == 0:
        assert [words(v, n) for v in _ints(prod)] == jax_words(jprod, n)
        assert [words(v, n) for v in _ints(red)] == jax_words(jred, n)
    else:
        assert f.decode(prod) == jf.to_ints(jprod)
        assert f.decode(red, mont=False) == jf.to_ints(jred, mont=False)
    assert f.decode(prod) == [x * f.r_inv * 123456789 % p for x in xs]


class _Recorder:
    """Stands in for the kernel wrappers: records the operands a launch would
    get and answers with the plain version."""

    def __init__(self, field):
        self.field, self.calls = field, []

    def binary(self, op, spec, a, b):
        self.calls.append((op, a, b))
        return getattr(self.field, f"{op}_plain")(a.contiguous(), b.contiguous())

    def unary(self, op, spec, a):
        self.calls.append((op, a))
        return getattr(self.field, f"{op}_plain")(a.contiguous())


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_377_fp"])
def test_field_hands_the_kernels_views_not_copies(name, monkeypatch):
    """On the card's path a broadcast constant reaches the wrapper as a
    stride-0 view of the constant's own words, a column slice as a view with
    the parent's row stride, a full operand as itself: nothing is copied
    before a launch."""
    f = Field(getattr(port_specs, name.upper()))
    rec = _Recorder(f)
    monkeypatch.setattr(kernels, "field_binary", rec.binary)
    monkeypatch.setattr(kernels, "field_unary", rec.unary)
    monkeypatch.setattr(tfield, "_device_kind", lambda *ts: "cuda")
    n, lanes = f.n, 16
    h = to_tensor(lazy_values(f.modulus, n, seed=5)[:lanes], n)
    assert h.shape == (n, lanes)
    c = f.const(7, mont=True)
    want = f.mul_plain(h, f.broadcast_const(c, h).contiguous())

    got = f.mul(h, f.broadcast_const(c, h))
    op, a, b = rec.calls[-1]
    assert op == "mul" and a.data_ptr() == h.data_ptr() and a.stride() == (lanes, 1)
    assert b.shape == (n, lanes) and b.stride() == (1, 0) and b.data_ptr() == c.data_ptr()
    assert torch.equal(got, want)

    got = f.mul(f.broadcast_const(c, h), h)  # the constant first
    _, a, b = rec.calls[-1]
    assert a.stride() == (1, 0) and a.data_ptr() == c.data_ptr() and b.data_ptr() == h.data_ptr()
    assert torch.equal(got, want)

    seeds = to_tensor([1, 2, 3, 4], n)  # a column of a wider table: word stride 4
    f.mul(h, f.broadcast_const(seeds[:, 2], h))
    _, _, b = rec.calls[-1]
    assert b.stride() == (4, 0) and b.data_ptr() == seeds[:, 2].data_ptr()

    batched = h.reshape(n, 2, lanes // 2)  # a batch axis: still one element
    f.mul(batched, f.broadcast_const(c, batched))
    _, a, b = rec.calls[-1]
    assert a.shape == b.shape == (n, lanes) and b.stride() == (1, 0) and a.data_ptr() == h.data_ptr()

    cols = h[:, : lanes - 1]
    got = f.from_mont(cols)
    op, a = rec.calls[-1]
    assert op == "from_mont" and a.data_ptr() == h.data_ptr() and a.stride() == (lanes, 1)
    assert a.shape == (n, lanes - 1) and got.shape == cols.shape
    assert torch.equal(got, f.from_mont_plain(cols.contiguous()))
    assert all(t.dim() == 2 for call in rec.calls for t in call[1:])
