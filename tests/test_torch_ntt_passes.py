"""The NTT's passes and tables (tpusnark_torch.poly.ntt) against tpusnark's
NTT (JAX on the CPU) and Python ints, for the seven scalar fields: BN254,
BLS12-377 and BLS24-315 fr (8 words), BLS12-381 and BLS24-317 fr (9 words,
R = 2^288 against tpusnark's 2^272), BW6-633 fr (10 words) and BW6-761 fr (12
words).

- ``pass_plan`` covers the stages once, in order, within its cap;
- the plain passes (``ntt_stages_plain``, what the pass kernel computes on the
  card), composed under caps 1, 2, 3 and 7, give tpusnark's ntt and intt and
  the round trip; caps 1 and 2 put a pass of odd m at s0 > 0;
- the tables built by doubling equal the Python packed lists, tpusnark's
  packed tables and ``Domain.coset_powers``, and the bit-reversal built from
  an arange equals ``bit_reverse_perm``.

Exact: values are compared as ints mod p."""

import functools

import numpy as np
import pytest
import torch

from tpusnark.fields import spec as jspec
from tpusnark.poly.ntt import NTT as JNTT
from tpusnark_torch import kernels
from tpusnark_torch.fields import spec as tspec
from tpusnark_torch.poly.domain import bit_reverse_perm
from tpusnark_torch.poly.ntt import NTT, max_stages, pass_plan

torch.set_num_threads(1)  # the suite's workers fill the cores already

NAMES = ("BN254_FR", "BLS12_381_FR", "BLS12_377_FR", "BW6_761_FR", "BLS24_315_FR", "BLS24_317_FR", "BW6_633_FR")
CAPS = (1, 2, 3, 7)


def size(name):
    """2^7, or 2^5 for the 10- and 12-word fields."""
    return 1 << 5 if name in ("BW6_761_FR", "BW6_633_FR") else 1 << 7


@functools.lru_cache(maxsize=None)
def reference(name):
    """(values, tpusnark's ntt, tpusnark's intt, tpusnark's packed forward
    table) of one field at its size, as ints."""
    spec, n = getattr(jspec, name), size(name)
    rng = np.random.default_rng(n + len(name))
    xs = [int.from_bytes(rng.bytes(96), "little") % spec.modulus for _ in range(n)]
    j = JNTT(spec, n)
    jf = j.field
    a = jf.array(xs)
    return xs, jf.to_ints(j.ntt(a)), jf.to_ints(j.intt(a)), jf.to_ints(j._tw_fwd)


def run_passes(t, x, table, cap):
    """The bit-reverse gather, then the plain passes of pass_plan(k, cap)."""
    y = x.index_select(-1, t._bitrev)
    for s0, m in pass_plan(t.k, cap):
        y = t.ntt_stages_plain(y, table, s0, m)
    return y


def packed(t, base):
    """The packed twiddle table in Python ints, as tpusnark builds it."""
    p, n, out = t.spec.modulus, t.n, []
    for s in range(t.k):
        step = pow(base, n >> (s + 1), p)
        out += [pow(step, j, p) for j in range(1 << s)]
    return out


@pytest.mark.parametrize("cap", (1, 2, 3, 5, 7, 9, 11))
def test_pass_plan_covers_every_stage_once_in_order(cap):
    assert pass_plan(0, cap) == []
    for k in range(1, 25):
        plan = pass_plan(k, cap)
        assert [s for s0, m in plan for s in range(s0, s0 + m)] == list(range(k))
        sizes = [m for _, m in plan]
        assert len(plan) == -(-k // cap) and 1 <= min(sizes) and max(sizes) <= cap
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("name", NAMES)
def test_card_plan_is_three_passes_at_2_17_and_2_22(name):
    """A block holds 512 elements (16-24 KB) at every scalar field's width,
    so a pass runs up to 8 stages."""
    t = NTT(getattr(tspec, name), 8, "cpu")
    assert kernels.ntt_block_elems(t.field.n) == 512 and max_stages(t.field.n) == 8
    assert t.plan == [(0, 3)]
    assert pass_plan(17, 8) == [(0, 6), (6, 6), (12, 5)]
    assert pass_plan(22, 8) == [(0, 8), (8, 7), (15, 7)]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", NAMES)
def test_plain_passes_match_tpusnark(name, cap):
    xs, want_ntt, want_intt, _ = reference(name)
    t = NTT(getattr(tspec, name), size(name), "cpu")
    f = t.field
    plan = pass_plan(t.k, cap)
    assert (cap > 2) or any(m % 2 and s0 > 0 for s0, m in plan)
    x = f.encode(xs)
    y = run_passes(t, x, t._tw_fwd, cap)
    assert f.decode(y) == want_ntt
    n_inv = f.broadcast_const(t._n_inv, x)
    assert f.decode(f.mul(run_passes(t, x, t._tw_inv, cap), n_inv)) == want_intt
    assert f.decode(f.mul(run_passes(t, y, t._tw_inv, cap), n_inv)) == xs


def test_plain_passes_keep_batched_rows_apart():
    """(words, 3, n) under cap 2: each row is its own transform."""
    t = NTT(tspec.BN254_FR, 32, "cpu")
    f, p = t.field, t.spec.modulus
    rows = [[(r * 1000 + i) ** 5 % p for i in range(32)] for r in range(3)]
    x = f.encode([v for row in rows for v in row]).reshape(f.n, 3, 32)
    got = f.decode(run_passes(t, x, t._tw_fwd, 2))
    assert [got[r * 32 : (r + 1) * 32] for r in range(3)] == [t.domain.ntt_ref(row) for row in rows]


@pytest.mark.parametrize("name", ("BN254_FR", "BLS12_381_FR"))
def test_smallest_domains(name):
    """n = 1 (no stage), 2 (one radix-2 stage) and 4 (one radix-4 step)."""
    spec = getattr(tspec, name)
    for n in (1, 2, 4):
        t = NTT(spec, n, "cpu")
        f, p = t.field, spec.modulus
        xs = [(7 * i + 3) ** 3 % p for i in range(n)]
        x = f.encode(xs)
        assert t.plan == pass_plan(t.k, 8) == ([(0, t.k)] if n > 1 else [])
        assert f.decode(t.ntt(x)) == t.domain.ntt_ref(xs)
        assert f.decode(t.intt(t.ntt(x))) == xs
        assert f.decode(t.intt_coset(t.ntt_coset(x))) == xs


@pytest.mark.parametrize("name", NAMES)
def test_tables_built_by_doubling_match_python_lists(name):
    spec = getattr(tspec, name)
    t = NTT(spec, size(name), "cpu")
    f, d = t.field, t.domain
    fwd = packed(t, d.generator)
    assert f.decode(t._tw_fwd) == fwd == reference(name)[3]
    assert f.decode(t._tw_inv) == packed(t, d.generator_inv)
    cs, csi = t._coset_tables()
    assert f.decode(cs) == d.coset_powers(inv=False)
    assert f.decode(csi) == d.coset_powers(inv=True)
    assert f.decode(t.powers(d.generator, 1)) == [1]
    assert t._bitrev.tolist() == bit_reverse_perm(t.n).tolist()


def test_pass_kernel_wrapper_refuses_what_it_cannot_run(monkeypatch):
    """CPU tensors and a base field are refused before anything is built."""

    def no_build():
        raise AssertionError("nothing may be built")

    monkeypatch.setattr(kernels, "build", no_build)
    x = torch.zeros((8, 16), dtype=torch.int32)
    tw = torch.zeros((8, 15), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ntt_stages(tspec.BN254_FR, x, tw, 16, 0, 2)
    with pytest.raises(ValueError, match="no NTT kernels"):
        kernels.ntt_stages(tspec.BN254_FP, x, tw, 16, 0, 2)
    assert "ntt_stages[bn254_fr]" in kernels.instances("bn254")
