"""The port's NTT (tpusnark_torch.poly.ntt, plain butterflies on the CPU)
against tpusnark's NTT (JAX on the CPU), Domain.ntt_ref / intt_ref and the
round trip, at n = 2^4 .. 2^7: even k runs radix-4 stages only, odd k ends
on a radix-2 stage. The round trips are checked as well: a swapped radix-4
output in tpusnark's NTT was once caught by the round trip alone. Exact:
values are compared as ints mod p."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.fields.spec import BN254_FR
from tpusnark.poly.ntt import NTT as JNTT
from tpusnark_torch.convert import words_to_limbs
from tpusnark_torch.poly.ntt import get_ntt

P = BN254_FR.modulus
SIZES = [16, 32, 64, 128]


def values(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def both(n):
    t, j = get_ntt(BN254_FR, n), JNTT(BN254_FR, n)
    return t, j, t.field, j.field


@pytest.mark.parametrize("n", SIZES)
def test_ntt_intt_match_tpusnark_and_oracle(n):
    t, j, f, jf = both(n)
    xs = values(n, n)
    assert f.decode(t.ntt(f.encode(xs))) == jf.to_ints(j.ntt(jf.array(xs))) == t.domain.ntt_ref(xs)
    assert f.decode(t.intt(f.encode(xs))) == jf.to_ints(j.intt(jf.array(xs))) == t.domain.intt_ref(xs)


@pytest.mark.parametrize("n", SIZES)
def test_round_trips(n):
    t, _, f, _ = both(n)
    xs = values(n, n + 1)
    x = f.encode(xs)
    assert f.decode(t.intt(t.ntt(x))) == xs
    assert f.decode(t.ntt(t.intt(x))) == xs
    assert f.decode(t.intt_coset(t.ntt_coset(x))) == xs


@pytest.mark.parametrize("n", [16, 128])
def test_coset_transforms_match_tpusnark(n):
    t, j, f, jf = both(n)
    xs = values(n, n + 2)
    assert f.decode(t.ntt_coset(f.encode(xs))) == jf.to_ints(j.ntt_coset(jf.array(xs)))
    assert f.decode(t.intt_coset(f.encode(xs))) == jf.to_ints(j.intt_coset(jf.array(xs)))
    shift = t.domain.coset_shift
    want = [x * pow(shift, i, P) % P for i, x in enumerate(xs)]
    assert f.decode(t.coset_scale(f.encode(xs))) == want


def test_batched_rows_transform_independently():
    """(8, 3, n): each row of the batch is its own transform."""
    n = 32
    t, _, f, _ = both(n)
    rows = [values(n, 40 + r) for r in range(3)]
    x = f.encode([v for row in rows for v in row]).reshape(8, 3, n)
    got = f.decode(t.ntt(x))
    assert [got[r * n : (r + 1) * n] for r in range(3)] == [t.domain.ntt_ref(row) for row in rows]


def lazy_operands(k, n, seed):
    """k flat (8, n) operands in [0, 2p), edge cases first."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        vals = [0, 1, P - 1, P, P + 1, 2 * P - 1]
        vals += [int.from_bytes(rng.bytes(32), "little") % (2 * P) for _ in range(n - len(vals))]
        buf = b"".join(v.to_bytes(32, "little") for v in vals)
        w = np.frombuffer(buf, dtype="<u4").reshape(-1, 8)
        out.append(torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)))
    return out


def test_butterflies_match_tpusnark_word_for_word():
    """The plain versions of B3 and B4 give tpusnark's lazy representatives."""
    t, j = get_ntt(BN254_FR, 2), JNTT(BN254_FR, 2)
    ops = lazy_operands(7, 24, 5)
    jops = [jnp.asarray(words_to_limbs(o)) for o in ops]
    for got, want in zip(t.butterfly(*ops[:3]), j._butterfly(*jops[:3])):
        assert np.array_equal(words_to_limbs(got), np.asarray(want))
    for got, want in zip(t.butterfly4(*ops), j._butterfly4(*jops)):
        assert np.array_equal(words_to_limbs(got), np.asarray(want))
