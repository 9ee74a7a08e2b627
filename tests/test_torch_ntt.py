"""The port's NTT (tpusnark_torch.poly.ntt, plain butterflies on the CPU)
against tpusnark's NTT (JAX on the CPU), Domain.ntt_ref / intt_ref and the
round trip, over BN254 fr at n = 2^4 .. 2^7 and BLS12-381 fr (9 words,
2-adicity 32) at n = 2^3 .. 2^5: even k runs radix-4 stages only, odd k ends
on a radix-2 stage. The round trips are checked as well: a swapped radix-4
output in tpusnark's NTT was once caught by the round trip alone. Exact:
values are compared as ints mod p."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnark.fields.spec import BLS12_381_FR, BN254_FR
from tpusnark.poly.ntt import NTT as JNTT
from tpusnark_torch.convert import words_to_limbs
from tpusnark_torch.poly.ntt import get_ntt

SPECS = {"bn254": BN254_FR, "bls12-381": BLS12_381_FR}
CASES = [("bn254", n) for n in (16, 32, 64, 128)] + [("bls12-381", n) for n in (8, 16, 32)]
P = BN254_FR.modulus


def values(n, seed, p=P):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def both(n, spec=BN254_FR):
    t, j = get_ntt(spec, n), JNTT(spec, n)
    return t, j, t.field, j.field


@pytest.mark.parametrize("curve,n", CASES)
def test_ntt_intt_match_tpusnark_and_oracle(curve, n):
    spec = SPECS[curve]
    t, j, f, jf = both(n, spec)
    xs = values(n, n, spec.modulus)
    assert f.decode(t.ntt(f.encode(xs))) == jf.to_ints(j.ntt(jf.array(xs))) == t.domain.ntt_ref(xs)
    assert f.decode(t.intt(f.encode(xs))) == jf.to_ints(j.intt(jf.array(xs))) == t.domain.intt_ref(xs)


@pytest.mark.parametrize("curve,n", CASES)
def test_round_trips(curve, n):
    spec = SPECS[curve]
    t, _, f, _ = both(n, spec)
    xs = values(n, n + 1, spec.modulus)
    x = f.encode(xs)
    assert f.decode(t.intt(t.ntt(x))) == xs
    assert f.decode(t.ntt(t.intt(x))) == xs
    assert f.decode(t.intt_coset(t.ntt_coset(x))) == xs


@pytest.mark.parametrize("curve,n", [("bn254", 16), ("bn254", 128), ("bls12-381", 16)])
def test_coset_transforms_match_tpusnark(curve, n):
    spec = SPECS[curve]
    p = spec.modulus
    t, j, f, jf = both(n, spec)
    xs = values(n, n + 2, p)
    assert f.decode(t.ntt_coset(f.encode(xs))) == jf.to_ints(j.ntt_coset(jf.array(xs)))
    assert f.decode(t.intt_coset(f.encode(xs))) == jf.to_ints(j.intt_coset(jf.array(xs)))
    shift = t.domain.coset_shift
    want = [x * pow(shift, i, p) % p for i, x in enumerate(xs)]
    assert f.decode(t.coset_scale(f.encode(xs))) == want


def test_batched_rows_transform_independently():
    """(8, 3, n): each row of the batch is its own transform."""
    n = 32
    t, _, f, _ = both(n)
    rows = [values(n, 40 + r) for r in range(3)]
    x = f.encode([v for row in rows for v in row]).reshape(f.n, 3, n)
    got = f.decode(t.ntt(x))
    assert [got[r * n : (r + 1) * n] for r in range(3)] == [t.domain.ntt_ref(row) for row in rows]


def lazy_operands(k, n, seed, spec):
    """k flat (words, n) operands in [0, 2p), edge cases first."""
    rng = np.random.default_rng(seed)
    p, words = spec.modulus, get_ntt(spec, 2).field.n
    out = []
    for _ in range(k):
        vals = [0, 1, p - 1, p, p + 1, 2 * p - 1]
        vals += [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(n - len(vals))]
        buf = b"".join(v.to_bytes(4 * words, "little") for v in vals)
        w = np.frombuffer(buf, dtype="<u4").reshape(-1, words)
        out.append(torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)))
    return out


@pytest.mark.parametrize("curve", sorted(SPECS))
def test_butterflies_match_tpusnark_word_for_word(curve):
    """The plain versions of B3 and B4 give tpusnark's lazy representatives
    where the two R agree (BN254), and its values mod p where they do not
    (BLS12-381 fr: 2^288 against 2^272)."""
    spec = SPECS[curve]
    t, j = get_ntt(spec, 2), JNTT(spec, 2)
    ops = lazy_operands(7, 24, 5, spec)
    jops = [jnp.asarray(words_to_limbs(o, spec)) for o in ops]

    def same(got, want):
        if spec.n_limbs % 2 == 0:
            return np.array_equal(words_to_limbs(got, spec), np.asarray(want))
        return t.field.decode(got) == j.field.to_ints(want)

    for got, want in zip(t.butterfly(*ops[:3]), j._butterfly(*jops[:3])):
        assert same(got, want)
    for got, want in zip(t.butterfly4(*ops), j._butterfly4(*jops)):
        assert same(got, want)
