"""The port's typed polynomial (tpusnark_torch.poly.iop.Polynomial, on the
CPU) through tests/test_iop.py's cases — basis and layout round trips, the
lazy shift, pointwise arithmetic and mixed layouts — against the host oracle
(Domain.ntt_ref, Horner in Python ints) and against tpusnark's Polynomial
on the same seeded coefficients. Exact: values are compared as ints mod p."""

import random

import pytest
import torch

from tpusnark.fields.spec import BN254_FR as JBN254_FR
from tpusnark.poly.iop import Polynomial as JPolynomial
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.poly.domain import Domain, bit_reverse_perm
from tpusnark_torch.poly.iop import Basis, Layout, Polynomial

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus
N = 32


@pytest.fixture(scope="module")
def coeffs():
    rng = random.Random(7)
    return [rng.randrange(P) for _ in range(N)]


def poly(values):
    return Polynomial.from_ints(values, BN254_FR, device="cpu")


def _horner(cs, x):
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % P
    return acc


def test_canonical_lagrange_roundtrip(coeffs):
    dom = Domain(BN254_FR, N)
    lag = poly(coeffs).to_lagrange()
    assert lag.basis is Basis.LAGRANGE and lag.data.device.type == "cpu"
    assert lag.to_ints() == dom.ntt_ref(coeffs)
    assert lag.to_canonical().to_ints() == coeffs
    assert lag.to_ints() == JPolynomial.from_ints(coeffs, JBN254_FR).to_lagrange().to_ints()


def test_lagrange_coset_roundtrip(coeffs):
    cos = poly(coeffs).to_lagrange_coset()
    assert cos.basis is Basis.LAGRANGE_COSET
    dom = Domain(BN254_FR, N)
    evs = cos.to_ints()
    for i in [0, 1, 5, N - 1]:
        assert evs[i] == _horner(coeffs, dom.coset_shift * dom.powers[i] % P)
    assert cos.to_canonical().to_ints() == coeffs
    assert evs == JPolynomial.from_ints(coeffs, JBN254_FR).to_lagrange_coset().to_ints()


def test_layout_roundtrip(coeffs):
    p = poly(coeffs).to_lagrange()
    br = p.to_bit_reverse()
    assert br.layout is Layout.BIT_REVERSE
    regular = p.to_ints()
    assert br.to_ints() == [regular[j] for j in bit_reverse_perm(N)]
    assert br.to_regular().to_ints() == regular


def test_lazy_shift(coeffs):
    dom = Domain(BN254_FR, N)
    p = poly(coeffs).to_lagrange()
    s = p.shift(3)
    assert s.shift_k == 3  # lazy: no data movement yet
    evs = s.to_ints()
    for i in [0, 2, N - 1]:
        assert evs[i] == _horner(coeffs, dom.powers[(i + 3) % N])
    assert s.shift(N - 3).to_ints() == p.to_ints()
    # q(x) = p(w^3 x), so q(1) = p(w^3)
    assert s.to_canonical().evaluate(1) == _horner(coeffs, dom.powers[3])
    assert evs == JPolynomial.from_ints(coeffs, JBN254_FR).to_lagrange().shift(3).to_ints()


def test_pointwise_ops(coeffs):
    rng = random.Random(8)
    other = [rng.randrange(P) for _ in range(N)]
    a, b = poly(coeffs).to_lagrange(), poly(other).to_lagrange()
    prod = a.mul(b)
    dom = Domain(BN254_FR, N)
    for i in [0, 7]:
        x = dom.powers[i]
        assert prod.to_ints()[i] == _horner(coeffs, x) * _horner(other, x) % P
    assert a.add(b).sub(b).to_ints() == a.to_ints()
    assert a.scale(5).to_ints() == [v * 5 % P for v in a.to_ints()]


def test_mixed_layout_alignment(coeffs):
    a = poly(coeffs).to_lagrange()
    b = a.to_bit_reverse()
    assert a.add(b).to_ints() == a.scale(2).to_ints()
    assert b.add(a).to_bit_reverse().to_ints() == b.scale(2).to_ints()
