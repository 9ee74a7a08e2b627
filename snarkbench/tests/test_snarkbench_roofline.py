"""The MSM's least time (roofline.py) on worked cases."""

import random

import pytest
import torch

from snarkbench import roofline


def words(values, n_words=8):
    """(words, N) int32 words, least significant first, of `values`."""
    cols = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)] for v in values]
    return torch.tensor(cols, dtype=torch.int64).T.contiguous().to(torch.int32)


def plain_signed_digits(s, c, n_windows):
    """The signed-digit recoding of one int, window by window."""
    half, full, out, carry = 1 << (c - 1), 1 << c, [], 0
    for w in range(n_windows):
        d = ((s >> (c * w)) & (full - 1)) + carry
        carry = int(d > half)
        out.append(d - full if d > half else d)
    return out


def test_worked_case_of_digit_statistics():
    # 15 at c = 4: -1 with a carry, then 1; 8 stays 8 (the top of (-8, 8])
    assert roofline.signed_digit_stats(words([15]), 4, 8) == [(1, 1), (1, 1), (0, 0)]
    assert roofline.signed_digit_stats(words([8]), 4, 8) == [(1, 8), (0, 0), (0, 0)]
    assert roofline.signed_digit_stats(words([1, 2, 3]), 2, 2) == [(3, 2), (1, 1)]


@pytest.mark.parametrize("c", [2, 5, 13, 16, 20])
def test_digit_statistics_follow_the_plain_recoding(c):
    rng = random.Random(c)
    vals = [rng.randrange(1 << 254) for _ in range(40)] + [0, 1, (1 << 254) - 1]
    n_windows = -(-(254 + 1) // c)
    digits = [plain_signed_digits(v, c, n_windows) for v in vals]
    for v, ds in zip(vals, digits):
        assert sum(d << (c * w) for w, d in enumerate(ds)) == v
    want = [(sum(d[w] != 0 for d in digits), max(abs(d[w]) for d in digits)) for w in range(n_windows)]
    assert roofline.signed_digit_stats(words(vals), c, 254) == want


def test_worked_case_of_imads():
    # [1, 2, 3] at c = 2 over G1 (8 words): 4 mixed additions, the running
    # sums of window 0 (largest digit 2: 2 additions), one Horner addition
    # and c = 2 doublings
    stats = roofline.signed_digit_stats(words([1, 2, 3]), 2, 2)
    prods = 4 * (8 + 2) + 3 * (12 + 2) + 2 * (6 + 4)
    assert roofline.window_imads(stats, 2, 1, 8) == prods * (4 * 64 + 8) == 26928
    # over Fp2: a product is 3 Fp products, a square 2
    assert roofline.products(roofline.MADD, 2) == 8 * 3 + 2 * 2


def test_zero_and_one_scalars_cost_one_mixed_addition_each():
    vals = [0, 1, 1, 0, 1] * 20
    imads, _ = roofline.msm_least_imads(words(vals), 1, 8, 254)
    assert imads == 60 * 10 * roofline.mont_imads(8)
    assert roofline.msm_least_imads(words([0] * 7), 1, 8, 254)[0] == 0


def test_bytes_and_the_bound_that_binds():
    assert roofline.msm_bytes(1, 1, 8, 8) == 2 * 32 + 32 + 3 * 32
    assert roofline.msm_bytes(4, 2, 8, 8) == 4 * (2 * 64 + 32) + 3 * 64
    t, by = roofline.msm_least_seconds(words([0] * 64), 1, 8, 254)
    assert by == "bytes" and t == roofline.msm_bytes(64, 1, 8, 8) / roofline.HBM_BYTES_PER_S
    rng = random.Random(3)
    t, by = roofline.msm_least_seconds(words([rng.randrange(1 << 254) for _ in range(256)]), 1, 8, 254)
    assert by == "compute"


def test_the_cheapest_window_is_no_dearer_than_a_fixed_one():
    rng = random.Random(5)
    w = words([rng.randrange(1 << 254) for _ in range(512)])
    best, c = roofline.msm_least_imads(w, 1, 8, 254)
    for other in (4, 8, 16):
        assert best <= roofline.window_imads(roofline.signed_digit_stats(w, other, 254), other, 1, 8)
    assert c in roofline.C_RANGE
