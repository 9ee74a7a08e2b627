"""The yardstick's peaks and the least time of an MSM on one H100.

Peaks (NVIDIA H100 80GB HBM3, SXM, 700 W):
- memory: 3.35e12 bytes/s, NVIDIA's data sheet;
- 32-bit integer multiply-adds: 16.75e12/s. Not a data-sheet figure: it is
  derived as 132 SMs x 64 IMAD a clock x ~1.98 GHz (the boost clock), the
  integer rate of compute capability 9.0. The port's field products are
  chains of IMADs (``mad.lo`` / ``madc.hi``), so this is their ceiling.

An MSM's least time is the larger of two bounds, computed from sizes and the
scalars alone, never from the port's code:
- bytes: every base (affine coordinates) and every scalar read once, the
  result (a projective point) written once, over the memory rate;
- compute: the IMADs of a signed-digit windowed bucket method over the IMAD
  rate. For a window of c bits it does one mixed addition per nonzero digit
  of each scalar, then in each window that has a nonzero digit the running
  sums over its buckets (2 (m - 1) additions, m the window's largest digit),
  then the Horner combination of the windows (c doublings and one addition a
  window below the top one). The cost model takes the c in C_RANGE that
  needs the fewest IMADs for these very scalars, so a port that chooses
  another window, or skips zero digits, still needs at least this much.
  Additions are counted at the cheapest formulas known for y^2 = x^3 + b in
  XYZZ coordinates (EFD): a mixed addition 8M + 2S, an addition 12M + 2S, a
  doubling 6M + 4S; over Fp2 a product is 3 Fp products (Karatsuba) and a
  square 2. A Montgomery product of W 32-bit words costs 4 W^2 + W IMADs
  (``mont_imads``: 2 W^2 word products, each a low and a high half, and the
  W low halves of the reduction factor).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
C_RANGE = range(2, 21)

# Fp products of one (M, S) pair of the group's coordinate field: G1 over
# Fp, G2 over Fp2
_PRODUCTS = {1: (1, 1), 2: (3, 2)}
# (M, S) of the XYZZ formulas
MADD, ADD, DBL = (8, 2), (12, 2), (6, 4)


def mont_imads(words: int) -> int:
    """32-bit IMADs of one Montgomery product of `words` words."""
    return 4 * words * words + words


def products(op: tuple[int, int], degree: int) -> int:
    """Fp products of one group operation (M, S) with coordinates over an
    extension of `degree` (1: Fp, 2: Fp2)."""
    m, s = _PRODUCTS[degree]
    return op[0] * m + op[1] * s


def signed_digit_stats(scalars, c: int, bits: int):
    """Per window of c bits, from the least significant: (nonzero digits,
    largest |digit|) of the signed-digit recoding (digits in (-2^(c-1),
    2^(c-1)], a carry into the next window) of `scalars`, a torch tensor
    (words, N) of 32-bit words (uint32 bit patterns in any integer dtype),
    least significant word first, each scalar below 2^bits. Computed where
    the tensor lies."""
    import torch

    u = scalars.to(torch.int64) & 0xFFFFFFFF
    n_windows = -(-(bits + 1) // c)
    half, full, mask = 1 << (c - 1), 1 << c, (1 << c) - 1
    carry = torch.zeros_like(u[0])
    out = []
    for w in range(n_windows):
        k, r = divmod(w * c, 32)
        d = u[k] >> r if k < u.shape[0] else torch.zeros_like(u[0])
        if r + c > 32 and k + 1 < u.shape[0]:
            d = d | (u[k + 1] << (32 - r))
        d = (d & mask) + carry
        neg = d > half
        mag = torch.where(neg, full - d, d)
        carry = neg.to(torch.int64)
        out.append((int((mag != 0).sum()), int(mag.max()) if mag.numel() else 0))
    return out


def window_imads(stats, c: int, degree: int, fp_words: int) -> int:
    """IMADs of the bucket method at window c over the digit statistics of
    one MSM (``signed_digit_stats``)."""
    madds = sum(nz for nz, _ in stats)
    adds = sum(2 * (m - 1) for _, m in stats if m > 1)
    live = [w for w, (nz, _) in enumerate(stats) if nz]
    top = live[-1] if live else 0
    adds += top  # Horner: one addition and c doublings a window below the top
    dbls = c * top
    prods = madds * products(MADD, degree) + adds * products(ADD, degree) + dbls * products(DBL, degree)
    return prods * mont_imads(fp_words)


def msm_least_imads(scalars, degree: int, fp_words: int, bits: int) -> tuple[int, int]:
    """(IMADs, c) of the cheapest window for these scalars."""
    best = None
    for c in C_RANGE:
        imads = window_imads(signed_digit_stats(scalars, c, bits), c, degree, fp_words)
        if best is None or imads < best[0]:
            best = (imads, c)
    return best


def msm_bytes(n_points: int, degree: int, fp_words: int, fr_words: int) -> int:
    """Bytes read and written once: N affine bases (2 coordinates of degree
    Fp elements), N scalars, one projective result (3 coordinates)."""
    fp_bytes = 4 * fp_words * degree
    return n_points * (2 * fp_bytes + 4 * fr_words) + 3 * fp_bytes


def msm_least_seconds(scalars, degree: int, fp_words: int, bits: int) -> tuple[float, str]:
    """(least seconds, the bound that binds: "compute" or "bytes") of one
    MSM of these scalars (words, N) on one H100."""
    imads, _c = msm_least_imads(scalars, degree, fp_words, bits)
    t_ops = imads / IMAD_PER_S
    t_bytes = msm_bytes(scalars.shape[1], degree, fp_words, scalars.shape[0]) / HBM_BYTES_PER_S
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "bytes")
