"""Inclusive prefix scans along the last axis, the port's counterpart of
``jax.lax.associative_scan`` (which torch does not have).

A Hillis-Steele scan: ceil(log2 n) rounds, round s combining every element
with the one s places before it, out of place. ``comb(earlier, later)``
takes the earlier operand first, as jax's does: the affine maps of Horner's
rule and of synthetic division do not commute. On CUDA tensors each round is
one launch of each field kernel ``comb`` calls over up to n lanes (1 B1 for
a prefix product; 2 B1 and 1 add for an affine pair); on CPU tensors the
plain versions.

``horner_scan`` and ``div_linear`` are the two scans of KZG and the PLONK
prover (tpusnark/poly/kzg.py:div_by_linear_dev and
tpusnark/backend/plonk/prove.py:_horner_evals, _div_linear).
"""

from __future__ import annotations

import torch

from ..fields.tfield import Field


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def associative_scan(comb, elems):
    """Inclusive scan of `elems` (a tensor, or a tuple of tensors of one
    shape) along the last axis: out[..., i] = comb(...comb(x_0, x_1)...,
    x_i). comb takes and returns what elems is."""
    n = _leaves(elems)[0].shape[-1]
    tup = isinstance(elems, tuple)
    x = elems
    s = 1
    while s < n:
        lo = tuple(a[..., : n - s] for a in _leaves(x))
        hi = tuple(a[..., s:] for a in _leaves(x))
        c = _leaves(comb(lo, hi) if tup else comb(lo[0], hi[0]))
        x = tuple(torch.cat([a[..., :s], b], dim=-1) for a, b in zip(_leaves(x), c))
        if not tup:
            x = x[0]
        s *= 2
    return x


def prefix_mul(f: Field, x):
    """Inclusive prefix product along the last axis (Montgomery words)."""
    return associative_scan(f.mul, x)


def horner_scan(f: Field, coeffs, z_mont):
    """Horner's rule for every suffix of coeffs (words, *batch, n) Montgomery
    at z (a (words,) Montgomery constant): out[..., k] = the value after
    folding coefficients n-1 .. n-1-k, as the scan of the affine maps
    x -> z x + c_i from the top coefficient down. out[..., n-1] is p(z)."""
    zc = f.broadcast_const(z_mont, coeffs)

    def comb(e1, e2):  # e2 after e1: f2(f1(x))
        m1, a1 = e1
        m2, a2 = e2
        return f.mul(m1, m2), f.add(f.mul(m2, a1), a2)

    _ms, accs = associative_scan(comb, (zc, coeffs.flip(-1)))
    return accs


def horner_evals(f: Field, stack, z_mont):
    """Values at z of a batch of polynomials (words, *batch, m) Montgomery:
    (words, *batch) words."""
    return horner_scan(f, stack, z_mont)[..., -1]


def div_linear(f: Field, coeffs, z_mont):
    """Synthetic division by (X - z): coeffs (words, *batch, n) Montgomery ->
    (q (words, *batch, n-1), p(z) (words, *batch)), both Montgomery."""
    accs = horner_scan(f, coeffs, z_mont)
    n = coeffs.shape[-1]
    # q_{n-2-k} = accs[k] for k < n-1
    return accs[..., : n - 1].flip(-1), accs[..., n - 1]
