"""Batched scalar multiplication on the device (counterpart of
tpusnark/curves/batch_mul.py): ``FixedBaseMul``, used by Groth16 setup, and
``VarBaseMul``, used by the MPC ceremony (``backend/groth16/mpcsetup.py``).

FixedBaseMul: the base is fixed, so the 2^k * G ladder is built once on the
host from the curve's host module (``CurveConfig.host``), and the device runs
one complete mixed add per scalar bit over the whole scalar vector.
tpusnark selects between acc and acc + 2^k G after the add; here lanes whose
bit is 0 are the add's infinity lanes, which return acc unchanged: the same
result, in one kernel launch (B5) per bit.

VarBaseMul: lane i computes s_i * P_i, MSB first: per scalar bit one
complete doubling (B6, ``double`` = ``add(acc, acc)``) and one complete mixed
add of P_i (B5) whose infinity mask is ``bit == 0 | inf``, so that a lane
keeps acc where tpusnark selects it back: two launches a bit.
"""

from __future__ import annotations

import functools

import torch

from ..fields.tfield import Field
from ..msm.pippenger import tree_map
from .config import get_curve
from .encoding import g2_to_device, g4_to_device
from .tcurve import CurveOps


class FixedBaseMul:
    """Bound to (ops, scalar field, scalar bits). Call with a ladder table."""

    def __init__(self, ops: CurveOps, fr: Field, n_bits: int | None = None):
        self.ops = ops
        self.fr = fr
        self.n_bits = n_bits or fr.modulus.bit_length()

    def __call__(self, table_xy, scalars_norm):
        """table_xy: (X, Y) coordinates with trailing axis n_bits (the 2^k * G
        ladder, never infinity); scalars_norm: (words, N) normal-form words
        (bit k is bit k % 32 of word k // 32, for any word count).
        Returns projective points with batch N."""
        ops = self.ops
        tX, tY = table_xy
        n = scalars_norm.shape[-1]
        u = scalars_norm.to(torch.int64) & 0xFFFFFFFF
        acc = ops.identity_like(
            tree_map(lambda a: torch.zeros((a.shape[0], n), dtype=a.dtype, device=a.device), tX)
        )
        for k in range(self.n_bits):
            skip = ((u[k // 32] >> (k % 32)) & 1) == 0
            pt = tree_map(lambda a: a[:, k : k + 1], (tX, tY))
            acc = ops.add_mixed(acc, pt + (skip,))
        return acc


class VarBaseMul:
    """Batched variable-base scalar multiplication, bound to (ops, scalar
    field, scalar bits): the device analog of the MPC ceremony's per-point
    rescale of the SRS (gnark's scaleG1InPlace/scaleG2InPlace,
    gnark/backend/groth16/bn254/mpcsetup/utils.go:83-102)."""

    def __init__(self, ops: CurveOps, fr: Field, n_bits: int | None = None):
        self.ops = ops
        self.fr = fr
        self.n_bits = n_bits or fr.modulus.bit_length()

    def __call__(self, points_affine, scalars_norm):
        """points_affine: (X, Y, inf) with batch N; scalars_norm: (words, N)
        normal-form words (bit k is bit k % 32 of word k // 32). Returns
        projective points with batch N, on the points' device."""
        ops = self.ops
        X, Y, inf = points_affine
        u = scalars_norm.to(torch.int64) & 0xFFFFFFFF
        acc = ops.identity_like(X)
        for k in reversed(range(self.n_bits)):
            skip = (((u[k // 32] >> (k % 32)) & 1) == 0) | inf
            acc = ops.add_mixed(ops.double(acc), (X, Y, skip))
        return acc


@functools.lru_cache(maxsize=8)
def _ladder_host(group: str, n_bits: int, curve: str):
    """2^k * generator for k < n_bits, python ints."""
    host = get_curve(curve).host
    G = host.G1 if group == "g1" else host.G2
    out, p = [], G.generator()
    for _ in range(n_bits):
        out.append(p)
        p = G.double(p)
    return out


def g1_generator_ladder(fp: Field, n_bits: int, curve: str, device="cpu"):
    """(X, Y) tensors with trailing axis n_bits."""
    pts = _ladder_host("g1", n_bits, curve)
    return (
        fp.encode([pt[0] for pt in pts], device=device),
        fp.encode([pt[1] for pt in pts], device=device),
    )


def g2_generator_ladder(fp: Field, n_bits: int, curve: str, device="cpu"):
    """(X, Y) with trailing axis n_bits, each coordinate as the curve's G2
    ops hold it: one tensor (G2 over Fp, the BW6 curves), (c0, c1) over Fp2,
    ((c00, c01), (c10, c11)) over Fp4 (the BLS24 curves)."""
    pts = _ladder_host("g2", n_bits, curve)
    if isinstance(pts[0][0], int):  # G2 over Fp: the G1 layout
        return (
            fp.encode([pt[0] for pt in pts], device=device),
            fp.encode([pt[1] for pt in pts], device=device),
        )
    X, Y, _ = (g4_to_device if get_curve(curve).g2_fp4 else g2_to_device)(pts, fp, device)
    return (X, Y)
