"""The EIP-196 ECADD precompile as a circuit: a frozen copy of ``bn_g1``,
``ecadd`` and ``BN254_G1`` from ``tpusnark_torch/gadgets/evmprecompiles.py``
and ``gadgets/recursion.py`` (gnark std/evmprecompiles/06-bnadd.go), for the
benchmark's reference compile."""

from __future__ import annotations

from ..bn254 import P as BN_FP
from ..bn254 import R as BN_FR
from .sw_emulated import CurveSpec, EmulatedCurve, EmuPoint

BN254_G1 = CurveSpec(p=BN_FP, a=0, b=3, gx=1, gy=2, order=BN_FR)


def bn_g1(api, limb_bits: int = 64) -> EmulatedCurve:
    return EmulatedCurve(api, BN254_G1, limb_bits)


def ecadd(api, curve: EmulatedCurve, P: EmuPoint, Q: EmuPoint):
    """BN254 G1 addition with complete edge-case handling (06-bnadd.go)."""
    R, rz = curve.add_unified(P, Q)
    return R, rz
