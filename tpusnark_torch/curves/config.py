"""Curve configuration (the port's copy of tpusnark/curves/config.py): the
no-codegen analog of gnark's per-curve generated packages (reference
internal/generator/backend/main.go generates 8 copies of everything; here one
parametrized implementation closes over a CurveConfig).

A config bundles the field specs, the short-Weierstrass constants the device
kernels need, and the host (python-int) curve module used for setup ladders,
proof assembly, and pairings. The constants are literals equal to
tpusnark's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from ..fields.spec import (
    BLS12_377_FP,
    BLS12_377_FR,
    BLS12_381_FP,
    BLS12_381_FR,
    BLS24_315_FP,
    BLS24_315_FR,
    BLS24_317_FP,
    BLS24_317_FR,
    BN254_FP,
    BN254_FR,
    BW6_633_FP,
    BW6_633_FR,
    BW6_761_FP,
    BW6_761_FR,
    FieldSpec,
)

@dataclass(frozen=True)
class CurveConfig:
    name: str
    fr_spec: FieldSpec
    fp_spec: FieldSpec
    g1_b: int  # G1: y^2 = x^3 + b
    g2_b3: tuple  # (c0, c1): 3 * b'' of the twist, as Fp2 ints
    # Fp2 = Fp[u]/(u^2 + fp2_q): 1 for BN254/BLS12-381, 5 for BLS12-377
    fp2_q: int = 1
    # BW6-761/BW6-633: embedding degree 6, G2 is a sextic twist over Fp
    # ITSELF — G2 arithmetic is then G1-style FpArith with b = g2_b (no Fp2)
    g2_over_fp: bool = False
    g2_b: int = 0
    # BLS24-315/317: G2 over Fp4 = Fp2[v]/(v^2 - Z2), Fp2 = Fp[u]/(u^2 - A2)
    g2_fp4: bool = False
    fp4_a2: int = 0
    fp4_z2: tuple = ()
    g2_b3_fp4: tuple = ()  # 3*b' nested ((c00,c01),(c10,c11)) ints

    @property
    def host(self):
        """Host curve module: G1, G2, R, pairing helpers (python ints)."""
        if self.name == "bn254":
            from . import ref

            return ref
        if self.name == "bls12-381":
            from . import bls12381

            return bls12381
        if self.name == "bls12-377":
            from . import bls12377

            return bls12377
        if self.name == "bw6-761":
            from . import bw6761

            return bw6761
        if self.name == "bls24-315":
            from . import bls24315

            return bls24315
        if self.name == "bls24-317":
            from . import bls24317

            return bls24317
        if self.name == "bw6-633":
            from . import bw6633

            return bw6633
        raise ValueError(f"unknown curve {self.name}")


def _bn254_g2_b3() -> tuple:
    from .ref import XI, Fp2

    b2 = Fp2(3, 0) * XI.inv()
    b3 = b2 * 3
    return (b3.c0, b3.c1)


@lru_cache(maxsize=None)
def get_curve(name: str = "bn254") -> CurveConfig:
    if name == "bn254":
        return CurveConfig(
            name="bn254",
            fr_spec=BN254_FR,
            fp_spec=BN254_FP,
            g1_b=3,
            g2_b3=_bn254_g2_b3(),
        )
    if name == "bls12-381":
        # G1: y^2 = x^3 + 4; twist (M-type): y^2 = x^3 + 4(1+u) -> 3b = (12, 12)
        return CurveConfig(
            name="bls12-381",
            fr_spec=BLS12_381_FR,
            fp_spec=BLS12_381_FP,
            g1_b=4,
            g2_b3=(12, 12),
        )
    if name == "bls12-377":
        from .bls12377 import P as P377

        # G1: y^2 = x^3 + 1; twist (D-type): y^2 = x^3 + 1/u over u^2 = -5
        # 3/u = 3 * (-u/5) = (0, -3/5)
        inv5 = pow(5, -1, P377)
        return CurveConfig(
            name="bls12-377",
            fr_spec=BLS12_377_FR,
            fp_spec=BLS12_377_FP,
            g1_b=1,
            g2_b3=(0, (-3 * inv5) % P377),
            fp2_q=5,
        )
    if name == "bw6-761":
        return CurveConfig(
            name="bw6-761",
            fr_spec=BW6_761_FR,
            fp_spec=BW6_761_FP,
            g1_b=-1,  # y^2 = x^3 - 1; mul_b3 uses -3 via mul_const
            g2_b3=(),
            g2_over_fp=True,
            g2_b=4,
        )
    if name == "bls24-315":
        # G2 over Fp4 = Fp2[v]/(v^2 - (0, 1)), Fp2 = Fp[u]/(u^2 + 13)
        b3 = 0x28FF7DA12F9D5DCC0E79DC17DB91F4B01CAD2847EDF498C725F681318DC679ED9CBB2D836413B14
        return CurveConfig(
            name="bls24-315",
            fr_spec=BLS24_315_FR,
            fp_spec=BLS24_315_FP,
            g1_b=1,
            g2_b3=(),
            g2_fp4=True,
            fp4_a2=-13,
            fp4_z2=(0, 1),
            g2_b3_fp4=((0, 0), (0, b3)),
        )
    if name == "bls24-317":
        return CurveConfig(
            name="bls24-317",
            fr_spec=BLS24_317_FR,
            fp_spec=BLS24_317_FP,
            g1_b=4,
            g2_b3=(),
            g2_fp4=True,
            fp4_a2=-1,
            fp4_z2=(1, 1),
            g2_b3_fp4=((0, 0), (12, 0)),
        )
    if name == "bw6-633":
        return CurveConfig(
            name="bw6-633",
            fr_spec=BW6_633_FR,
            fp_spec=BW6_633_FP,
            g1_b=-7,  # y^2 = x^3 - 7; mul_b3 via mul_const
            g2_b3=(),
            g2_over_fp=True,
            g2_b=42,
        )
    raise ValueError(
        f"unknown curve {name} (supported: bn254, bls12-381, bls12-377, "
        f"bw6-761, bls24-315, bls24-317, bw6-633)"
    )
