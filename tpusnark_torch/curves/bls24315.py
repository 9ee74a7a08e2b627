"""BLS24-315 host oracle (see bls24.make_bls24 for the construction).

Reference counterpart: gnark/constraint/bls24-315 +
backend/{groth16,plonk}/bls24-315 (generated); p and r cross-checked
against the reference's emparams.go:262-283. Seed x = -0xbfcfffff,
r = x^8 - x^4 + 1 (253 bits), p = (x-1)^2 r / 3 + x (315 bits).
Tower: u^2 = -13, v^2 = u (Z2 = (0, 1)); G1: y^2 = x^3 + 1 (D-twist
b' = 1/v). Generators are cofactor-cleared first curve points
(scripts/derive_curves.py), verified in tests/test_bls24_bw6633.py.

The port's copy of tpusnark/curves/bls24315.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .bls24 import make_bls24

X_SEED = -0xBFCFFFFF

_ns = make_bls24(
    x_seed=X_SEED,
    a2=-13,
    z2=(0, 1),
    b1=1,
    twist_d=True,
    g1_gen=(
        0x41A0A424393988DA1B2B117076EF6E4F54B344CC46DDE3C983603A832CB638DBF4B721710866097,
        0x1DB41C65FA7D730B1787B9B0E50ABC428EAA3907979126E6E51FCD4B43A054900BEE02965E1B1A2,
    ),
    g2_gen=(
        (
            (
                10548799017953747641832683325064176275688654356634004663179232325741866970143020243545088720369,
                11043470086782381002096438686592681029145863073861940565929264465798651207053373511207354345761,
            ),
            (
                681384484837912909846779291478534534113906104066705025585762943428161626586628139085565028134,
                33611221079950230273582327886494723828381429853864910328561682482942046322811365847590011132775,
            ),
        ),
        (
            (
                10180104897528946346300747341937411235246433508682541302709836041479932832046450222235182439918,
                7257654969871795767324108003568186085359533891878365847517782752769072497650007256004123434012,
            ),
            (
                11517287352152263112495502097196575219007001003489947622363682959681088747163282999266994697018,
                28529785756943899415762070658358344573656310448020771256268004584258260355249111865085760527896,
            ),
        ),
    ),
    name="bls24-315",
)

P = _ns.P
R = _ns.R
A2 = _ns.A2
Z2 = _ns.Z2
B2 = _ns.B2
B3_NEST = _ns.B3_NEST
Fp2 = _ns.Fp2
Fp4 = _ns.Fp4
Fp24 = _ns.Fp24
fp4 = _ns.fp4
G1 = _ns.G1
G2 = _ns.G2
G1_GEN = _ns.G1_GEN
G2_GEN = _ns.G2_GEN
miller_loop = _ns.miller_loop
final_exp = _ns.final_exp
pairing = _ns.pairing
multi_pairing = _ns.multi_pairing
gt_one = _ns.gt_one
