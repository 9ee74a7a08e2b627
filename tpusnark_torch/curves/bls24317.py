"""BLS24-317 host oracle (see bls24.make_bls24 for the construction).

Reference counterpart: gnark/constraint/bls24-317 +
backend/{groth16,plonk}/bls24-317 (generated). The reference carries no
in-repo copy of this curve's p/r (emparams covers only -315), so the
derivation is self-verified: standard seed x = 0xd9018000,
r = x^8 - x^4 + 1 (255 bits, prime), p = (x-1)^2 r / 3 + x (317 bits,
prime). Tower: u^2 = -1 (p = 3 mod 4), v^2 = 1 + u (Z2 = (1, 1));
G1: y^2 = x^3 + 4 (M-twist b' = 4v). Generators are cofactor-cleared
first curve points (scripts/derive_curves.py), verified in
tests/test_bls24_bw6633.py.

The port's copy of tpusnark/curves/bls24317.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .bls24 import make_bls24

X_SEED = 0xD9018000

_ns = make_bls24(
    x_seed=X_SEED,
    a2=-1,
    z2=(1, 1),
    b1=4,
    twist_d=False,
    g1_gen=(
        0x325C2B065C4FAC86D1140C27F7335CACB7D5C0542CAE9E790B8A1290570A39CA25FFAEF7F1DA1F7,
        0xD36905751ED0A0A6ED5BE98E6DEA71B1CEDCF90A58520F759969F78F8E4869D520BE99896B34778,
    ),
    g2_gen=(
        (
            (
                28498404142312365002533744693556861244212064443103687717510540998257508853975496760832205123607,
                104881342316154169720140745551267577558255475983798552134082689646705436288255501236462500135051,
            ),
            (
                134208762611471838850128095341317427866582025424914361408168906642550705688378271974920859507485,
                47807860684290705153036437491997319116342330273104493957877398921782737166446662055996604784294,
            ),
        ),
        (
            (
                44876622315766850812681130347627310514575969188140746255032704761456545716435375984336202932103,
                122944399713280725351686091941976614797388330955066702928204857252202077653689729168051526719362,
            ),
            (
                134412165438479452938217513489307018910461401545588316579557188157637351159431752634595130675564,
                2029692032238824705354193561169987024400536695462697107520882566708882764596624317925532647859,
            ),
        ),
    ),
    name="bls24-317",
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
