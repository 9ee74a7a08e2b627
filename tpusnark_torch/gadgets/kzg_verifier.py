"""In-circuit KZG opening verifier: the std/commitments/kzg analog.

Reference: gnark/std/commitments/kzg/verifier.go — verify a KZG
opening proof inside a circuit. Same single-G2-constant rearrangement as the
host verifier (poly/kzg.py:168):

    e(C - y*[1]_1 + z*H, [1]_2) * e(-H, [tau]_2) == 1

so only G1-side scalar multiplications are needed (emulated double-and-add
driven by native opening-point/value scalars); the two G2 points are SRS
constants.  Built on gadgets/pairing.py + gadgets/sw_emulated.py.

The port's copy of tpusnark/gadgets/kzg_verifier.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .pairing import G1Point, PairingGadget
from .recursion import BN254_G1
from .sw_emulated import EmulatedCurve, EmuPoint


class KZGVerifier:
    def __init__(self, api, limb_bits: int = 64):
        self.api = api
        self.pg = PairingGadget(api, limb_bits)
        self.curve = EmulatedCurve(api, BN254_G1, limb_bits)
        self.curve.F = self.pg.F

    def g1_var(self, pt) -> G1Point:
        """Adopt a host affine G1 point as circuit values."""
        return self.pg.g1_point(*pt)

    def assert_opening(self, g2_pair, commitment: G1Point, z, y, proof: G1Point):
        """Constrain: `commitment` opens to value `y` at point `z` with
        quotient `proof`. g2_pair = ([1]_2, [tau]_2) host constants (SRS.g2);
        z and y are NATIVE circuit variables (fr scalars)."""
        api, curve, pg = self.api, self.curve, self.pg
        nbits = BN254_G1.order.bit_length()
        # flagged scalar muls: y == 0 or z == 0 are legitimate openings
        # (advisor r3 medium — the unflagged ladder was unsatisfiable there)
        yG, yz = curve.scalar_mul_flagged(curve.generator(), api.to_binary(y, nbits))
        zH, zz = curve.scalar_mul_flagged(
            EmuPoint(proof.x, proof.y), api.to_binary(z, nbits)
        )
        C = EmuPoint(commitment.x, commitment.y)
        t, t_z = curve.add_unified(C, curve.neg(yG), 0, yz)
        lhs, lhs_z = curve.add_unified(t, zH, t_z, zz)
        # lhs == O would mean C - y[1] + zH = O; the affine pairing gadget
        # cannot take the identity — constrain it away (honest openings of a
        # nonzero commitment never hit it)
        api.assert_is_equal(lhs_z, 0)
        neg_proof = G1Point(proof.x, pg.F.neg(proof.y))
        pg.pairing_check(
            [
                (G1Point(lhs.x, lhs.y), pg.g2_point(*g2_pair[0])),
                (neg_proof, pg.g2_point(*g2_pair[1])),
            ]
        )
