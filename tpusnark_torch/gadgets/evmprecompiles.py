"""In-circuit EVM precompiles: the std/evmprecompiles analog.

Reference: gnark/std/evmprecompiles/ — circuit gadgets matching
the EVM precompiled contracts so zk-EVMs can prove EVM execution:

  0x01 ECRECOVER   (ecrecover,  01-ecrecover.go)
  0x02 SHA256      (sha256,     02-sha256.go — delegates to std/hash/sha2)
  0x04 IDENTITY    (identity,   04-id.go)
  0x05 MODEXP      (expmod,     05-expmod.go)
  0x06 BN254 ADD   (ecadd,      06-bnadd.go)
  0x07 BN254 MUL   (ecmul,      07-bnmul.go)
  0x08 BN254 PAIR  (ecpairing,  08-bnpairing.go)

Built on this framework's existing gadget stack (sw_emulated for curve
arithmetic, emulated for field towers, pairing for the BN254 pairing,
sha2 for hashing); this module contributes the precompile SEMANTICS:
operand conventions, subgroup/range preconditions, and for ecrecover the
public-key recovery equation Q = r^-1 (s R - h G).

The port's copy of tpusnark/gadgets/evmprecompiles.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from .emulated import EmulatedField, EmuParams
from .pairing import PairingGadget
from .recursion import BN254_G1
from .sw_emulated import SECP256K1, CurveSpec, EmulatedCurve, EmuPoint


# -------------------------------------------------------------- 0x01 ecrecover
def ecrecover(api, msg_hash_limbs, v, r_limbs, s_limbs, limb_bits: int = 64):
    """Recover the secp256k1 public key from a signature (EVM semantics,
    reference 01-ecrecover.go): given h, v in {0, 1} (y parity), r, s,
    return Q = r^-1 (s R - h G) as an EmuPoint, where R = (r, y_v).

    The y coordinate of R enters by hint and is constrained on-curve with
    the requested parity; r, s are range-checked to (0, order) by the
    emulated-field adoption. Strict low-s (EIP-2) is NOT enforced, like the
    reference's default."""
    curve = EmulatedCurve(api, SECP256K1, limb_bits)
    F = curve.F  # base field
    Fq = EmulatedField(api, EmuParams.for_modulus(SECP256K1.order, limb_bits))
    w = Fq.pr.limb_bits
    p = SECP256K1.p
    q = SECP256K1.order

    h = Fq.from_limbs(msg_hash_limbs)
    r = Fq.from_limbs(r_limbs)
    s = Fq.from_limbs(s_limbs)

    # R = (r, y): y hinted, constrained by y^2 = r^3 + 7 and parity(v)
    def y_hint(pmod, ins):
        rv = 0
        for i, limb in enumerate(ins[: len(r_limbs)]):
            rv += int(limb) << (w * i)
        parity = int(ins[len(r_limbs)]) & 1
        rhs = (rv * rv * rv + 7) % p
        y = pow(rhs, (p + 1) // 4, p)
        if (y * y) % p != rhs:
            return [0] * len(r_limbs)  # not a valid r: caller's constraints fail
        if y & 1 != parity:
            y = p - y
        return [(y >> (w * i)) & ((1 << w) - 1) for i in range(len(r_limbs))]

    y_limbs = api.new_hint(y_hint, len(r_limbs), *r_limbs, v)
    # r is also a BASE-field element here (r < order < p for secp256k1)
    rx = F.from_limbs(r_limbs)
    R = EmuPoint(rx, F.from_limbs(y_limbs))
    curve.assert_on_curve(R)
    # parity constraint: lowest limb's low bit == v
    y_bits = api.to_binary(y_limbs[0], w)
    api.assert_is_equal(y_bits[0], v)

    # scalars u1 = -h / r, u2 = s / r mod order;  Q = u1 G + u2 R
    r_inv = Fq.inverse(r)
    u1 = Fq.mul(Fq.sub(Fq.constant(0), h), r_inv)
    u2 = Fq.mul(s, r_inv)

    def bits(el):
        el = Fq.reduce(el) if el.overflow else el
        out = []
        for limb in el.limbs:
            out.extend(api.to_binary(limb, w))
        return out

    t1, z1 = curve.scalar_mul_flagged(curve.generator(), bits(u1))
    t2, z2 = curve.scalar_mul_flagged(R, bits(u2))
    Q, qz = curve.add_unified(t1, t2, z1, z2)
    # recovered key must not be the identity (EVM returns failure there)
    api.assert_is_equal(qz, 0)
    return Q


# ----------------------------------------------------------------- 0x02 sha256
def sha256(api, byte_vars):
    """SHA-256 over byte variables (reference 02-sha256.go -> std/hash/sha2)."""
    from .sha2 import sha256_of_bytes

    return sha256_of_bytes(api, byte_vars)


# --------------------------------------------------------------- 0x04 identity
def identity(api, values):
    """The datacopy precompile (reference 04-id.go): a no-op passthrough."""
    return list(values)


# ----------------------------------------------------------------- 0x05 expmod
def expmod(api, base_limbs, exp_bits, modulus: int, limb_bits: int = 64):
    """base^exp mod `modulus` for a CIRCUIT-constant modulus and a
    bit-decomposed exponent (reference 05-expmod.go operates on fixed
    4096-bit operands; here the modulus is a compile-time int — the common
    zk-EVM deployment — and the exponent enters as boolean vars, LSB
    first). Square-and-multiply over the emulated field."""
    F = EmulatedField(api, EmuParams.for_modulus(modulus, limb_bits))
    base = F.from_limbs(base_limbs)
    acc = F.constant(1)
    cur = base
    for i, bit in enumerate(exp_bits):
        mul_acc = F.mul(acc, cur)
        acc = F.select(bit, mul_acc, acc)
        if i + 1 < len(exp_bits):
            cur = F.mul(cur, cur)
    return acc


# ------------------------------------------------------- 0x06/0x07 bn254 add/mul
def bn_g1(api, limb_bits: int = 64) -> EmulatedCurve:
    curve = EmulatedCurve(api, BN254_G1, limb_bits)
    return curve

def ecadd(api, curve: EmulatedCurve, P: EmuPoint, Q: EmuPoint):
    """BN254 G1 addition with complete edge-case handling (06-bnadd.go)."""
    R, rz = curve.add_unified(P, Q)
    return R, rz


def ecmul(api, curve: EmulatedCurve, P: EmuPoint, scalar_bits):
    """BN254 G1 scalar mul (07-bnmul.go); returns (point, is_zero flag)."""
    return curve.scalar_mul_flagged(P, scalar_bits)


# -------------------------------------------------------------- 0x08 bnpairing
def ecpairing(api, pairs, limb_bits: int = 64):
    """Assert prod e(P_i, Q_i) == 1 over BN254 (08-bnpairing.go): the EVM
    precompile's accept condition. pairs: [(G1Point, G2Point)] gadget
    points (see gadgets.pairing)."""
    pg = PairingGadget(api, limb_bits)
    pg.pairing_check(pairs)
    return pg
