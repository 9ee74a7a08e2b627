"""In-circuit short-Weierstrass curve arithmetic over an emulated base field.

The std/algebra/emulated/sw_emulated analog (gnark/std/algebra/
emulated/sw_emulated/point.go): affine point add/double/scalar-mul for a
curve y^2 = x^3 + a x + b whose base field differs from the native SNARK
field, built on gadgets/emulated.py. Used for in-circuit secp256k1 (ECDSA)
and non-native BN254/BLS12-381 G1 work.

Scalar multiplication is the binary double-and-add over hint-supplied scalar
bits with complete-case handling via an accumulator initialized at a known
auxiliary point (avoids incomplete-addition traps at infinity, the same trick
sw_emulated uses with its "phi" tricks simplified away).

A frozen copy of tpusnark_torch/gadgets/sw_emulated.py for the benchmark's
reference compile: the same code, so that it emits the same constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

from .emulated import EmuElement, EmulatedField, EmuParams


@dataclass
class CurveSpec:
    p: int   # base field modulus
    a: int
    b: int
    gx: int
    gy: int
    order: int


SECP256K1 = CurveSpec(
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)


@dataclass
class EmuPoint:
    x: EmuElement
    y: EmuElement


class EmulatedCurve:
    def __init__(self, api, spec: CurveSpec, limb_bits: int = 64):
        self.api = api
        self.spec = spec
        self.F = EmulatedField(api, EmuParams.for_modulus(spec.p, limb_bits))

    # ------------------------------------------------------------- builders
    def constant_point(self, x: int, y: int) -> EmuPoint:
        return EmuPoint(self.F.constant(x), self.F.constant(y))

    def generator(self) -> EmuPoint:
        return self.constant_point(self.spec.gx, self.spec.gy)

    def from_limbs(self, x_limbs, y_limbs) -> EmuPoint:
        return EmuPoint(self.F.from_limbs(x_limbs), self.F.from_limbs(y_limbs))

    def assert_on_curve(self, P: EmuPoint):
        F = self.F
        lhs = F.mul(P.y, P.y)
        rhs = F.add(F.mul(F.mul(P.x, P.x), P.x), F.constant(self.spec.b))
        if self.spec.a:
            rhs = F.add(rhs, F.mul(F.constant(self.spec.a), P.x))
        F.assert_is_equal(lhs, rhs)

    # ----------------------------------------------------------- arithmetic
    def add_unsafe(self, P: EmuPoint, Q: EmuPoint) -> EmuPoint:
        """Incomplete affine addition: requires P.x != Q.x (the sw_emulated
        AddUnified precondition split; caller guarantees distinctness)."""
        F = self.F
        lam = F.div(F.sub(Q.y, P.y), F.sub(Q.x, P.x))
        xr = F.sub(F.sub(F.mul(lam, lam), P.x), Q.x)
        yr = F.sub(F.mul(lam, F.sub(P.x, xr)), P.y)
        return EmuPoint(xr, yr)

    def double(self, P: EmuPoint) -> EmuPoint:
        F = self.F
        num = F.mul(F.constant(3), F.mul(P.x, P.x))
        if self.spec.a:
            num = F.add(num, F.constant(self.spec.a))
        lam = F.div(num, F.mul(F.constant(2), P.y))
        xr = F.sub(F.sub(F.mul(lam, lam), P.x), P.x)
        yr = F.sub(F.mul(lam, F.sub(P.x, xr)), P.y)
        return EmuPoint(xr, yr)

    def neg(self, P: EmuPoint) -> EmuPoint:
        return EmuPoint(P.x, self.F.neg(P.y))

    def select(self, cond, P: EmuPoint, Q: EmuPoint) -> EmuPoint:
        """cond ? P : Q, limb-wise native selects."""
        api = self.api
        F = self.F

        def sel(a: EmuElement, b: EmuElement) -> EmuElement:
            a = F.reduce(a) if a.overflow else a
            b = F.reduce(b) if b.overflow else b
            return EmuElement(
                [api.select(cond, x, y) for x, y in zip(a.limbs, b.limbs)], 0
            )

        return EmuPoint(sel(P.x, Q.x), sel(P.y, Q.y))

    def scalar_mul(self, P: EmuPoint, scalar_bits) -> EmuPoint:
        """[s]P for s = Σ bits_i 2^i (bits boolean circuit vars, LSB first,
        s in (0, order) and the partial sums never collide — guaranteed for
        random-looking scalars; the hedge below shifts by an auxiliary point
        so accumulator never hits infinity for s != 0).

        Implementation: acc = AUX; acc += bit_i ? 2^i P : 0 via select on the
        added point is unsound with incomplete add when equal-x; instead use
        the standard trick acc = 2*acc + (bit ? P : -P) variant... we use the
        simplest sound ladder: D&A from MSB with an AUX offset:
            acc = AUX
            for bit from MSB..LSB: acc = 2 acc; if bit: acc = acc + P
            result = acc - [2^nbits mod ord] AUX? -- needs another mul.
        To stay simple AND sound we instead offset additively:
            acc = AUX + (bit_{n-1} ? P_{n-1} : 0) ... using select between
            (acc + 2^i P) and acc, where AUX guarantees x-coords differ
            w.h.p. (AUX independent of P). Completeness for adversarial
            collisions is out of scope, as in sw_emulated's fast path."""
        aux = self.constant_point(*self._aux_point())
        acc = aux
        cur = P
        for i, bit in enumerate(scalar_bits):
            cand = self.add_unsafe(acc, cur)
            acc = self.select(bit, cand, acc)
            if i + 1 < len(scalar_bits):
                cur = self.double(cur)
        return self.add_unsafe(acc, self.neg(aux))

    # ------------------------------------------------- complete (flagged) ops
    def zero_point(self) -> EmuPoint:
        """Canonical coordinates for the flagged identity: (0, 0). Not on
        the curve — only ever used behind a zero flag."""
        return EmuPoint(self.F.constant(0), self.F.constant(0))

    def add_unified(self, P: EmuPoint, Q: EmuPoint, pz=0, qz=0):
        """Complete flagged addition -> (R, rz). Handles P == Q (doubling),
        P == -Q (identity result), and identity operands via pz/qz flags
        (native booleans; 0 for known-nonzero points).

        Uses the Brier-Joye unified slope lam = (x1^2 + x1 x2 + x2^2 + a) /
        (y1 + y2), valid whenever y1 + y2 != 0 — one formula for both add
        and double. When y1 + y2 == 0 the slope is computed against a DUMMY
        denominator 1 through a fully-CONSTRAINED division (so a malicious
        witness cannot choose lam; a prior div_unchecked(0, 0) here left lam
        free while rz stayed 0 for the x1 != x2, y1 == -y2 case — reachable
        on p = 1 mod 3 curves via cube-root-of-unity x pairs) and the lane
        returns the flagged identity, exactly as the reference's
        sw_emulated.AddUnified does
        (gnark/std/algebra/emulated/sw_emulated/point.go:210-236)."""
        api, F = self.api, self.F
        x1, y1, x2, y2 = P.x, P.y, Q.x, Q.y
        ysum = F.add(y1, y2)
        bad = F.is_zero(ysum)
        num = F.add(F.add(F.mul(x1, x1), F.mul(x1, x2)), F.mul(x2, x2))
        if self.spec.a:
            num = F.add(num, F.constant(self.spec.a))
        num = F.select(bad, F.constant(0), num)
        den = F.select(bad, F.constant(1), ysum)
        # den != 0 on every lane, so den*lam == num pins lam uniquely:
        # div_unchecked is fully constrained here (and cheaper than div's
        # explicit inverse)
        lam = F.div_unchecked(num, den)
        xr = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        yr = F.sub(F.mul(lam, F.sub(x1, xr)), y1)
        Rc = EmuPoint(xr, yr)
        # result flags/coords: identity operands pass the other point
        # through; any live y1 + y2 == 0 lane (annihilation P == -Q, or
        # 2-torsion doubling, or the exotic equal-y-negated pair) yields the
        # flagged identity, mirroring the reference
        both_live = api.and_(api.sub(1, pz), api.sub(1, qz))
        rz = api.or_(api.and_(pz, qz), api.and_(both_live, bad))
        R = self.select(pz, Q, self.select(qz, P, Rc))
        R = self.select(rz, self.zero_point(), R)
        return R, rz

    def scalar_mul_flagged(self, P: EmuPoint, scalar_bits):
        """[s]P -> (R, rz) with rz = 1 when s == 0 (the case scalar_mul's
        final AUX subtraction would make unsatisfiable — advisor r3 medium:
        a zero scalar left acc == AUX and add_unsafe divided by zero)."""
        aux = self.constant_point(*self._aux_point())
        acc = aux
        cur = P
        for i, bit in enumerate(scalar_bits):
            cand = self.add_unsafe(acc, cur)
            acc = self.select(bit, cand, acc)
            if i + 1 < len(scalar_bits):
                cur = self.double(cur)
        # acc == AUX exactly when s == 0 (mod collisions, see scalar_mul
        # docstring); the unified subtraction turns that into a flag instead
        # of an unsatisfiable division
        return self.add_unified(acc, self.neg(aux))

    def _aux_point(self):
        """A fixed curve point unrelated to the generator (hash-to-curve by
        incrementing x until on curve, computed at circuit-build time)."""
        p, a, b = self.spec.p, self.spec.a, self.spec.b
        x = 0x1234567890ABCDEF
        while True:
            rhs = (x * x * x + a * x + b) % p
            y = pow(rhs, (p + 1) // 4, p) if p % 4 == 3 else _sqrt_mod(rhs, p)
            if y is not None and (y * y) % p == rhs:
                return x, y
            x += 1

    def assert_equal(self, P: EmuPoint, Q: EmuPoint):
        self.F.assert_is_equal(P.x, Q.x)
        self.F.assert_is_equal(P.y, Q.y)


def _sqrt_mod(a: int, p: int):
    """Tonelli-Shanks (general p)."""
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # full Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        bexp = pow(c, 1 << (m - i - 1), p)
        m, c = i, bexp * bexp % p
        t, r = t * c % p, r * bexp % p
    return r


# --------------------------------------------------------------------- ECDSA
def ecdsa_verify(api, curve: EmulatedCurve, pub: EmuPoint,
                 u1_bits, u2_bits, r_value_limbs):
    """Low-level ECDSA check (the std/signature/ecdsa PublicKey.Verify shape,
    gnark/std/signature/ecdsa/ecdsa.go): checks

        R' = [u1]G + [u2]Q,  u1 = H(m) s^-1,  u2 = r s^-1  (mod order)
        R'.x mod order == r

    The scalar arithmetic mod the curve ORDER (u1, u2) happens outside in a
    second EmulatedField instance (the order field); this function takes the
    u1/u2 bit decompositions (already constrained) plus r as order-field
    limbs and performs the curve side.
    """
    G = curve.generator()
    p1 = curve.scalar_mul(G, u1_bits)
    p2 = curve.scalar_mul(pub, u2_bits)
    R = curve.add_unsafe(p1, p2)

    # R.x mod order == r. Base-field x is canonical (< p_base < 2*order for
    # secp256k1), so x mod order is x or x - order: hint the borrow bit w and
    # the order-field limbs xq, then pin the INTEGER identity
    #     x == xq + w*order
    # with the modulus-agnostic carry check, plus xq canonical in the order
    # field. Unique representation => sound.
    ordv = curve.spec.order
    Fq = EmulatedField(api, EmuParams.for_modulus(ordv, curve.F.pr.limb_bits))
    rx = R.x
    rx = curve.F.reduce(rx) if rx.overflow else rx
    curve.F._assert_lt_modulus(rx)
    assert curve.spec.p < 2 * ordv, "x mod order needs at most one subtraction"
    kq, wbits = Fq.pr.n_limbs, Fq.pr.limb_bits
    mask = (1 << wbits) - 1
    order_limbs = [(ordv >> (wbits * i)) & mask for i in range(kq)]

    def mod_order_hint(p, ins):
        v = curve.F.pr.recompose(ins)
        w = 1 if v >= ordv else 0
        x = v - w * ordv
        return [w] + [(x >> (wbits * i)) & mask for i in range(kq)]

    outs = api.new_hint(mod_order_hint, 1 + kq, *rx.limbs)
    w_bit, xq_limbs = outs[0], outs[1:]
    api.assert_is_boolean(w_bit)
    xq = Fq.from_limbs(xq_limbs)
    Fq._assert_lt_modulus(xq)
    rhs = [api.add(xq_limbs[i], api.mul(w_bit, order_limbs[i])) for i in range(kq)]
    curve.F._assert_int_eq(rx.limbs, rhs,
                           lhs_bound=wbits + 1, rhs_bound=wbits + 1)
    r_el = Fq.from_limbs(r_value_limbs)
    Fq.assert_is_equal(xq, r_el)
    return True


def ecdsa_verify_sig(api, curve: EmulatedCurve, pub: EmuPoint,
                     msg_hash_limbs, r_limbs, s_limbs):
    """Full ECDSA signature check (std/signature/ecdsa Verify): the scalar
    side (u1 = H s^-1, u2 = r s^-1 mod order) runs in an order-field
    EmulatedField; bit-decomposed u1/u2 feed the curve-side check."""
    Fq = EmulatedField(api, EmuParams.for_modulus(curve.spec.order,
                                                  curve.F.pr.limb_bits))
    w = Fq.pr.limb_bits
    h = Fq.from_limbs(msg_hash_limbs)
    r = Fq.from_limbs(r_limbs)
    s = Fq.from_limbs(s_limbs)
    s_inv = Fq.inverse(s)
    u1 = Fq.mul(h, s_inv)
    u2 = Fq.mul(r, s_inv)

    def to_bits(el):
        bits = []
        for limb in el.limbs:
            bits.extend(api.to_binary(limb, w))
        return bits

    return ecdsa_verify(api, curve, pub, to_bits(u1), to_bits(u2), r_limbs)
