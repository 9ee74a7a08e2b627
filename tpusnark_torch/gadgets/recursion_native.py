"""Native 2-chain Groth16 recursion: verify a BLS12-377 proof INSIDE a
BW6-761 circuit with native (non-emulated) field arithmetic.

This is the reference's production recursion path
(gnark/std/algebra/native/sw_bls12377/pairing.go +
std/recursion/groth16/verifier.go:36-40 instantiated over it): BW6-761's
scalar field equals BLS12-377's base field, so every pairing/tower op here
is 1 constraint per Fp mul — roughly two orders of magnitude cheaper per
operation than the emulated-BN254-in-BN254 verifier (gadgets/recursion.py).

Pairing check (same equation as backend/groth16/verify.py):

    e(-Ar, Bs) * e(alpha, beta) * e(kSum, gamma) * e(Krs, delta) == 1

Realized as: f = miller(-Ar, Bs) * miller(kSum, gamma) * miller(Krs, delta)
then final_exp_3h(f) == const, with const = host-precomputed
(e(alpha, beta)^-1)^(3h) — the fixed-argument pair folds into a constant
because the final exponentiation is a homomorphism.

The Miller loop runs on the twist: T stays in affine Fp2, slopes come from
hint inversions, and each line l = -y_P + (m x_P) w + (y_T - m x_T) w^3 is
multiplied into f sparsely (slots w^0, w^1, w^3 only).

Proof points are witness values: asserted on-curve here. (In-circuit
subgroup checks are not performed, matching the reference's native
in-circuit verifier; the outer statement's security model treats a
non-subgroup Bs as an invalid witness that fails the pairing equation or
the proving run, never as a soundness gain.)

The port's copy of tpusnark/gadgets/recursion_native.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12377 as host
from .native_tower import NFp12
from .sw_native import NativeG1, NativeG2

P = host.P


@dataclass
class NativeVkConst:
    """Inner BLS12-377 verifying key, embedded as circuit constants."""

    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    k: list  # host G1 points (len = 1 + n_public)

    @staticmethod
    def from_vk(vk):
        return NativeVkConst(
            alpha_g1=vk.alpha_g1,
            beta_g2=vk.beta_g2,
            gamma_g2=vk.gamma_g2,
            delta_g2=vk.delta_g2,
            k=list(vk.k),
        )


class NativeGroth16Verifier:
    """In-circuit BLS12-377 Groth16 verifier for BW6-761 outer circuits."""

    def __init__(self, api):
        self.api = api
        self.f12 = NFp12(api)
        self.g1 = NativeG1(api)
        self.g2 = NativeG2(api)

    # ----------------------------------------------------------- miller loop
    def _line_mul(self, f, lam, t, xp, yp):
        """f *= line l = -yp + (lam*xp) w + (y_t - lam*x_t) w^3, sparse
        (slots 0, 1, 3). Generic dense Fp6 muls on the two halves with a
        sparse second operand; exactness is tested against the host oracle."""
        f12, f2, f6 = self.f12, self.f12.f2, self.f12.f6
        api = self.api
        l0 = ((api.neg(yp), 0), f2.zero(), f2.zero())  # w^0 slot (c0.a0)
        l1 = (f2.mul_fp(lam, xp), f2.sub(t[1], f2.mul(lam, t[0])), f2.zero())
        # l = l0(c0) + l1(c1) w ; f*l with c0 scalar-ish and c1 2-sparse
        a0, a1 = f
        t0 = f6.mul(a0, l0)
        t1 = f6.mul(a1, l1)
        c0 = f6.add(t0, f6.mul_by_v(t1))
        c1 = f6.sub(
            f6.mul(f6.add(a0, a1), f6.add(l0, l1)), f6.add(t0, t1)
        )
        return (c0, c1)

    def miller(self, p, q):
        """f_{x, Q}(P): p = (xp, yp) native vars (affine, nonzero);
        q = ((x, y) NFp2 pairs) on the twist."""
        f12 = self.f12
        xp, yp = p
        t = q
        f = f12.one()
        first = True
        for bit in bin(host.X_SEED)[3:]:
            if not first:
                f = f12.square(f)
            t_new, lam = self.g2.double(t)
            if first:
                # f was 1: f^2 * l == l
                f = self._line_from(lam, t, xp, yp)
                first = False
            else:
                f = self._line_mul(f, lam, t, xp, yp)
            t = t_new
            if bit == "1":
                t_new, lam = self.g2.add(t, q)
                f = self._line_mul(f, lam, t, xp, yp)
                t = t_new
        return f

    def _line_from(self, lam, t, xp, yp):
        f2 = self.f12.f2
        api = self.api
        z2 = f2.zero()
        c0 = ((api.neg(yp), 0), z2, z2)
        c1 = (f2.mul_fp(lam, xp), f2.sub(t[1], f2.mul(lam, t[0])), z2)
        return (c0, c1)

    # -------------------------------------------------------------- verify
    def assert_proof(self, vk: NativeVkConst, ar, bs, krs, public_inputs):
        """ar/krs: (x, y) native variable pairs; bs: ((x0,x1),(y0,y1))
        NFp2 variable pairs; public_inputs: native variables (inner public
        wires, excluding the constant-one)."""
        api, f12 = self.api, self.f12
        self.g1.assert_on_curve(ar)
        self.g1.assert_on_curve(krs)
        self.g2.assert_on_curve(bs)

        # kSum = K0 + sum_i pub_i * K_i (constant bases, unified adds)
        nbits = host.R.bit_length()
        acc = self.g1.constant(vk.k[0])
        for w, base in zip(public_inputs, vk.k[1:]):
            bits = api.to_binary(w, nbits)
            term = self.g1.scalar_mul_const_base(bits, base)
            acc = self.g1.add_unified(acc, term)
        # the pairing consumes kSum as an affine pair; a zero kSum would be
        # a degenerate statement — forbid it (gnark's verifier would have
        # folded an infinity into the Miller loop as a no-op; a fixed
        # circuit shape cannot, so reject)
        api.assert_is_equal(acc[1], 0)
        ksum = acc[0]

        neg_ar = (ar[0], api.neg(ar[1]))
        f = self.miller(neg_ar, bs)
        f = f12.mul(f, self.miller(ksum, self.g2.constant(vk.gamma_g2)))
        f = f12.mul(f, self.miller(krs, self.g2.constant(vk.delta_g2)))
        out = f12.final_exp_3h(f)

        # host constant: the gadget emits finalexp(.)^3, so fold the fixed
        # pair in as e(alpha, beta)^-3 = finalexp(miller(alpha, beta))^-3
        m_ab = host.miller_loop(vk.alpha_g1, vk.beta_g2)
        c = host.final_exp(m_ab).pow(3).inv()
        f12.assert_eq_const(out, c)
