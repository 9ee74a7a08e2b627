"""In-circuit PLONK verifier: the std/recursion/plonk analog.

Reference: gnark/std/recursion/plonk/verifier.go — verify an INNER
PLONK/BN254 proof inside an OUTER BN254 circuit (the recursion flavor used
by production rollups). Same protocol algebra as the host verifier
(backend/plonk/verify.py:27-212): re-derive the Fiat-Shamir challenges,
check the linearization/quotient scalar identity at zeta, reconstruct the
linearized and folded-H digests by multi-scalar multiplication, fold the
batched opening, and close with one 2-pairing KZG check.

Recursion-friendly hashing: the inner proof MUST be produced with
``ProverConfig.with_challenge_hash(MiMCFrHash).with_kzg_fold_hash?`` — i.e.
`utils.mimc_transcript.MiMCFrHash` for BOTH the challenge and the KZG-fold
transcripts (the reference runs the inner prover with
`WithProverChallengeHashFunction(mimc)` for the same reason). This gadget
recomputes those transcripts with `hashes.mimc.MiMCGadget`, absorbing the
identical (hi128, lo128) word pairs: point coordinates come from the
witness's 64-bit emulated limbs (hi = l2 + 2^64 l3, lo = l0 + 2^64 l1),
native fr values from a 254-bit binary split.

The batch-of-two-openings combination scalar is transcript-derived IN
circuit, bound to every digest INCLUDING the two quotient proofs — the
binding gnark-crypto gets from verifier-local randomness (see
poly/kzg.py:184-188; a lambda the prover can predict without binding the
quotients is forgeable, so the quotients are absorbed first).

Public inputs are native outer-circuit variables; all G1 points live over
emulated Fp. Points are assumed non-infinity (honest proofs of satisfiable
circuits; same precondition as the affine pairing gadget).

The port's copy of tpusnark/gadgets/recursion_plonk.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.ref import R as BN_FR
from ..hashes.mimc import MiMCGadget
from ..utils.mimc_transcript import word_pair
from ..utils.transcript import g1_bytes
from .pairing import G1Point, PairingGadget
from .recursion import BN254_G1
from .sw_emulated import EmulatedCurve, EmuPoint

_M64 = 1 << 64


@dataclass
class PlonkProofVar:
    """An inner PLONK proof as circuit values."""

    l_com: EmuPoint
    r_com: EmuPoint
    o_com: EmuPoint
    z_com: EmuPoint
    h1_com: EmuPoint
    h2_com: EmuPoint
    h3_com: EmuPoint
    batched_h: EmuPoint
    z_shifted_h: EmuPoint
    claimed_values: list  # 7 native vars: foldedH, lin, l, r, o, s1, s2
    z_shifted_value: object  # native var


class PlonkRecursionVerifier:
    def __init__(self, api, vk, limb_bits: int = 64):
        assert limb_bits == 64, "transcript word split assumes 64-bit limbs"
        self.api = api
        self.vk = vk
        assert not vk.qcp, "BSB22 commitments not supported in-circuit yet"
        self.pg = PairingGadget(api, limb_bits)
        self.curve = EmulatedCurve(api, BN254_G1, limb_bits)
        self.curve.F = self.pg.F

    # ------------------------------------------------------------- builders
    def proof_from_host(self, proof) -> PlonkProofVar:
        """Adopt a host PlonkProof as constants (tests); production use
        supplies the same fields as witness limbs via proof_from_limbs."""
        c = self.curve

        def pt(p):
            return c.constant_point(p[0], p[1])

        return PlonkProofVar(
            l_com=pt(proof.l_com),
            r_com=pt(proof.r_com),
            o_com=pt(proof.o_com),
            z_com=pt(proof.z_com),
            h1_com=pt(proof.h1_com),
            h2_com=pt(proof.h2_com),
            h3_com=pt(proof.h3_com),
            batched_h=pt(proof.batched_h),
            z_shifted_h=pt(proof.z_shifted_h),
            claimed_values=[int(v) % BN_FR for v in proof.claimed_values],
            z_shifted_value=int(proof.z_shifted_value) % BN_FR,
        )

    def proof_from_limbs(self, points: dict, claimed_values, z_shifted_value):
        """points: name -> (x_limbs, y_limbs) 64-bit limb variable lists for
        the 9 G1 points; claimed_values / z_shifted_value: native vars."""
        F = self.pg.F

        def pt(pl):
            return EmuPoint(F.from_limbs(pl[0]), F.from_limbs(pl[1]))

        return PlonkProofVar(
            **{k: pt(points[k]) for k in (
                "l_com", "r_com", "o_com", "z_com",
                "h1_com", "h2_com", "h3_com", "batched_h", "z_shifted_h",
            )},
            claimed_values=list(claimed_values),
            z_shifted_value=z_shifted_value,
        )

    # --------------------------------------------------- transcript plumbing
    def _split_native(self, v):
        """Native fr var -> (hi128, lo) absorb pair."""
        api = self.api
        if isinstance(v, int):
            return word_pair(v % BN_FR)
        bits = api.to_binary(v, 254)
        return api.from_binary(bits[128:]), api.from_binary(bits[:128])

    def _canon(self, el):
        """Emulated element -> canonical 64-bit limbs."""
        F = self.pg.F
        el = F.reduce(el) if el.overflow else el
        F._assert_lt_modulus(el)
        return el.limbs

    def _emu_split(self, el):
        api = self.api
        l = self._canon(el)
        return (
            api.add(l[2], api.mul(l[3], _M64)),
            api.add(l[0], api.mul(l[1], _M64)),
        )

    def _point_words(self, P):
        """EmuPoint -> the 4 absorb values of its 64-byte marshalling."""
        return [*self._emu_split(P.x), *self._emu_split(P.y)]

    @staticmethod
    def _const_words(data: bytes):
        """Host bytes -> absorb pairs, mirroring MiMCFrHash.update."""
        pad = (-len(data)) % 32
        data = b"\x00" * pad + bytes(data)
        out = []
        for i in range(0, len(data), 32):
            out.extend(word_pair(int.from_bytes(data[i : i + 32], "big")))
        return out

    def _challenge(self, name: str, prev, items):
        """One Transcript.compute: MiMC(name || prev || items)."""
        h = MiMCGadget(self.api)
        h.write(*self._const_words(name.encode()))
        if prev is not None:
            h.write(*self._split_native(prev))
        for it in items:
            h.write(*it)
        return h.sum()

    # --------------------------------------------------------------- verify
    def assert_proof(self, proof: PlonkProofVar, public_inputs):
        api, vk, curve = self.api, self.vk, self.curve
        pg = self.pg
        p = BN_FR
        n = vk.n
        assert n & (n - 1) == 0
        assert len(public_inputs) == vk.n_public, "public input count"

        # on-curve checks for the nine witness points
        for P in (
            proof.l_com, proof.r_com, proof.o_com, proof.z_com,
            proof.h1_com, proof.h2_com, proof.h3_com,
            proof.batched_h, proof.z_shifted_h,
        ):
            curve.assert_on_curve(P)

        # ---- challenges (Transcript order: gamma, beta, alpha, zeta) -----
        vk_words = [self._const_words(g1_bytes(pt)) for pt in vk.digest_points()]
        gamma = self._challenge(
            "gamma",
            None,
            vk_words
            + [self._split_native(x) for x in public_inputs]
            + [self._point_words(proof.l_com)]
            + [self._point_words(proof.r_com)]
            + [self._point_words(proof.o_com)],
        )
        beta = self._challenge("beta", gamma, [])
        alpha = self._challenge("alpha", beta, [self._point_words(proof.z_com)])
        zeta = self._challenge(
            "zeta",
            alpha,
            [self._point_words(c) for c in (proof.h1_com, proof.h2_com, proof.h3_com)],
        )

        fhb, lin_zeta, lb, rb, ob, s1b, s2b = proof.claimed_values
        zu = proof.z_shifted_value

        # ---- native scalar algebra (verify.py:76-121) --------------------
        zeta_n = zeta
        for _ in range(n.bit_length() - 1):
            zeta_n = api.mul(zeta_n, zeta_n)
        zh = api.sub(zeta_n, 1)
        # zeta outside the domain (zh != 0) or l1/li divisions break anyway
        n_inv = pow(n, -1, p)
        l1_zeta = api.mul(api.div(zh, api.sub(zeta, 1)), n_inv)
        pi = 0
        wi = 1
        for x in public_inputs:
            li = api.mul(api.div(zh, api.sub(zeta, wi)), wi * n_inv % p)
            pi = api.add(pi, api.mul(x, li))
            wi = wi * vk.generator % p

        gpl = api.add(lb, api.mul(beta, s1b), gamma)  # l + b s1 + g
        gpr = api.add(rb, api.mul(beta, s2b), gamma)
        perm_const = api.mul(api.mul(alpha, zu), api.mul(gpl, api.mul(gpr, api.add(ob, gamma))))
        a2l1 = api.mul(api.mul(alpha, alpha), l1_zeta)
        lhs = api.sub(api.add(lin_zeta, pi, perm_const), a2l1)
        api.assert_is_equal(lhs, api.mul(zh, fhb))

        # ---- digest reconstruction (verify.py:123-160) -------------------
        zeta_m2 = api.mul(api.mul(zeta_n, zeta), zeta)  # zeta^(n+2)
        s3_scal = api.mul(api.mul(api.mul(alpha, zu), beta), api.mul(gpl, gpr))
        zl = api.add(lb, api.mul(beta, zeta), gamma)
        zr = api.add(rb, api.mul(api.mul(beta, vk.k1), zeta), gamma)
        zo = api.add(ob, api.mul(api.mul(beta, vk.k2), zeta), gamma)
        z_scal = api.sub(a2l1, api.mul(alpha, api.mul(zl, api.mul(zr, zo))))

        def smul(P, s):
            if isinstance(s, int):
                s = api.add(s, 0)  # promote const
            bits = api.to_binary(s, 254)
            return curve.scalar_mul_flagged(P, bits)

        def msm(terms, init=None):
            """terms: [(EmuPoint, native scalar)] (+ optional plain init
            point); returns (point, zero_flag)."""
            acc, az = init if init is not None else (None, None)
            for P, s in terms:
                t, tz = smul(P, s)
                if acc is None:
                    acc, az = t, tz
                else:
                    acc, az = curve.add_unified(acc, t, az, tz)
            return acc, az

        cpt = lambda pt: curve.constant_point(pt[0], pt[1])
        folded_h, fh_z = msm(
            [(proof.h2_com, zeta_m2), (proof.h3_com, api.mul(zeta_m2, zeta_m2))]
        )
        folded_h, fh_z = curve.add_unified(proof.h1_com, folded_h, 0, fh_z)
        # vk selector commitments may be the identity (None) — e.g. qm for a
        # circuit with no multiplication gates. vk is a build-time constant,
        # so skip those terms exactly as the host verifier does
        # (backend/plonk/verify.py: `if pt is None ...: continue`);
        # identity * anything contributes nothing to the MSM.
        lin_com, lc_z = msm(
            [
                (cpt(pt), s)
                for pt, s in [
                    (vk.ql, lb),
                    (vk.qr, rb),
                    (vk.qm, api.mul(lb, rb)),
                    (vk.qo, ob),
                    (vk.s3, s3_scal),
                ]
                if pt is not None
            ]
            + [(proof.z_com, z_scal)]
        )
        if vk.qc is not None:
            lin_com, lc_z = curve.add_unified(cpt(vk.qc), lin_com, 0, lc_z)
        api.assert_is_equal(fh_z, 0)
        api.assert_is_equal(lc_z, 0)

        # ---- KZG fold challenge (kzg_fold_challenge mirror) --------------
        digests = [
            self._point_words(folded_h),
            self._point_words(lin_com),
            self._point_words(proof.l_com),
            self._point_words(proof.r_com),
            self._point_words(proof.o_com),
            self._const_words(g1_bytes(vk.s1)),
            self._const_words(g1_bytes(vk.s2)),
        ]
        claimed = [fhb, lin_zeta, lb, rb, ob, s1b, s2b]
        nu = self._challenge(
            "gamma",
            None,
            [self._split_native(zeta)]
            + digests
            + [self._split_native(v) for v in claimed]
            + [self._split_native(zu)],
        )

        com_pts = [
            (folded_h, 0), (lin_com, 0),
            (proof.l_com, 0), (proof.r_com, 0), (proof.o_com, 0),
            (cpt(vk.s1), 0), (cpt(vk.s2), 0),
        ]
        folded_digest, fd_z = com_pts[0]
        folded_value = claimed[0]
        ch = 1
        for (P, pz), v in zip(com_pts[1:], claimed[1:]):
            ch = api.mul(ch, nu)
            t, tz = smul(P, ch)
            folded_digest, fd_z = curve.add_unified(folded_digest, t, fd_z, tz)
            folded_value = api.add(folded_value, api.mul(ch, v))
        api.assert_is_equal(fd_z, 0)

        # ---- batch-of-two combination scalar (binds the quotients) -------
        omega_zeta = api.mul(zeta, vk.generator)
        lam = self._challenge(
            "batch",
            None,
            [
                self._point_words(proof.batched_h),
                self._point_words(proof.z_shifted_h),
                self._point_words(folded_digest),
                self._point_words(proof.z_com),
                self._split_native(zeta),
                self._split_native(omega_zeta),
                self._split_native(folded_value),
                self._split_native(zu),
            ],
        )

        # F = (D1 - v1 G + z1 W1) + lam (D2 - v2 G + z2 W2); Hf = W1 + lam W2
        G = curve.generator()

        def opening_term(D, dz, v, z, W):
            vG, vz = smul(G, v)
            t, tz = curve.add_unified(D, curve.neg(vG), dz, vz)
            zW, zz = smul(W, z)
            return curve.add_unified(t, zW, tz, zz)

        t1, t1z = opening_term(folded_digest, fd_z, folded_value, zeta, proof.batched_h)
        t2, t2z = opening_term(proof.z_com, 0, zu, omega_zeta, proof.z_shifted_h)
        lt2, lt2z = smul(t2, lam)
        lt2z = api.or_(lt2z, t2z)
        fpt, f_z = curve.add_unified(t1, lt2, t1z, lt2z)
        lw2, lw2z = smul(proof.z_shifted_h, lam)
        hf, hf_z = curve.add_unified(proof.batched_h, lw2, 0, lw2z)
        api.assert_is_equal(f_z, 0)
        api.assert_is_equal(hf_z, 0)

        pg.pairing_check(
            [
                (G1Point(fpt.x, fpt.y), pg.g2_point(*vk.g2[0])),
                (G1Point(hf.x, self.pg.F.neg(hf.y)), pg.g2_point(*vk.g2[1])),
            ]
        )
