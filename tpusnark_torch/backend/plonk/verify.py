"""PLONK verifier, gnark protocol shape (the port's copy of
tpusnark/backend/plonk/verify.py: same code, on the port's host half of KZG
and its transcript).

Reference being reproduced: gnark/backend/plonk/bn254/verify.go:45-280 —
re-derive the Fiat-Shamir challenges, evaluate the public-input polynomial at
zeta, check the claimed quotient against the linearization identity,
reconstruct the linearized-polynomial commitment by a small MSM over the vk
commitments + proof points, fold the batched opening, and finish with one
2-pairing multi-point KZG check.

(Challenge hashing is this framework's SHA-256 transcript — structure matches
gnark, byte-exact gnark transcripts are follow-up work; see utils/transcript.)
"""

from __future__ import annotations

from ...curves.ref import G1, R
from ...poly import kzg
from ...utils.transcript import Transcript, fr_bytes, g1_bytes
from .keys import PlonkProof, PlonkVerifyingKey
from .prove import CHALLENGES, FOLD_ORDER


class InvalidPlonkProofError(Exception):
    pass


def verify(
    proof: PlonkProof, vk: PlonkVerifyingKey, public_inputs: list[int], config=None
) -> bool:
    # config: backend.config.VerifierConfig — hash overrides MUST match the
    # prover's (gnark backend.go:169-199)
    vcfg = config
    p = R
    n = vk.n
    w = vk.generator
    pubs = [int(x) % p for x in public_inputs]
    if len(pubs) != vk.n_public:
        raise InvalidPlonkProofError(
            f"wrong number of public inputs: got {len(pubs)}, want {vk.n_public}"
        )
    n_com = len(vk.qcp)
    if len(proof.claimed_values) != len(FOLD_ORDER) + n_com:
        return False
    if len(proof.bsb22_commitments) != n_com:
        return False

    # ---- re-derive challenges (binding order must match the prover) ----------
    tr = Transcript(
        list(CHALLENGES),
        hash_factory=vcfg.challenge_hash if vcfg is not None else None,
    )
    for pt in vk.digest_points():
        tr.bind("gamma", g1_bytes(pt))
    for x in pubs:
        tr.bind("gamma", fr_bytes(x))
    for c in (proof.l_com, proof.r_com, proof.o_com):
        tr.bind("gamma", g1_bytes(c))
    gamma = tr.challenge_int("gamma", p)
    beta = tr.challenge_int("beta", p)
    # alpha binds the Bsb22 commitments then Z (verify.go:78-83)
    for c in proof.bsb22_commitments:
        tr.bind("alpha", g1_bytes(c))
    tr.bind("alpha", g1_bytes(proof.z_com))
    alpha = tr.challenge_int("alpha", p)
    for c in (proof.h1_com, proof.h2_com, proof.h3_com):
        tr.bind("zeta", g1_bytes(c))
    zeta = tr.challenge_int("zeta", p)

    fhb, lin_zeta, lb, rb, ob, s1b, s2b = [
        v % p for v in proof.claimed_values[:7]
    ]
    qcp_zeta = [v % p for v in proof.claimed_values[7:]]
    zu = proof.z_shifted_value % p

    # ---- public input polynomial + L1 at zeta ---------------------------------
    zh = (pow(zeta, n, p) - 1) % p
    if zh == 0:
        raise InvalidPlonkProofError("zeta landed in the domain")
    n_inv = pow(n, -1, p)
    l1_zeta = zh * n_inv % p * pow((zeta - 1) % p, -1, p) % p
    pi = 0
    wi = 1
    for x in pubs:
        li = wi * zh % p * n_inv % p * pow((zeta - wi) % p, -1, p) % p
        pi = (pi + x * li) % p
        wi = wi * w % p
    # BSB22 (verify.go:127-155): PI gains hash(Bsb22Commitment_i) *
    # L_{npub + commitment_index}(zeta) for each commitment
    if n_com:
        from ...curves.marshal import g1_raw
        from ...utils.hash_to_field import hash_to_field

        for i, idx in enumerate(vk.commitment_constraint_indexes):
            (hashed,) = hash_to_field(
                g1_raw(proof.bsb22_commitments[i]), b"BSB22-Plonk", p
            )
            wpow = pow(w, vk.n_public + int(idx), p)
            li = wpow * zh % p * n_inv % p * pow((zeta - wpow) % p, -1, p) % p
            pi = (pi + hashed * li) % p

    # ---- claimed quotient vs linearization identity (verify.go:157-193) ------
    # lin(z) + pi(z) + a*zu*(l+b*s1+g)(r+b*s2+g)(o+g) - a^2*L1(z) == H(z)*(z^n-1)
    perm_const = (
        alpha
        * zu
        % p
        * ((lb + beta * s1b + gamma) % p)
        % p
        * ((rb + beta * s2b + gamma) % p)
        % p
        * ((ob + gamma) % p)
        % p
    )
    lhs = (lin_zeta + pi + perm_const - alpha * alpha % p * l1_zeta) % p
    if lhs != zh * fhb % p:
        return False

    # ---- reconstruct commitments (verify.go:196-246) ---------------------------
    m2 = n + 2
    zeta_m2 = pow(zeta, m2, p)
    folded_h_com = G1.add(
        proof.h1_com,
        G1.add(
            G1.mul(proof.h2_com, zeta_m2),
            G1.mul(proof.h3_com, zeta_m2 * zeta_m2 % p),
        ),
    )
    s3_scal = (
        alpha
        * zu
        % p
        * beta
        % p
        * ((lb + beta * s1b + gamma) % p)
        % p
        * ((rb + beta * s2b + gamma) % p)
        % p
    )
    z_scal = (
        -alpha
        * ((lb + beta * zeta + gamma) % p)
        * ((rb + beta * vk.k1 % p * zeta + gamma) % p)
        % p
        * ((ob + beta * vk.k2 % p * zeta + gamma) % p)
        + alpha * alpha % p * l1_zeta
    ) % p
    rl = lb * rb % p
    lin_com = None
    for pt, s in [
        (vk.ql, lb),
        (vk.qr, rb),
        (vk.qm, rl),
        (vk.qo, ob),
        (vk.qc, 1),
        (vk.s3, s3_scal),
        (proof.z_com, z_scal),
    ] + [
        # BSB22: + qcp_i(zeta) * Bsb22Commitment_i (verify.go:237-243)
        (proof.bsb22_commitments[i], qcp_zeta[i])
        for i in range(n_com)
    ]:
        if pt is None or s % p == 0:
            continue
        lin_com = G1.add(lin_com, G1.mul(pt, s % p))

    # ---- fold the batched opening (gnark kzg.FoldProof: fresh "gamma"
    # transcript over zeta || digests || claimed values || zu bytes, same
    # derivation as the prover's BatchOpenSinglePoint) -------------------------
    from ...utils.transcript import kzg_fold_challenge

    claimed = [fhb, lin_zeta, lb, rb, ob, s1b, s2b] + qcp_zeta
    digests = [
        folded_h_com,
        lin_com,
        proof.l_com,
        proof.r_com,
        proof.o_com,
        vk.s1,
        vk.s2,
    ] + list(vk.qcp)
    nu = kzg_fold_challenge(
        zeta,
        digests,
        claimed,
        [fr_bytes(zu)],
        p,
        hash_factory=vcfg.kzg_fold_hash if vcfg is not None else None,
    )

    folded_digest = None
    folded_value = 0
    ch = 1
    for d, v in zip(digests, claimed):
        if d is not None:
            folded_digest = G1.add(folded_digest, G1.mul(d, ch))
        folded_value = (folded_value + ch * v) % p
        ch = ch * nu % p

    # ---- one multi-point batch pairing check (verify.go:262-278) --------------
    # The fold scalar is verifier-LOCAL randomness sampled inside
    # batch_verify_multi_points after the whole proof is fixed (gnark-crypto
    # BatchVerifyMultiPoints does the same) — a transcript-derived lambda the
    # prover can predict without binding batched_h/z_shifted_h is forgeable.
    omega_zeta = zeta * w % p
    srs_v = kzg.SRS(g1=[], g2=vk.g2)
    return kzg.batch_verify_multi_points(
        srs_v,
        [
            (folded_digest, zeta, folded_value, proof.batched_h),
            (proof.z_com, omega_zeta, zu, proof.z_shifted_h),
        ],
    )
