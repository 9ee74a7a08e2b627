"""Solidity verifier-contract export for PLONK/BN254.

The user-facing analog of the reference's PLONK solidity template
(gnark/backend/plonk/bn254/solidity.go, 1.4k LoC of generated
assembly) exposed via plonk.ExportSolidity. This generator emits an
original, readable contract (not the reference's hand-tuned assembly) that
executes the exact verification algorithm of
:mod:`tpusnark_torch.backend.plonk.verify`:

1. re-derive the Fiat-Shamir challenges gamma/beta/alpha/zeta with the
   sha256 precompile, using this framework's transcript byte discipline
   (utils/transcript.py: name || prev_challenge || bindings, points as
   uncompressed X||Y);
2. evaluate the public-input polynomial and L1 at zeta (modexp precompile
   for inverses);
3. check the claimed quotient against the linearization identity;
4. reconstruct foldedH and the linearized-polynomial commitment via the
   ecMul/ecAdd precompiles;
5. fold the batched opening with the KZG fold challenge (fresh "gamma"
   transcript);
6. final 2-pairing multi-point KZG check, with the batch-combination
   scalar u derived by hashing the COMPLETE statement including both
   quotient points (binding batched_h/z_shifted_h — the contract cannot
   sample verifier-local randomness, so it uses full-binding Fiat-Shamir,
   which is sound because the prover commits to everything hashed).

Proof calldata layout (uint256[26], this framework's convention —
documented in proof_to_solidity_calldata):
  [0-5]   l_com, r_com, o_com          (x, y each)
  [6-7]   z_com
  [8-13]  h1_com, h2_com, h3_com
  [14-20] claimed values: foldedH(z), lin(z), l(z), r(z), o(z), s1(z), s2(z)
  [21]    z(omega*zeta)
  [22-23] batched opening quotient W_zeta
  [24-25] shifted opening quotient W_omega_zeta

The port's copy of tpusnark/backend/plonk/solidity.py: same code.
"""

from __future__ import annotations

from ...curves.ref import P, R
from .keys import PlonkVerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Generated by tpusnark ExportSolidity — PLONK BN254 verifier.
pragma solidity ^0.8.0;

contract PlonkVerifier {{
    uint256 private constant Q = {q};
    uint256 private constant R_MOD = {r};

    uint256 private constant N = {n};
    uint256 private constant LOG2_N = {log2_n};
    uint256 private constant OMEGA = {omega};
    uint256 private constant K1 = {k1};
    uint256 private constant K2 = {k2};
    uint256 private constant N_PUBLIC = {n_public};

    // trace commitments (S1,S2,S3,Ql,Qr,Qm,Qo,Qk)
{vk_constants}

    // KZG SRS: [1]_2 and [x]_2 (EIP-197 word order: imaginary first)
    uint256 private constant G2_X1 = {g2_x1};
    uint256 private constant G2_X0 = {g2_x0};
    uint256 private constant G2_Y1 = {g2_y1};
    uint256 private constant G2_Y0 = {g2_y0};
    uint256 private constant G2X_X1 = {g2x_x1};
    uint256 private constant G2X_X0 = {g2x_x0};
    uint256 private constant G2X_Y1 = {g2x_y1};
    uint256 private constant G2X_Y0 = {g2x_y0};

    error InvalidProof();
    error InvalidInputLength();

    // ---------------------------------------------------------- utilities
    function inverse(uint256 x) internal view returns (uint256 out) {{
        // modexp precompile: x^(R_MOD-2) mod R_MOD
        if (x == 0) revert InvalidProof();
        uint256[6] memory inp = [32, 32, 32, x, R_MOD - 2, R_MOD];
        uint256[1] memory o;
        bool ok;
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 5, inp, 192, o, 32)
        }}
        if (!ok) revert InvalidProof();
        out = o[0];
    }}

    function ecmul(uint256 x, uint256 y, uint256 s)
        internal view returns (uint256, uint256)
    {{
        if (s % R_MOD == 0 || (x == 0 && y == 0)) return (0, 0);
        uint256[3] memory inp = [x, y, s % R_MOD];
        uint256[2] memory o;
        bool ok;
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 7, inp, 96, o, 64)
        }}
        if (!ok) revert InvalidProof();
        return (o[0], o[1]);
    }}

    function ecadd(uint256 ax, uint256 ay, uint256 bx, uint256 by)
        internal view returns (uint256, uint256)
    {{
        if (ax == 0 && ay == 0) return (bx, by);
        if (bx == 0 && by == 0) return (ax, ay);
        uint256[4] memory inp = [ax, ay, bx, by];
        uint256[2] memory o;
        bool ok;
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 6, inp, 128, o, 64)
        }}
        if (!ok) revert InvalidProof();
        return (o[0], o[1]);
    }}

    function zetaPowN(uint256 zeta) internal pure returns (uint256 zn) {{
        zn = zeta;
        for (uint256 i = 0; i < LOG2_N; i++) {{
            zn = mulmod(zn, zn, R_MOD);
        }}
    }}

    // --------------------------------------------------- transcript (sha256)
    // challenge = sha256(name || prev_challenge || bindings); points bind as
    // uncompressed X||Y (64 bytes), field elements as 32-byte big-endian.
    function deriveChallenges(
        uint256[26] calldata proof, uint256[{n_inputs_max}] calldata input
    ) internal pure returns (uint256 gamma, uint256 beta, uint256 alpha, uint256 zeta) {{
        bytes32 g = sha256(
            abi.encodePacked(
                "gamma",
                abi.encodePacked(
                    [S1_X, S1_Y, S2_X, S2_Y, S3_X, S3_Y],
                    [QL_X, QL_Y, QR_X, QR_Y, QM_X, QM_Y, QO_X, QO_Y, QK_X, QK_Y]
                ),
                {input_binding}abi.encodePacked(proof[0], proof[1], proof[2], proof[3], proof[4], proof[5])
            )
        );
        bytes32 b = sha256(abi.encodePacked("beta", g));
        bytes32 a = sha256(abi.encodePacked("alpha", b, proof[6], proof[7]));
        bytes32 z = sha256(
            abi.encodePacked(
                "zeta", a,
                proof[8], proof[9], proof[10], proof[11], proof[12], proof[13]
            )
        );
        gamma = uint256(g) % R_MOD;
        beta = uint256(b) % R_MOD;
        alpha = uint256(a) % R_MOD;
        zeta = uint256(z) % R_MOD;
    }}

    // --------------------------------------------------------------- verify
    function verifyProof(
        uint256[26] calldata proof, uint256[{n_inputs_max}] calldata input
    ) public view {{
        for (uint256 i = 0; i < N_PUBLIC; i++) {{
            if (input[i] >= R_MOD) revert InvalidProof();
        }}
        (uint256 gamma, uint256 beta, uint256 alpha, uint256 zeta) =
            deriveChallenges(proof, input);

        uint256 zh = addmod(zetaPowN(zeta), R_MOD - 1, R_MOD);
        if (zh == 0) revert InvalidProof();
        uint256 nInv = inverse(N % R_MOD);

        // L1(zeta) and public-input polynomial PI(zeta)
        uint256 l1 = mulmod(mulmod(zh, nInv, R_MOD),
                            inverse(addmod(zeta, R_MOD - 1, R_MOD)), R_MOD);
        uint256 pi = 0;
        {{
            uint256 wi = 1;
            for (uint256 i = 0; i < N_PUBLIC; i++) {{
                uint256 li = mulmod(
                    mulmod(wi, zh, R_MOD),
                    mulmod(nInv, inverse(addmod(zeta, R_MOD - wi, R_MOD)), R_MOD),
                    R_MOD
                );
                pi = addmod(pi, mulmod(input[i], li, R_MOD), R_MOD);
                wi = mulmod(wi, OMEGA, R_MOD);
            }}
        }}

        // linearization identity:
        // lin(z) + PI + alpha*zu*(l+b*s1+g)(r+b*s2+g)(o+g) - alpha^2*L1(z)
        //   == foldedH(z) * zh
        {{
            uint256 permConst = mulmod(
                mulmod(alpha, proof[21], R_MOD),
                mulmod(
                    mulmod(
                        addmod(proof[16], addmod(mulmod(beta, proof[19], R_MOD), gamma, R_MOD), R_MOD),
                        addmod(proof[17], addmod(mulmod(beta, proof[20], R_MOD), gamma, R_MOD), R_MOD),
                        R_MOD
                    ),
                    addmod(proof[18], gamma, R_MOD),
                    R_MOD
                ),
                R_MOD
            );
            uint256 lhs = addmod(
                addmod(proof[15], pi, R_MOD),
                addmod(permConst, R_MOD - mulmod(mulmod(alpha, alpha, R_MOD), l1, R_MOD), R_MOD),
                R_MOD
            );
            if (lhs != mulmod(zh, proof[14], R_MOD)) revert InvalidProof();
        }}

        // foldedH = h1 + zeta^(n+2) h2 + zeta^(2n+4) h3
        uint256 fhx;
        uint256 fhy;
        {{
            uint256 zm2 = mulmod(zetaPowN(zeta), mulmod(zeta, zeta, R_MOD), R_MOD);
            (uint256 tx, uint256 ty) = ecmul(proof[10], proof[11], zm2);
            (uint256 ux, uint256 uy) = ecmul(proof[12], proof[13], mulmod(zm2, zm2, R_MOD));
            (fhx, fhy) = ecadd(proof[8], proof[9], tx, ty);
            (fhx, fhy) = ecadd(fhx, fhy, ux, uy);
        }}

        // linearized-polynomial commitment
        uint256 lcx;
        uint256 lcy;
        {{
            uint256 s3s = mulmod(
                mulmod(mulmod(alpha, proof[21], R_MOD), beta, R_MOD),
                mulmod(
                    addmod(proof[16], addmod(mulmod(beta, proof[19], R_MOD), gamma, R_MOD), R_MOD),
                    addmod(proof[17], addmod(mulmod(beta, proof[20], R_MOD), gamma, R_MOD), R_MOD),
                    R_MOD
                ),
                R_MOD
            );
            uint256 zs = addmod(
                R_MOD - mulmod(
                    alpha,
                    mulmod(
                        mulmod(
                            addmod(proof[16], addmod(mulmod(beta, zeta, R_MOD), gamma, R_MOD), R_MOD),
                            addmod(proof[17], addmod(mulmod(mulmod(beta, K1, R_MOD), zeta, R_MOD), gamma, R_MOD), R_MOD),
                            R_MOD
                        ),
                        addmod(proof[18], addmod(mulmod(mulmod(beta, K2, R_MOD), zeta, R_MOD), gamma, R_MOD), R_MOD),
                        R_MOD
                    ),
                    R_MOD
                ),
                mulmod(mulmod(alpha, alpha, R_MOD), l1, R_MOD),
                R_MOD
            );
            (uint256 tx, uint256 ty) = ecmul(QL_X, QL_Y, proof[16]);
            (lcx, lcy) = (tx, ty);
            (tx, ty) = ecmul(QR_X, QR_Y, proof[17]);
            (lcx, lcy) = ecadd(lcx, lcy, tx, ty);
            (tx, ty) = ecmul(QM_X, QM_Y, mulmod(proof[16], proof[17], R_MOD));
            (lcx, lcy) = ecadd(lcx, lcy, tx, ty);
            (tx, ty) = ecmul(QO_X, QO_Y, proof[18]);
            (lcx, lcy) = ecadd(lcx, lcy, tx, ty);
            (lcx, lcy) = ecadd(lcx, lcy, QK_X, QK_Y);
            (tx, ty) = ecmul(S3_X, S3_Y, s3s);
            (lcx, lcy) = ecadd(lcx, lcy, tx, ty);
            (tx, ty) = ecmul(proof[6], proof[7], zs);
            (lcx, lcy) = ecadd(lcx, lcy, tx, ty);
        }}

        // KZG fold challenge nu: fresh "gamma" transcript over
        // zeta || digests || claimed values || zu
        uint256 nu = uint256(sha256(abi.encodePacked(
            "gamma",
            zeta,
            abi.encodePacked(fhx, fhy, lcx, lcy),
            abi.encodePacked(proof[0], proof[1], proof[2], proof[3], proof[4], proof[5]),
            abi.encodePacked([S1_X, S1_Y, S2_X, S2_Y]),
            abi.encodePacked(
                proof[14], proof[15], proof[16], proof[17], proof[18],
                proof[19], proof[20], proof[21]
            )
        ))) % R_MOD;

        // fold digests and claimed values with powers of nu
        uint256 fdx;
        uint256 fdy;
        uint256 fv = 0;
        {{
            uint256[14] memory ds = [
                fhx, fhy, lcx, lcy,
                proof[0], proof[1], proof[2], proof[3], proof[4], proof[5],
                S1_X, S1_Y, S2_X, S2_Y
            ];
            uint256 ch = 1;
            for (uint256 i = 0; i < 7; i++) {{
                (uint256 tx, uint256 ty) = ecmul(ds[2 * i], ds[2 * i + 1], ch);
                (fdx, fdy) = ecadd(fdx, fdy, tx, ty);
                fv = addmod(fv, mulmod(ch, proof[14 + i], R_MOD), R_MOD);
                ch = mulmod(ch, nu, R_MOD);
            }}
        }}

        // batch-combination scalar u: binds EVERYTHING incl. both quotients
        uint256 u = uint256(sha256(abi.encodePacked(
            abi.encodePacked(fdx, fdy, fv),
            abi.encodePacked(proof[6], proof[7], zeta, proof[21]),
            abi.encodePacked(proof[22], proof[23], proof[24], proof[25])
        ))) % R_MOD;

        // F  = (D1 - v1*G + z1*H1) + u*(D2 - v2*G + z2*H2)
        // Hf = H1 + u*H2 ;  check e(F, [1]_2) * e(-Hf, [x]_2) == 1
        uint256 fx;
        uint256 fy;
        uint256 hfx;
        uint256 hfy;
        {{
            (uint256 gx, uint256 gy) = ecmul(1, 2, fv);
            (uint256 t1x, uint256 t1y) = ecadd(fdx, fdy, gx, gy == 0 ? 0 : Q - gy);
            (uint256 hx, uint256 hy) = ecmul(proof[22], proof[23], zeta);
            (t1x, t1y) = ecadd(t1x, t1y, hx, hy);

            uint256 oz = mulmod(OMEGA, zeta, R_MOD);
            (gx, gy) = ecmul(1, 2, proof[21]);
            (uint256 t2x, uint256 t2y) = ecadd(proof[6], proof[7], gx, gy == 0 ? 0 : Q - gy);
            (hx, hy) = ecmul(proof[24], proof[25], oz);
            (t2x, t2y) = ecadd(t2x, t2y, hx, hy);
            (t2x, t2y) = ecmul(t2x, t2y, u);
            (fx, fy) = ecadd(t1x, t1y, t2x, t2y);

            (hx, hy) = ecmul(proof[24], proof[25], u);
            (hfx, hfy) = ecadd(proof[22], proof[23], hx, hy);
        }}

        uint256[12] memory pairings = [
            fx, fy, G2_X1, G2_X0, G2_Y1, G2_Y0,
            hfx, hfy == 0 ? 0 : Q - hfy, G2X_X1, G2X_X0, G2X_Y1, G2X_Y0
        ];
        uint256[1] memory out;
        bool ok;
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 8, pairings, 384, out, 32)
        }}
        if (!ok || out[0] != 1) revert InvalidProof();
    }}
}}
"""

_VK_POINT = "    uint256 private constant {name}_X = {x};\n    uint256 private constant {name}_Y = {y};"


def _xy(pt):
    return (0, 0) if pt is None else (int(pt[0]) % P, int(pt[1]) % P)


def _g2_words(pt):
    if pt is None:
        return (0, 0, 0, 0)
    x, y = pt
    return (x.c1 % P, x.c0 % P, y.c1 % P, y.c0 % P)


def export_solidity(vk: PlonkVerifyingKey) -> str:
    """Solidity source of a PLONK verifier contract for this vk.

    BSB22/qcp circuits need in-contract hash-to-field for the commitment
    public-input contribution — refused rather than silently dropped
    (same policy as the Groth16 exporter)."""
    if vk.qcp or vk.commitment_constraint_indexes:
        raise NotImplementedError(
            "solidity export for BSB22 (qcp) circuits not supported yet"
        )
    names = ["S1", "S2", "S3", "QL", "QR", "QM", "QO", "QK"]
    pts = [vk.s1, vk.s2, vk.s3, vk.ql, vk.qr, vk.qm, vk.qo, vk.qc]
    consts = []
    for name, pt in zip(names, pts):
        x, y = _xy(pt)
        consts.append(_VK_POINT.format(name=name, x=x, y=y))
    g2_1 = _g2_words(vk.g2[0])
    g2_x = _g2_words(vk.g2[1])
    return _TEMPLATE.format(
        q=P,
        r=R,
        n=vk.n,
        log2_n=max(0, vk.n.bit_length() - 1),
        omega=vk.generator,
        k1=vk.k1,
        k2=vk.k2,
        n_public=vk.n_public,
        n_inputs_max=max(1, vk.n_public),
        input_binding="abi.encodePacked(input),\n                " if vk.n_public else "",
        vk_constants="\n".join(consts),
        g2_x1=g2_1[0],
        g2_x0=g2_1[1],
        g2_y1=g2_1[2],
        g2_y0=g2_1[3],
        g2x_x1=g2_x[0],
        g2x_x0=g2_x[1],
        g2x_y1=g2_x[2],
        g2x_y0=g2_x[3],
    )


def proof_to_solidity_calldata(proof) -> list[int]:
    """The uint256[26] array verifyProof expects (layout in module docstring)."""
    if proof.bsb22_commitments:
        raise NotImplementedError("BSB22 proofs have no solidity calldata form yet")
    out = []
    for pt in (proof.l_com, proof.r_com, proof.o_com, proof.z_com):
        x, y = _xy(pt)
        out += [x, y]
    for pt in (proof.h1_com, proof.h2_com, proof.h3_com):
        x, y = _xy(pt)
        out += [x, y]
    out += [int(v) % R for v in proof.claimed_values[:7]]
    out.append(int(proof.z_shifted_value) % R)
    for pt in (proof.batched_h, proof.z_shifted_h):
        x, y = _xy(pt)
        out += [x, y]
    return out
