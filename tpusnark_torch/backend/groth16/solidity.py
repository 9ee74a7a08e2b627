"""Solidity verifier-contract export for Groth16/BN254.

The user-facing analog of the reference's ExportSolidity
(gnark/backend/groth16/bn254/verify.go:147 + the embedded template
gnark/backend/groth16/bn254/solidity.go). This generator is an original, minimal
contract (not the reference's template): verifyProof(proof, input) checks
e(-A, B) * e(alpha, beta) * e(K(input), gamma) * e(C, delta) == 1 through the
EIP-196/197 precompiles (ecAdd 0x06, ecMul 0x07, pairing 0x08).

Proof encoding matches gnark's contract input convention: 8 uint256s
[Ax, Ay, Bx1, Bx0, By1, By0, Cx, Cy] — G2 coordinates big-endian with the
imaginary part FIRST (EIP-197 ordering).

The port's copy of tpusnark/backend/groth16/solidity.py: same code.
"""

from __future__ import annotations

from ...curves.ref import P, R
from .keys import VerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Generated by tpusnark ExportSolidity — Groth16 BN254 verifier.
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 private constant Q = {q};
    uint256 private constant R = {r};

    // Verifying key
    uint256 private constant ALPHA_X = {alpha_x};
    uint256 private constant ALPHA_Y = {alpha_y};
    uint256 private constant BETA_X1 = {beta_x1};
    uint256 private constant BETA_X0 = {beta_x0};
    uint256 private constant BETA_Y1 = {beta_y1};
    uint256 private constant BETA_Y0 = {beta_y0};
    uint256 private constant GAMMA_X1 = {gamma_x1};
    uint256 private constant GAMMA_X0 = {gamma_x0};
    uint256 private constant GAMMA_Y1 = {gamma_y1};
    uint256 private constant GAMMA_Y0 = {gamma_y0};
    uint256 private constant DELTA_X1 = {delta_x1};
    uint256 private constant DELTA_X0 = {delta_x0};
    uint256 private constant DELTA_Y1 = {delta_y1};
    uint256 private constant DELTA_Y0 = {delta_y0};

{k_constants}

    error InvalidProof();
    error InvalidInputLength();

    function negate(uint256 x, uint256 y) internal pure returns (uint256, uint256) {{
        if (x == 0 && y == 0) return (0, 0);
        return (x, Q - (y % Q));
    }}

    /// K(input) = K0 + sum_i input[i] * K_{{i+1}} via ecAdd/ecMul precompiles.
    function publicInputMSM(uint256[{n_inputs}] calldata input)
        internal view returns (uint256 x, uint256 y)
    {{
        bool ok;
        uint256[4] memory add_in;
        uint256[3] memory mul_in;
        uint256[2] memory acc = [K_X_0, K_Y_0];
{k_msm}
        x = acc[0];
        y = acc[1];
        // silence unused warnings for 0-input circuits
        ok = ok; add_in[0] = add_in[0]; mul_in[0] = mul_in[0];
    }}

    /// @notice verify a Groth16 proof.
    /// @param proof [Ax, Ay, Bx1, Bx0, By1, By0, Cx, Cy]
    /// @param input the public inputs (field elements < R)
    function verifyProof(uint256[8] calldata proof, uint256[{n_inputs}] calldata input)
        public view
    {{
        for (uint256 i = 0; i < {n_inputs}; i++) {{
            if (input[i] >= R) revert InvalidProof();
        }}
        (uint256 kx, uint256 ky) = publicInputMSM(input);
        (uint256 nax, uint256 nay) = negate(proof[0], proof[1]);

        uint256[24] memory pairings;
        // e(-A, B)
        pairings[0] = nax;
        pairings[1] = nay;
        pairings[2] = proof[2];
        pairings[3] = proof[3];
        pairings[4] = proof[4];
        pairings[5] = proof[5];
        // e(alpha, beta)
        pairings[6] = ALPHA_X;
        pairings[7] = ALPHA_Y;
        pairings[8] = BETA_X1;
        pairings[9] = BETA_X0;
        pairings[10] = BETA_Y1;
        pairings[11] = BETA_Y0;
        // e(K(input), gamma)
        pairings[12] = kx;
        pairings[13] = ky;
        pairings[14] = GAMMA_X1;
        pairings[15] = GAMMA_X0;
        pairings[16] = GAMMA_Y1;
        pairings[17] = GAMMA_Y0;
        // e(C, delta)
        pairings[18] = proof[6];
        pairings[19] = proof[7];
        pairings[20] = DELTA_X1;
        pairings[21] = DELTA_X0;
        pairings[22] = DELTA_Y1;
        pairings[23] = DELTA_Y0;

        uint256[1] memory out;
        bool ok;
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 8, pairings, 768, out, 32)
        }}
        if (!ok || out[0] != 1) revert InvalidProof();
    }}
}}
"""

_K_CONST = "    uint256 private constant K_X_{i} = {x};\n    uint256 private constant K_Y_{i} = {y};"

_K_MSM_STEP = """\
        mul_in[0] = K_X_{j};
        mul_in[1] = K_Y_{j};
        mul_in[2] = input[{i}];
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 7, mul_in, 96, add_in, 64)
        }}
        if (!ok) revert InvalidProof();
        add_in[2] = acc[0];
        add_in[3] = acc[1];
        assembly ("memory-safe") {{
            ok := staticcall(gas(), 6, add_in, 128, acc, 64)
        }}
        if (!ok) revert InvalidProof();"""


def _xy(pt):
    return (0, 0) if pt is None else (int(pt[0]) % P, int(pt[1]) % P)


def _g2_words(pt):
    """EIP-197 G2 word order: imaginary (c1) first."""
    if pt is None:
        return (0, 0, 0, 0)
    x, y = pt
    return (x.c1 % P, x.c0 % P, y.c1 % P, y.c0 % P)


def export_solidity(vk: VerifyingKey) -> str:
    """Solidity source of a verifier contract for this vk.

    BSB22 commitment verification needs in-contract hash-to-field and the
    Pedersen fold — not generated yet (the reference supports exactly one
    commitment there; we refuse instead of silently dropping it)."""
    if vk.commitment_key is not None or any(vk.public_and_commitment_committed):
        raise NotImplementedError(
            "solidity export for commitment circuits not supported yet"
        )
    n_inputs = len(vk.k) - 1
    ax, ay = _xy(vk.alpha_g1)
    bx1, bx0, by1, by0 = _g2_words(vk.beta_g2)
    gx1, gx0, gy1, gy0 = _g2_words(vk.gamma_g2)
    dx1, dx0, dy1, dy0 = _g2_words(vk.delta_g2)
    k_consts = []
    for i, pt in enumerate(vk.k):
        x, y = _xy(pt)
        k_consts.append(_K_CONST.format(i=i, x=x, y=y))
    k_msm = "\n".join(_K_MSM_STEP.format(i=i, j=i + 1) for i in range(n_inputs))
    return _TEMPLATE.format(
        q=P,
        r=R,
        alpha_x=ax,
        alpha_y=ay,
        beta_x1=bx1,
        beta_x0=bx0,
        beta_y1=by1,
        beta_y0=by0,
        gamma_x1=gx1,
        gamma_x0=gx0,
        gamma_y1=gy1,
        gamma_y0=gy0,
        delta_x1=dx1,
        delta_x0=dx0,
        delta_y1=dy1,
        delta_y0=dy0,
        k_constants="\n".join(k_consts),
        n_inputs=n_inputs,
        k_msm=k_msm,
    )


def proof_to_solidity_calldata(proof) -> list[int]:
    """The uint256[8] array verifyProof expects (EIP-197 G2 word order)."""
    ax, ay = _xy(proof.ar)
    bx1, bx0, by1, by0 = _g2_words(proof.bs)
    cx, cy = _xy(proof.krs)
    return [ax, ay, bx1, bx0, by1, by0, cx, cy]
