"""PLONK key and proof containers (counterpart of
tpusnark/backend/plonk/keys.py).

Reference shapes: ProvingKey/VerifyingKey/Trace at
gnark/backend/plonk/bn254/setup.go:62-107 and the Proof struct in
backend/plonk/bn254/prove.go. The proving key keeps every prover table on
its device (coefficient forms and the coset-slice tables), the analog of
gnark's in-memory trace and lazy iop basis conversions.

Proof format: gnark's linearized-polynomial variant
(backend/plonk/bn254/prove.go:707-836) — one batched KZG opening at zeta
over [foldedH, linearizedPolynomial, l, r, o, s1, s2] plus the Z opening at
omega*zeta.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class PlonkVerifyingKey:
    n: int  # domain size
    generator: int  # omega
    k1: int
    k2: int
    n_public: int
    # G1 commitments
    ql: tuple
    qr: tuple
    qm: tuple
    qo: tuple
    qc: tuple
    s1: tuple
    s2: tuple
    s3: tuple
    # KZG verification points
    g2: tuple  # (G2, tau*G2)
    # BSB22 (reference setup.go:90-107): qcp selector commitments + the
    # challenge-injection rows (pre-public-offset, gnark convention)
    qcp: list = field(default_factory=list)
    commitment_constraint_indexes: list = field(default_factory=list)

    def digest_points(self) -> list:
        """Points bound to "gamma", in gnark's bindPublicData order
        (gnark/backend/plonk/bn254/verify.go:296-341): the permutation
        commitments S1,S2,S3 first, then the coefficient commitments
        Ql,Qr,Qm,Qo,Qk, then Qcp."""
        return [
            self.s1,
            self.s2,
            self.s3,
            self.ql,
            self.qr,
            self.qm,
            self.qo,
            self.qc,
        ] + list(self.qcp)


def identity_columns(f, omega_pows, k1: int, k2: int) -> torch.Tensor:
    """(words, 3, n): omega^i, k1 omega^i and k2 omega^i, the identity
    permutation's values; flattened, slot col * n + row."""
    return torch.stack([omega_pows, f.mul_const(omega_pows, k1), f.mul_const(omega_pows, k2)], dim=1)


def _pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    """x (words, k) zero-padded on the right to (words, m)."""
    return torch.cat([x, x.new_zeros((x.shape[0], m - x.shape[1]))], dim=1)


@dataclass
class PlonkProvingKey:
    """Prover tables, on one device (the one setup ran on). The quotient
    runs gnark's rho-loop (computeNumerator, reference prove.go:980-1045):
    the numerator is evaluated one size-n coset slice at a time, so the key
    stores only size-n coefficient forms plus 4 slice-scale rows."""

    vk: PlonkVerifyingKey
    srs: object  # kzg.SRS
    domain_n: int
    # device tables, (words, n) Montgomery coefficient forms
    q_coeffs: dict  # name -> (words, n)
    s_coeffs: dict  # "s1"/"s2"/"s3" -> (words, n)
    # rho-loop slice tables: coset_scale[r][i] = (shift * w4^r)^i, (words, n)
    coset_scale: list = None
    omega_pows: object = None  # (words, n) Montgomery powers of the n-th root
    slice_shift: list = None  # host ints s_r = shift * w4^r
    slice_xn: list = None  # host ints s_r^n (x^n is constant per slice)
    # permutation values on H (for the grand product): s1, s2, s3 as
    # (words, 3, n) Montgomery words on the device, where tpusnark keeps
    # host int lists (s_evals_int)
    s_lag: object = None
    # BSB22 qcp selector tables, one per commitment
    qcp_coeffs: list = None  # [(words, n) Montgomery coefficient forms]

    def __post_init__(self):
        if self.qcp_coeffs is None:
            self.qcp_coeffs = []

    @property
    def device(self) -> torch.device:
        return self.omega_pows.device

    def dev(self):
        """The prover's device tables, built once per key on its device:
        identity and permutation columns for the grand product, omega powers
        for z(omega X), and the padded coefficient stacks the opening stage
        combines linearly."""
        tab = self.__dict__.get("_devtab")
        if tab is not None:
            return tab
        from ...fields.spec import BN254_FR
        from ...fields.tfield import get_field

        f = get_field(BN254_FR)
        vk = self.vk
        id1 = self.omega_pows  # omega^i
        ids = identity_columns(f, id1, vk.k1, vk.k2)
        maxm = self.domain_n + 3  # z_hat length (3 blinders)
        # omega^n = 1, so omega^i for i < n + 3 wraps around the row
        wpow = torch.cat([id1, id1[:, :3]], dim=1)
        # open/linearization stacks over PK columns (padded to maxm)
        lin_base = torch.stack(
            [_pad_to(self.q_coeffs[k], maxm) for k in ("ql", "qr", "qm", "qo", "qc")]
            + [_pad_to(self.s_coeffs["s3"], maxm)],
            dim=1,
        )  # (words, 6, maxm)
        s12 = torch.stack([_pad_to(self.s_coeffs[k], maxm) for k in ("s1", "s2")], dim=1)
        qcp_stack = torch.stack([_pad_to(c, maxm) for c in self.qcp_coeffs], dim=1) if self.qcp_coeffs else None
        tab = {
            "ids": ids,  # (words, 3, n)
            "s_lag": self.s_lag,  # (words, 3, n)
            "wpow": wpow,  # (words, maxm)
            "lin_base": lin_base,
            "s12": s12,
            "qcp_stack": qcp_stack,
            "maxm": maxm,
        }
        self.__dict__["_devtab"] = tab
        return tab


@dataclass
class PlonkProof:
    """gnark-shape PLONK proof (reference Proof struct,
    backend/plonk/bn254/prove.go:96-113): LRO + Z + H commitments, ONE
    batched opening at zeta over [foldedH, linearizedPolynomial, l, r, o,
    s1, s2] (claimed values in that order), and the Z opening at
    omega*zeta."""

    # commitments
    l_com: tuple
    r_com: tuple
    o_com: tuple
    z_com: tuple
    h1_com: tuple
    h2_com: tuple
    h3_com: tuple
    bsb22_commitments: list
    # batched opening at zeta (gnark BatchedProof)
    batched_h: tuple  # KZG quotient commitment W_zeta
    claimed_values: list  # [H(z), lin(z), l(z), r(z), o(z), s1(z), s2(z)]
    # Z opened at omega*zeta (gnark ZShiftedOpening)
    z_shifted_h: tuple
    z_shifted_value: int
