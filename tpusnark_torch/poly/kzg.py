"""KZG polynomial commitments over BN254 (counterpart of tpusnark/poly/kzg.py).

gnark-crypto's kzg surface as the PLONK backend uses it: SRS, Commit, Open,
BatchOpenSinglePoint and the (batch) verifiers
(gnark/backend/plonk/bn254/prove.go:336,494,646,769,823 and
setup.go:129-138).

Commit is one G1 MSM over the SRS points (``msm/pippenger.py``; k
polynomials over the same points share one composite-key MSM, ``MSM.many``).
Open is a synthetic division by (X - z), run as a log-depth scan of affine
maps (``poly/scan.py``), plus one MSM. The SRS is made on the device of the
caller's choice by one batched fixed-base multiplication. Verification
pairings stay on the host: the host half below is tpusnark's code.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..curves.ref import G1, G2, R, pairing_check
from ..fields.spec import BN254_FP, BN254_FR
from ..fields.tfield import compute_device, get_field
from ..msm.pippenger import get_msm_for, get_msm_many_for
from .scan import div_linear

_fr = get_field(BN254_FR)
_fp = get_field(BN254_FP)

# below this many powers the SRS points are host scalar multiplications
DEVICE_SRS_MIN = 1 << 10


@dataclass
class SRS:
    """Powers-of-tau structured reference string (G1 side + [1, tau] in G2).

    g1: list of affine G1 points [tau^i * G]; g2: (G2, tau*G2). The device
    copy of g1 is made on first use, once per device."""

    g1: list
    g2: tuple
    _dev: dict = None

    def device(self, device="cuda") -> dict:
        """{"g1": (X, Y, inf)} on `device`: the card, unless the caller
        names the CPU."""
        from ..curves.encoding import g1_to_device

        device = compute_device(device)
        if self._dev is None:
            self._dev = {}
        tab = self._dev.get(str(device))
        if tab is None:
            tab = self._dev[str(device)] = {"g1": g1_to_device(self.g1, _fp, device)}
        return tab


def new_srs_unsafe(size: int, tau: int | None = None, device="cuda") -> SRS:
    """Test-only SRS from a known tau (the analog of gnark's
    test/kzg_srs.go unsafe cached SRS). From DEVICE_SRS_MIN powers up, the
    points are one batched fixed-base multiplication on
    `device` (the card, unless the caller names the CPU; one B5 launch a
    scalar bit), normalised to affine there, and that table becomes the
    SRS's device copy; below, host scalar multiplications."""
    tau = tau if tau is not None else secrets.randbelow(R - 2) + 2
    powers = []
    t = 1
    for _ in range(size):
        powers.append(t)
        t = t * tau % R

    srs = SRS(g1=[], g2=(G2.generator(), G2.mul(G2.generator(), tau)))
    if size >= DEVICE_SRS_MIN:
        from ..backend.groth16.setup import to_affine, to_host
        from ..curves.batch_mul import FixedBaseMul, g1_generator_ladder
        from ..curves.config import get_curve
        from ..curves.tcurve import curve_ops

        device = compute_device(device)
        ops = curve_ops("bn254")[0]
        mul = FixedBaseMul(ops, _fr)
        table = g1_generator_ladder(_fp, mul.n_bits, "bn254", device)
        aff = to_affine(ops, mul(table, _fr.encode(powers, mont=False, device=device)))
        srs.g1 = to_host(ops, aff, get_curve("bn254").host)
        srs._dev = {str(device): {"g1": aff}}
    else:
        srs.g1 = [G1.mul(G1.generator(), s) for s in powers]
    return srs


def scalar(x: int, device):
    """A (words,) Montgomery fr scalar on `device`, uncached (Field.const
    keeps every constant it makes; a prover's challenges change per proof)."""
    return _fr.encode([x], device=device)[:, 0]


# --------------------------------------------------------------------- commit
def _points(srs: SRS, coeffs, m: int):
    """The first m SRS points on the device of coeffs, each coordinate
    contiguous (the MSM's operand)."""
    pts = srs.device(coeffs.device)["g1"]
    npts = pts[2].shape[0]
    assert m <= npts, "polynomial larger than SRS"
    return tuple(a[..., :m].contiguous() for a in pts) if m < npts else pts


def commit_dev(srs: SRS, coeffs_norm) -> tuple:
    """coeffs_norm: (words, m) NORMAL-form fr words on a device, m <=
    len(srs.g1). Returns an affine host point."""
    from ..curves.encoding import g1_from_device_proj

    m = coeffs_norm.shape[1]
    raw = get_msm_for("g1", m, "bn254")(_points(srs, coeffs_norm, m), coeffs_norm)
    (out,) = g1_from_device_proj(raw, _fp)
    return out


def commit_many_dev(srs: SRS, coeffs_norm_k) -> list:
    """Batched commit: coeffs (words, k, m) NORMAL-form fr words over the
    SRS. Returns k affine host points from ONE composite-key MSM (MSM.many):
    k same-SRS commits share one sort and one strip pass per window — the
    answer to the reference prover's goroutine-parallel KZG commits
    (gnark/backend/plonk/bn254/prove.go:139-169)."""
    from ..curves.encoding import g1_from_device_proj

    k, m = coeffs_norm_k.shape[1], coeffs_norm_k.shape[2]
    raw = get_msm_many_for("g1", m, k, "bn254").many(_points(srs, coeffs_norm_k, m), coeffs_norm_k)
    return g1_from_device_proj(raw, _fp)


def commit_ints(srs: SRS, coeffs: list[int], device="cuda") -> tuple:
    """Host-int convenience commit (small polynomials / tests): from 2^8
    coefficients an MSM on `device` (the card, unless the caller names the
    CPU), below a host sum."""
    if len(coeffs) >= (1 << 8):
        return commit_dev(srs, _fr.encode(coeffs, mont=False, device=compute_device(device)))
    acc = None
    for c, pt in zip(coeffs, srs.g1):
        if c % R:
            acc = G1.add(acc, G1.mul(pt, c))
    return acc


# ----------------------------------------------------------------- open / div
def _div_by_linear_host(coeffs: list[int], z: int) -> tuple[list[int], int]:
    """q(X) = (p(X) - p(z)) / (X - z); returns (q coeffs, p(z))."""
    n = len(coeffs)
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R
        q[i - 1] = acc
    pz = (acc * z + coeffs[0]) % R
    return q, pz


def div_by_linear_dev(coeffs_mont, z: int):
    """Device synthetic division: coeffs (words, *batch, n) Montgomery ->
    (q (words, *batch, n-1) Montgomery, p(z) (words, *batch) words).
    q_j = sum_{i>j} p_i z^(i-j-1), by a scan of the affine maps
    f_i(x) = z*x + p_i composed high-to-low (log depth, poly/scan.py)."""
    return div_linear(_fr, coeffs_mont, scalar(z, coeffs_mont.device))


def eval_many_dev(coeffs_mont, z: int) -> list[int]:
    """Evaluate a batch of polynomials at z: coeffs (words, B, m) Montgomery
    -> list of B ints (one Horner scan for the whole batch)."""
    _q, pz = div_by_linear_dev(coeffs_mont, z)
    return _fr.decode(pz)


def open_dev(srs: SRS, coeffs_mont, z: int):
    """KZG opening proof at z from Montgomery coeffs (words, n) on a device.
    Returns (claimed_value int, proof point H)."""
    q, pz_words = div_by_linear_dev(coeffs_mont, z)
    (pz,) = _fr.decode(pz_words)
    if q.shape[1] == 0:
        return pz, None
    return pz, commit_dev(srs, _fr.from_mont(q))


def open_ints(srs: SRS, coeffs: list[int], z: int, device="cuda"):
    q, pz = _div_by_linear_host(coeffs, z)
    return pz, commit_ints(srs, q, device)


# ---------------------------------------------------------------------- verify
def verify_opening(srs: SRS, commitment, z: int, value: int, proof) -> bool:
    """e(C - value*G1 + z*H, G2) == e(H, tau*G2)
    i.e. pairing_check([(C - v*G + z*H, G2), (-H, tau G2)])."""
    lhs = G1.add(commitment, G1.neg(G1.mul(G1.generator(), value)))
    lhs = G1.add(lhs, G1.mul(proof, z)) if proof is not None else lhs
    if proof is None:
        return lhs is None
    return pairing_check([(lhs, srs.g2[0]), (G1.neg(proof), srs.g2[1])])


def batch_verify_multi_points(srs: SRS, entries: list, lam: int | None = None) -> bool:
    """Verify several KZG openings (commitment, point, value, proofH) with
    one 2-pairing check (gnark-crypto kzg.BatchVerifyMultiPoints):
      F  = sum lam^i (C_i - v_i*G + z_i*H_i),  Hf = sum lam^i H_i
      e(F, G2) == e(Hf, tau*G2).

    lam defaults to fresh verifier-local randomness, sampled AFTER the proof
    is fixed — exactly gnark-crypto's discipline. A Fiat-Shamir lam that the
    prover can predict without binding the H_i quotient points is forgeable:
    the prover solves for H2 with H2(z2)=Q(z2)/(lam*(z2-z1)) and passes the
    combined check with false claimed values."""
    if lam is None:
        import secrets

        lam = secrets.randbelow(R - 1) + 1
    F = None
    Hf = None
    ch = 1
    for c, z, v, h in entries:
        t = G1.add(c, G1.neg(G1.mul(G1.generator(), v)))
        if h is not None:
            t = G1.add(t, G1.mul(h, z))
            Hf = G1.add(Hf, G1.mul(h, ch))
        F = G1.add(F, G1.mul(t, ch))
        ch = ch * lam % R
    if Hf is None:
        return F is None
    return pairing_check([(F, srs.g2[0]), (G1.neg(Hf), srs.g2[1])])


def batch_verify_single_point(
    srs: SRS, commitments: list, z: int, values: list[int], proof, fold_challenge: int
) -> bool:
    """Verify a folded opening of several polynomials at one point
    (gnark kzg.BatchVerifySinglePoint shape): fold commitments and claimed
    values with powers of the challenge, then one pairing check."""
    acc_c = None
    acc_v = 0
    ch = 1
    for c, v in zip(commitments, values):
        if c is not None:
            acc_c = G1.add(acc_c, G1.mul(c, ch))
        acc_v = (acc_v + ch * v) % R
        ch = ch * fold_challenge % R
    return verify_opening(srs, acc_c, z, acc_v, proof)
