"""PLONK setup over BN254 on torch tensors (counterpart of
tpusnark/backend/plonk/setup.py): trace building, permutation, commitments.

Reference behavior being reproduced: gnark/backend/plonk/bn254/setup.go:110-161
(Setup), :175 (BuildTrace: selector columns from the sparse gates), :304
(buildPermutation: sigma over 3n slots from wire equalities), :363
(computePermutationPolynomials: S1,S2,S3 interpolation + coset ids), :229
(commitTrace: KZG commitments of the 8 trace polynomials).

``_next_pow2``, ``pick_cosets`` and ``build_permutation`` are tpusnark's host
code. The columns are made on the device: each selector column is a gather
from the circuit's few encoded coefficients by coefficient id, each
permutation column a gather from the identity columns (omega^i, k1 omega^i,
k2 omega^i) by sigma (tpusnark keeps the permutation values as host int
lists, ``s_evals_int``), and the coset-slice tables are powers built by
doubling with B1 (``NTT.powers``); all equal tpusnark's host lists mod p.
Every column is interpolated by the port's INTT and committed by
``kzg.commit_dev``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constraint.scs import SparseConstraintSystem
from ...fields.spec import BN254_FR
from ...fields.tfield import compute_device, get_field
from ...poly import kzg
from ...poly.domain import Domain
from ...poly.ntt import get_ntt
from .keys import PlonkProvingKey, PlonkVerifyingKey, identity_columns

_fr = get_field(BN254_FR)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pick_cosets(n: int, p: int) -> tuple[int, int]:
    """k1, k2 with H, k1 H, k2 H pairwise disjoint (k^n != 1 checks)."""
    ks = []
    k = 2
    while len(ks) < 2:
        ok = pow(k, n, p) != 1
        for prev in ks:
            ok = ok and pow(k * pow(prev, -1, p) % p, n, p) != 1
        if ok:
            ks.append(k)
        k += 1
    return ks[0], ks[1]


def build_permutation(cs: SparseConstraintSystem, n: int) -> list[int]:
    """sigma over 3n slots (slot = col*n + row). Wires' slot lists become
    cycles; padding slots are fixed points. Mirrors buildPermutation
    (setup.go:304)."""
    sigma = list(range(3 * n))
    slots_of_wire: dict[int, list[int]] = {}
    for row, g in enumerate(cs.gates):
        for col, w in enumerate((g.xa, g.xb, g.xc)):
            slots_of_wire.setdefault(w, []).append(col * n + row)
    for slots in slots_of_wire.values():
        m = len(slots)
        for i, s in enumerate(slots):
            sigma[s] = slots[(i + 1) % m]
    return sigma


def selector_columns(cs: SparseConstraintSystem, n: int, device) -> dict:
    """{"qL", "qR", "qO", "qM", "qC"} -> (words, n) Montgomery columns on
    `device`: the circuit's coefficients encoded once and gathered by each
    gate's coefficient id; the padding rows take id 0, the coefficient 0."""
    table = _fr.encode(cs.coeffs, device=device)
    out = {}
    for name in ("qL", "qR", "qO", "qM", "qC"):
        ids = np.zeros(n, dtype=np.int64)
        ids[: cs.n_gates] = np.fromiter((getattr(g, name) for g in cs.gates), dtype=np.int64, count=cs.n_gates)
        out[name] = table.index_select(1, torch.from_numpy(ids).to(device))
    return out


def setup(cs: SparseConstraintSystem, srs: kzg.SRS | None = None, tau: int | None = None, device="cuda"):
    """(pk, vk), with the prover's tables and the commitments computed on
    `device`: the card, unless the caller names the CPU. srs must cover
    >= n+3 G1 powers (blinded wire polys); without one, an unsafe SRS from
    `tau` is made on the same device."""
    device = compute_device(device)
    p = cs.modulus
    assert p == _fr.spec.modulus, "plonk backend is BN254-only for now"
    # n >= 8 so the quotient's 3 chunks (3n+6 coeffs) fit the 4n coset domain
    n = _next_pow2(max(8, cs.n_gates))
    if srs is None:
        srs = kzg.new_srs_unsafe(n + 3, tau=tau, device=device)
    assert len(srs.g1) >= n + 3, "SRS too small for domain"

    dom = Domain(BN254_FR, n)
    ntt_n = get_ntt(BN254_FR, n, device)
    f = _fr
    k1, k2 = pick_cosets(n, p)

    # ---- permutation columns: slot t = col * n + row of the identity
    # columns holds k_col * omega^row (k = 1, k1, k2), and the permutation
    # column's slot s holds the identity's slot sigma(s): a gather -----------
    sigma = build_permutation(cs, n)
    omega_pows = ntt_n.powers(dom.generator, n)
    ids = identity_columns(f, omega_pows, k1, k2).view(f.n, 3 * n)
    s_lag = ids.index_select(1, torch.tensor(sigma, dtype=torch.int64, device=device)).view(f.n, 3, n)

    # ---- interpolations (device INTT) ---------------------------------------
    name_map = {"qL": "ql", "qR": "qr", "qM": "qm", "qO": "qo", "qC": "qc"}
    q_coeffs = {name_map[k]: ntt_n.intt(v) for k, v in selector_columns(cs, n, device).items()}
    s_coeffs = {k: ntt_n.intt(s_lag[:, i]) for i, k in enumerate(("s1", "s2", "s3"))}

    # ---- BSB22 qcp selector columns (reference setup.go:90-107: 1 at each
    # committed row, rows already carry the public offset here) --------------
    qcp_coeffs = []
    for cm in cs.commitments:
        evals = f.zeros((n,), device=device)
        rows = torch.tensor([cs.n_public + r for r in cm.committed], dtype=torch.int64, device=device)
        evals[:, rows] = f.one(device)[:, None]
        qcp_coeffs.append(ntt_n.intt(evals))

    # ---- rho-loop slice tables (gnark computeNumerator, prove.go:980-1045):
    # the 4n coset splits into 4 size-n cosets s_r * H with s_r = shift*w4^r;
    # evaluating any coefficient form on slice r = scale coeff i by s_r^i
    # then one size-n NTT. x^n is CONSTANT on a slice (= s_r^n), so Z_H and
    # the tail-fold of (n+k)-degree blinded polys are per-slice scalars.
    big = Domain(BN254_FR, 4 * n)
    w4 = big.generator
    shift = big.coset_shift
    slice_shift = [shift * pow(w4, r, p) % p for r in range(4)]
    slice_xn = [pow(s, n, p) for s in slice_shift]
    coset_scale = [ntt_n.powers(s, n) for s in slice_shift]

    # ---- commitments ---------------------------------------------------------
    def commit(coeffs_mont):
        return kzg.commit_dev(srs, f.from_mont(coeffs_mont))

    vk = PlonkVerifyingKey(
        n=n,
        generator=dom.generator,
        k1=k1,
        k2=k2,
        n_public=cs.n_public,
        ql=commit(q_coeffs["ql"]),
        qr=commit(q_coeffs["qr"]),
        qm=commit(q_coeffs["qm"]),
        qo=commit(q_coeffs["qo"]),
        qc=commit(q_coeffs["qc"]),
        s1=commit(s_coeffs["s1"]),
        s2=commit(s_coeffs["s2"]),
        s3=commit(s_coeffs["s3"]),
        g2=srs.g2,
        qcp=[commit(c) for c in qcp_coeffs],
        commitment_constraint_indexes=[cm.commitment_index for cm in cs.commitments],
    )
    pk = PlonkProvingKey(
        vk=vk,
        srs=srs,
        domain_n=n,
        q_coeffs=q_coeffs,
        s_coeffs=s_coeffs,
        coset_scale=coset_scale,
        omega_pows=omega_pows,
        slice_shift=slice_shift,
        slice_xn=slice_xn,
        s_lag=s_lag,
        qcp_coeffs=qcp_coeffs,
    )
    return pk, vk
