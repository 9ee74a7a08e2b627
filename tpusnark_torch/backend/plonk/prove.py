"""PLONK prover over BN254 on torch tensors (counterpart of
tpusnark/backend/plonk/prove.py): the reference's dataflow
(gnark/backend/plonk/bn254/prove.go:116-1079) as a few stages of device
work between the transcript points:

  solve -> [wires] intt + blind L,R,O -> batched commit -> FS gamma,beta ->
  [z] grand product Z (two prefix-product scans and one batched Fermat
  inversion, replacing iop.BuildRatioCopyConstraint prove.go:600) + blind
  -> commit -> FS alpha -> [quotient] the four rho-loop coset slices
  (computeNumerator prove.go:837-1079) + the 4n coset INTT + the h split ->
  batched commit h1,h2,h3 -> FS zeta -> [open1] folded H, the evaluations
  at zeta and omega*zeta, the Z-shift quotient -> host scalars -> [lin]
  linearized polynomial -> commit -> fold challenge -> [fold] nu-folded
  opening quotient -> batched commit.

Every stage is a plain function on (words, ...) Montgomery tensors on the
proving key's device: on the card each field op is one kernel launch (B1,
B2, add, sub), each NTT a bit-reverse gather and the pass kernel (B3/B4),
each commit an MSM (B5/B6). tpusnark jits each stage; here they run
eagerly, and the NTTs of a coset slice are one batched transform. KZG
commits that land between the same two challenges share one composite-key
MSM (kzg.commit_many_dev). The rng is drawn in tpusnark's order (the BSB22
hint's 2 blinders per commitment, then 6 for l, r, o, then 3 for z), so the
same rng gives tpusnark's proof.
"""

from __future__ import annotations

import secrets
import time

import numpy as np
import torch

from ...constraint.scs import SparseConstraintSystem, solve_scs
from ...fields.spec import BN254_FR
from ...fields.tfield import get_field
from ...poly import kzg
from ...poly.iop import Basis, Layout, Polynomial
from ...poly.ntt import get_ntt
from ...poly.scan import div_linear, horner_evals, prefix_mul
from ...utils.transcript import Transcript, fr_bytes, g1_bytes, kzg_fold_challenge
from .keys import PlonkProof, PlonkProvingKey, _pad_to

_fr = get_field(BN254_FR)

# batched-opening order at zeta (gnark batchOpening, prove.go:777-836:
# [foldedH, linearizedPolynomial, l, r, o, s1, s2]); verifier must match
FOLD_ORDER = ("folded_h", "lin", "l", "r", "o", "s1", "s2")

# gnark's main transcript registers exactly these four (prove.go:243); the
# KZG batch-opening fold challenge lives in its own fresh transcript
# (utils.transcript.kzg_fold_challenge), NOT here.
CHALLENGES = ("gamma", "beta", "alpha", "zeta")

# rows of the per-slice stack the quotient evaluates (after the qcp and
# BSB22 rows, and the slice scale itself for L1)
_L, _R, _O, _Z, _ZW, _PI = range(6)
_Q = {"ql": 6, "qr": 7, "qm": 8, "qo": 9, "qc": 10}
_S = 11  # s1, s2, s3
_N_FIXED = 14


def _bc(c, like):
    return _fr.broadcast_const(c, like)


def _blind(coeffs, blinders, n: int, m: int):
    """coeffs (words, <=n) + Z_H(X) * sum b_i X^i  (Z_H = X^n - 1), blinders
    a (words, nb) Montgomery tensor; returns (words, m) with m = n + nb."""
    f = _fr
    nb = blinders.shape[1]
    assert m == n + nb
    out = _pad_to(coeffs, m)
    out[:, n:] = f.add(out[:, n:], blinders)
    out[:, :nb] = f.sub(out[:, :nb], blinders)
    return out


def _sparse_column(entries: dict, n: int, device):
    """(words, n) Montgomery column, zero but at the rows of `entries`
    ({row: int}), encoded on the host one value a row."""
    col = _fr.zeros((n,), device=device)
    if entries:
        rows = torch.tensor(list(entries), dtype=torch.int64, device=device)
        col[:, rows] = _fr.encode(list(entries.values()), device=device)
    return col


def _wire_ids(cs: SparseConstraintSystem, n: int) -> torch.Tensor:
    """(3, n) int64 wire ids of the l, r, o columns; the padding rows read
    wire n_wires (a zero appended to W)."""
    ids = np.full((3, n), cs.n_wires, dtype=np.int64)
    for col, name in enumerate(("xa", "xb", "xc")):
        ids[col, : cs.n_gates] = np.fromiter((getattr(g, name) for g in cs.gates), dtype=np.int64, count=cs.n_gates)
    return torch.from_numpy(ids)


def _lin(cols, tbl, beta_m, gamma_m):
    """cols + beta * tbl + gamma, (words, 3, n): the grand product's factors
    of the l, r, o columns at once."""
    f = _fr
    return f.add(f.add(cols, f.mul(_bc(beta_m, tbl), tbl)), _bc(gamma_m, tbl))


def _prod3(x):
    """The product of the three rows of x (words, 3, n)."""
    return _fr.mul(_fr.mul(x[:, 0], x[:, 1]), x[:, 2])


# --- stages ------------------------------------------------------------------
def wires_stage(ntt_n, lro, bl):
    """lro evals (words, 3, n) + blinders (words, 3, 2) -> (hats (words, 3,
    n+2), their normal form)."""
    n = ntt_n.n
    lro_c = ntt_n.intt(lro)
    hats = torch.stack([_blind(lro_c[:, i], bl[:, i], n, n + 2) for i in range(3)], dim=1)
    return hats, _fr.from_mont(hats)


def z_stage(ntt_n, lro, ids, s_lag, gamma_m, beta_m, zbl):
    """Grand-product Z (iop.BuildRatioCopyConstraint analog, reference
    prove.go:600) + blinding: -> (z_hat (words, n+3), its normal form)."""
    f = _fr
    n = ntt_n.n
    pnum = prefix_mul(f, _prod3(_lin(lro, ids, beta_m, gamma_m)))
    pden = prefix_mul(f, _prod3(_lin(lro, s_lag, beta_m, gamma_m)))
    zfull = f.mul(pnum, f.inv(pden))
    one_col = _bc(f.one(zfull.device), zfull[:, :1])
    z_evals = torch.cat([one_col, zfull[:, : n - 1]], dim=1)
    z_hat = _blind(ntt_n.intt(z_evals), zbl, n, n + 3)
    return z_hat, f.from_mont(z_hat)


def quotient_consts(pk: PlonkProvingKey, gamma: int, beta: int, alpha: int) -> dict:
    """The quotient's scalars on the key's device: per slice r, s_r^n, the
    inverse of Z_H = s_r^n - 1 and s_r (fixed by the key, cached); the
    challenges and alpha^2 (per proof, not cached); 1/n."""
    f, p, dev = _fr, _fr.modulus, pk.device

    def key_const(x):
        return f.const(x, mont=True, device=dev)

    return {
        "xn": [key_const(xn) for xn in pk.slice_xn],
        "zh_inv": [key_const(pow((xn - 1) % p, -1, p)) for xn in pk.slice_xn],
        "s_r": [key_const(s_r) for s_r in pk.slice_shift],
        "gamma": kzg.scalar(gamma, dev),
        "beta": kzg.scalar(beta, dev),
        "a1": kzg.scalar(alpha, dev),
        "a2": kzg.scalar(alpha * alpha % p, dev),
        "n_inv": key_const(pow(pk.domain_n, -1, p)),
    }


def quotient_stage(ntt_n, ntt_4n, pk: PlonkProvingKey, polys, ccs, consts):
    """All four rho-loop coset slices (computeNumerator prove.go:980-1045)
    + 4n coset-INTT + h1/h2/h3 split. Slice r covers the 4n-coset points
    with index j == r (mod 4). polys: l, r, o, z, zw, pi coefficient forms;
    ccs: the BSB22 committed polynomials. Returns (h (words, 3, n+2), its
    normal form)."""
    f = _fr
    n = ntt_n.n
    tab = pk.dev()
    n_com = len(ccs)
    rows = [polys[k] for k in ("l", "r", "o", "z", "zw", "pi")]
    rows += [pk.q_coeffs[k] for k in _Q] + [pk.s_coeffs[k] for k in ("s1", "s2", "s3")]
    rows += list(pk.qcp_coeffs) + list(ccs)
    P = torch.stack([_pad_to(x, n + 3) for x in rows], dim=1)  # (words, B, n+3)
    head, tail = P[..., :3], P[..., n:]
    C = consts
    slices = []
    for r in range(4):
        sc = pk.coset_scale[r]
        # x^n is s_r^n on the slice: fold the tail (degree >= n) onto the head
        folded = torch.cat([f.add(head, f.mul(_bc(C["xn"][r], tail), tail)), P[..., 3:n]], dim=-1)
        # every column evaluated on the slice by one batched NTT, and the
        # slice scale itself: L1 = (x^n - 1)/(n (x - 1)) has all coefficients 1/n
        E = ntt_n.ntt(torch.cat([f.mul(folded, sc[:, None, :]), sc[:, None, :]], dim=1))
        lc, rc, oc, zc, zwc, pic = (E[:, i] for i in (_L, _R, _O, _Z, _ZW, _PI))
        q = {k: E[:, i] for k, i in _Q.items()}
        lro, s = E[:, _L : _O + 1], E[:, _S : _S + 3]
        ids = f.mul(_bc(C["s_r"][r], tab["ids"]), tab["ids"])  # s_r k_c omega^i
        l1 = f.mul(_bc(C["n_inv"], sc), E[:, -1])

        gate = f.add(
            f.add(f.mul(q["ql"], lc), f.mul(q["qr"], rc)),
            f.add(f.mul(q["qm"], f.mul(lc, rc)), f.add(f.mul(q["qo"], oc), q["qc"])),
        )
        gate = f.add(gate, pic)
        for i in range(n_com):
            gate = f.add(gate, f.mul(E[:, _N_FIXED + i], E[:, _N_FIXED + n_com + i]))
        beta, gamma = C["beta"], C["gamma"]
        perm = f.sub(
            f.mul(_prod3(_lin(lro, s, beta, gamma)), zwc), f.mul(_prod3(_lin(lro, ids, beta, gamma)), zc)
        )
        l1_term = f.mul(l1, f.sub(zc, _bc(f.one(zc.device), zc)))
        numer = f.add(
            gate,
            f.add(f.mul(_bc(C["a1"], perm), perm), f.mul(_bc(C["a2"], l1_term), l1_term)),
        )
        slices.append(f.mul(numer, _bc(C["zh_inv"][r], numer)))
    t_evals = torch.stack(slices, dim=-1).reshape(f.n, 4 * n)  # t[4j + r] = slice r at j
    t_c = ntt_4n.intt_coset(t_evals)
    m = n + 2
    h = torch.stack([t_c[:, :m], t_c[:, m : 2 * m], t_c[:, 2 * m : 3 * m]], dim=1)
    return h, f.from_mont(h)


def open1_stage(h, l_hat, r_hat, o_hat, z_hat, tab, zm, zm2, zeta_m, oz_m):
    """folded H + every evaluation the transcript needs + the Z-shift
    quotient: returns (folded_h (words, n+2), evals (words, 6+n_com), zu
    (words,), q2 normal form (words, n+2))."""
    f = _fr
    maxm = tab["maxm"]
    folded_h = f.add(h[:, 0], f.add(f.mul(_bc(zm, h[:, 1]), h[:, 1]), f.mul(_bc(zm2, h[:, 2]), h[:, 2])))
    stack = [_pad_to(x, maxm) for x in (l_hat, r_hat, o_hat)]
    stack += [tab["s12"][:, 0], tab["s12"][:, 1], _pad_to(folded_h, maxm)]
    if tab["qcp_stack"] is not None:
        stack += list(tab["qcp_stack"].unbind(1))
    evals = horner_evals(f, torch.stack(stack, dim=1), zeta_m)
    q2, zu = div_linear(f, z_hat, oz_m)  # zu = z(omega zeta)
    return folded_h, evals, zu, f.from_mont(q2)


def lin_stage(tab, z_hat, ccs, wts, zeta_m):
    """Linearized polynomial (computeLinearizedPolynomial prove.go:707-836)
    + its value at zeta: (lin (words, maxm), normal form, lin(zeta))."""
    f = _fr
    maxm = tab["maxm"]
    st = torch.cat([tab["lin_base"], torch.stack([_pad_to(c, maxm) for c in (z_hat, *ccs)], dim=1)], dim=1)
    lin = f.sum(f.mul(st, wts[:, :, None]), axis=1)
    return lin, f.from_mont(lin), horner_evals(f, lin[:, None, :], zeta_m)[:, 0]


def fold_stage(folded_h, lin, l_hat, r_hat, o_hat, tab, nupow, zeta_m):
    """nu-folded opening quotient (kzg.BatchOpenSinglePoint fold,
    prove.go:823): q = (sum nu^i p_i - v)/(X - zeta), returned NORMAL."""
    f = _fr
    maxm = tab["maxm"]
    stack = [_pad_to(x, maxm) for x in (folded_h, lin, l_hat, r_hat, o_hat)]
    stack += [tab["s12"][:, 0], tab["s12"][:, 1]]
    if tab["qcp_stack"] is not None:
        stack += list(tab["qcp_stack"].unbind(1))
    folded_poly = f.sum(f.mul(torch.stack(stack, dim=1), nupow[:, :, None]), axis=1)
    q, _ = div_linear(f, folded_poly, zeta_m)
    return f.from_mont(q)


class _LocalEngine:
    """Single-device commit/placement backend (default)."""

    @staticmethod
    def place(x):
        return x

    @staticmethod
    def commit(srs, coeffs_norm):
        return kzg.commit_dev(srs, coeffs_norm)

    @staticmethod
    def commit_many(srs, stack_norm):
        return kzg.commit_many_dev(srs, stack_norm)


_LOCAL_ENGINE = _LocalEngine()


def prove(
    cs: SparseConstraintSystem,
    pk: PlonkProvingKey,
    assignment: dict,
    rng=None,
    config=None,
    timings: dict | None = None,
    engine=None,
) -> PlonkProof:
    """PLONK proof of `assignment` for `cs` under `pk`, computed on the
    key's device (the one `setup` ran on).

    `timings`: optional per-phase wall-clock dict (solve / lro / z /
    quotient / open — the reference logs the whole-prover scope at
    backend/plonk/bn254/prove.go:175); timing synchronises the device
    between phases, so pass it only to measure.

    `engine`: commit/placement backend; None = single device (kzg device
    commits)."""
    from ..config import resolve

    device = pk.device

    def _mark(name, t0):
        if timings is None:
            return 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + (t - t0)
        return t

    pcfg = resolve(config, rng)
    if engine is None:
        engine = _LOCAL_ENGINE
    f = _fr
    p = cs.modulus
    n = pk.domain_n
    vk = pk.vk
    rand = pcfg.rng or (lambda: secrets.randbelow(p))
    ntt_n = get_ntt(BN254_FR, n, device)
    ntt_4n = get_ntt(BN254_FR, 4 * n, device)
    tab = pk.dev()

    def sc(x):  # a per-proof scalar on the device
        return kzg.scalar(x % p, device)

    # ---- 0. BSB22 commitments: the prover-side hint override computes the
    # REAL committed polynomial P_i (values at committed rows + blinding at
    # two qcp=0 rows), KZG-commits it, and derives the challenge by
    # hash-to-field of the commitment bytes (reference bsb22Hint,
    # prove.go:316-352; DST "BSB22-Plonk", backend.go:231-233) ----------------
    n_com = len(cs.commitments)
    bsb22_points: list = [None] * n_com
    bsb22_vals: list = [0] * n_com
    c_coeffs: list = [None] * n_com  # canonical coefficient forms of P_i
    overrides = None
    if n_com:
        from ...constraint.hints import bsb22_placeholder
        from ...curves.marshal import g1_raw
        from ...utils.hash_to_field import hash_to_field

        def bsb22_real(pm, ins):
            depth = int(ins[0])
            cm = cs.commitments[depth]
            vals = [int(v) % p for v in ins[1:]]
            evals = {cs.n_public + r: v for r, v in zip(cm.committed, vals)}
            # blinding at two qcp=0 rows: the commitment-injection row and
            # the last constraint row (prove.go:329-334)
            evals[cs.n_public + cm.commitment_index] = rand()
            evals[cs.n_gates - 1] = rand()
            coeffs = ntt_n.intt(_sparse_column(evals, n, device))
            c_coeffs[depth] = coeffs
            pt = kzg.commit_dev(pk.srs, f.from_mont(coeffs))
            bsb22_points[depth] = pt
            (ch,) = hash_to_field(g1_raw(pt), b"BSB22-Plonk", p)
            bsb22_vals[depth] = ch
            return [ch]

        overrides = {bsb22_placeholder: bsb22_real}

    # ---- 1. solve + wire columns -------------------------------------------
    if pcfg.hint_overrides:
        overrides = {**(overrides or {}), **pcfg.hint_overrides}
    t0 = time.perf_counter()
    W = solve_scs(cs, assignment, hint_overrides=overrides, logs=pcfg.solver_logs)
    t0 = _mark("solve", t0)
    pubs = W[: cs.n_public]
    # W encoded once (and a zero for the padding rows), the three wire
    # columns gathered from it by wire id
    w_dev = f.encode(W + [0], device=device)
    lro = engine.place(w_dev.index_select(1, _wire_ids(cs, n).reshape(-1).to(device)).view(f.n, 3, n))
    # blinders drawn in the reference's order: l, r, o (2 each), z (3 below)
    bl_lro = f.encode([rand() for _ in range(6)], device=device).view(f.n, 3, 2)
    hats, hats_norm = wires_stage(ntt_n, lro, bl_lro)
    # the wire columns in canonical basis, blinded to degree n+1
    l_hat, r_hat, o_hat = hats.unbind(1)
    l_com, r_com, o_com = engine.commit_many(pk.srs, hats_norm)
    t0 = _mark("lro", t0)

    # ---- 2. gamma, beta ------------------------------------------------------
    tr = Transcript(list(CHALLENGES), hash_factory=pcfg.challenge_hash)
    for pt in vk.digest_points():
        tr.bind("gamma", g1_bytes(pt))
    for w in pubs:
        tr.bind("gamma", fr_bytes(w))
    for c in (l_com, r_com, o_com):
        tr.bind("gamma", g1_bytes(c))
    gamma = tr.challenge_int("gamma", p)
    beta = tr.challenge_int("beta", p)

    # ---- 3. grand product Z --------------------------------------------------
    zbl = f.encode([rand() for _ in range(3)], device=device)
    z_hat, z_norm = z_stage(ntt_n, lro, tab["ids"], tab["s_lag"], sc(gamma), sc(beta), zbl)
    z_com = engine.commit(pk.srs, z_norm)
    t0 = _mark("z", t0)

    # deriveAlpha binds the Bsb22 commitments FIRST, then Z (prove.go:504-512)
    for pt in bsb22_points:
        tr.bind("alpha", g1_bytes(pt))
    tr.bind("alpha", g1_bytes(z_com))
    alpha = tr.challenge_int("alpha", p)

    # ---- 4. quotient t via the rho-loop --------------------------------------
    # z(omega X): scale coeff i by omega^i
    zw_hat = f.mul(z_hat, tab["wpow"][:, : z_hat.shape[1]])
    # public-input polynomial; the prover completes it with the BSB22
    # challenge at each commitment-injection row (qk completion,
    # reference prove.go:415-416)
    pi_evals = dict(enumerate(pubs))
    for i, cm in enumerate(cs.commitments):
        pi_evals[cs.n_public + cm.commitment_index] = bsb22_vals[i]
    pi_hat = Polynomial(_sparse_column(pi_evals, n, device), Basis.LAGRANGE, Layout.REGULAR, BN254_FR)
    pi_hat = pi_hat.to_canonical().data

    polys = {"l": l_hat, "r": r_hat, "o": o_hat, "z": z_hat, "zw": zw_hat, "pi": pi_hat}
    consts = quotient_consts(pk, gamma, beta, alpha)
    h, h_norm = quotient_stage(ntt_n, ntt_4n, pk, polys, c_coeffs, consts)
    h1_com, h2_com, h3_com = engine.commit_many(pk.srs, h_norm)

    for c in (h1_com, h2_com, h3_com):
        tr.bind("zeta", g1_bytes(c))
    zeta = tr.challenge_int("zeta", p)
    t0 = _mark("quotient", t0)

    # ---- 5. openings --------------------------------------------------------
    from ...curves.ref import G1

    m2 = n + 2
    zeta_m2 = pow(zeta, m2, p)
    omega_zeta = zeta * vk.generator % p
    folded_h, evals, zu_words, q2_norm = open1_stage(
        h, l_hat, r_hat, o_hat, z_hat, tab, sc(zeta_m2), sc(zeta_m2 * zeta_m2), sc(zeta), sc(omega_zeta)
    )
    ev = f.decode(evals)  # [lb, rb, ob, s1b, s2b, fhb, qcp...] (ONE sync)
    lb, rb, ob, s1b, s2b, fhb = ev[:6]
    qcp_zeta = [v % p for v in ev[6:]]
    (zu,) = f.decode(zu_words)

    # scalar weights of the linearized polynomial
    l1_zeta = (pow(zeta, n, p) - 1) * pow(n * (zeta - 1) % p, -1, p) % p
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

    # BSB22: the linearization gains sum_i qcp_i(zeta) * P_i(X)
    # (computeLinearizedPolynomial's qcpzeta/cCommitments args,
    # prove.go:753-765)
    wts = f.encode([lb, rb, rl, ob, 1, s3_scal, z_scal] + qcp_zeta, device=device)
    lin, lin_norm, lin_zeta_words = lin_stage(tab, z_hat, c_coeffs, wts, sc(zeta))
    (lin_zeta,) = f.decode(lin_zeta_words)
    lin_com = engine.commit(pk.srs, lin_norm)

    # folded H digest (host, 2 tiny scalar muls — verifier recomputes it)
    folded_h_com = G1.add(
        h1_com,
        G1.add(G1.mul(h2_com, zeta_m2), G1.mul(h3_com, zeta_m2 * zeta_m2 % p)),
    )

    # ---- 6. batched opening at zeta + Z at omega*zeta -----------------------
    # BSB22: the qcp trace polynomials join the batched opening at positions
    # 7+ (batchOpening, prove.go:778-812)
    claimed = [fhb, lin_zeta, lb, rb, ob, s1b, s2b] + qcp_zeta
    digests = [folded_h_com, lin_com, l_com, r_com, o_com, vk.s1, vk.s2] + list(vk.qcp)
    # gnark kzg.BatchOpenSinglePoint fold challenge: fresh transcript over
    # (zeta, digests, claimed values, Z(omega*zeta) bytes) — prove.go:823-833
    nu = kzg_fold_challenge(zeta, digests, claimed, [fr_bytes(zu)], p, hash_factory=pcfg.kzg_fold_hash)
    nupows = [pow(nu, i, p) for i in range(len(claimed))]
    q_norm = fold_stage(folded_h, lin, l_hat, r_hat, o_hat, tab, f.encode(nupows, device=device), sc(zeta))
    # one composite MSM for both opening quotients (q2 padded to match)
    q2p = _pad_to(q2_norm, q_norm.shape[1])
    batched_h, z_shifted_h = engine.commit_many(pk.srs, torch.stack([q_norm, q2p], dim=1))
    _mark("open", t0)

    return PlonkProof(
        l_com=l_com,
        r_com=r_com,
        o_com=o_com,
        z_com=z_com,
        h1_com=h1_com,
        h2_com=h2_com,
        h3_com=h3_com,
        bsb22_commitments=bsb22_points,
        batched_h=batched_h,
        claimed_values=claimed,
        z_shifted_h=z_shifted_h,
        z_shifted_value=zu,
    )
