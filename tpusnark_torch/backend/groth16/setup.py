"""Groth16 trusted setup with the point generation on the device
(counterpart of tpusnark/backend/groth16/setup.py:setup, use_device=True).

The scalar work is tpusnark's host code, copied (``lagrange_coeffs_at``,
``_qap_eval_at_t``, ``k_pk_wires_for``, ``_next_pow2``), in the same order of
rng draws, so the same rng gives the same keys as tpusnark. Every key point
is one lane of two batched fixed-base multiplications (G1 and G2,
``FixedBaseMul``). The results are normalised to affine on the device (one
batched Fermat inversion) and kept there as the prover's point tables; the
host copies in the returned ``ProvingKey`` and ``VerifyingKey`` are decoded
from them, as points of the curve's host module. Curves whose kernels are
ported: BN254, BLS12-381, BLS12-377, the BW6 curves (whose G2 lies over Fp:
its points are plain int pairs) and the BLS24 curves (G2 over Fp4: tpusnark
multiplies their G2 keys on the host, one ladder a point; here they are
lanes of the same batched multiplication). BSB22 commitments (BN254 only,
as in tpusnark) split K as tpusnark's setup does: the commitment wires' K
points go to the verifying key, the committed wires' become the Pedersen
bases (lanes of the same G1 batch), and the Pedersen keys are
``pedersen_setup``'s: its sigma drawn after the toxic waste, where it draws
it, and the sigma multiples of the bases the lanes of one more G1 batch
(``pedersen_setup`` runs one host ladder a basis point, minutes for the
thousands of bases of a range check).
"""

from __future__ import annotations

import random
import secrets
import time

import torch

from ...constraint.system import ConstraintSystem
from ...curves import ref
from ...curves.batch_mul import FixedBaseMul, g1_generator_ladder, g2_generator_ladder
from ...curves.pedersen import PedersenProvingKey, PedersenVerifyingKey
from ...curves.tcurve import curve_ops, small_mul
from ...fields.tfield import compute_device, get_field
from ...msm.pippenger import tree_map
from ...poly.domain import Domain
from .keys import ProvingKey, VerifyingKey, ported_curve, set_device_tables


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def lagrange_coeffs_at(t: int, n: int, omega: int, p: int) -> list[int]:
    """L_i(t) for the size-n domain: L_i(t) = omega^i (t^n - 1) / (n (t - omega^i)).

    Assumes t is not in the domain (overwhelming probability for random t)."""
    zt = (pow(t, n, p) - 1) % p
    n_inv = pow(n, -1, p)
    # batch-invert (t - omega^i) via Montgomery trick
    wi = 1
    denoms = []
    for _ in range(n):
        denoms.append((t - wi) % p)
        wi = wi * omega % p
    # prefix products
    pref = [1] * (n + 1)
    for i, d in enumerate(denoms):
        pref[i + 1] = pref[i] * d % p
    inv_all = pow(pref[n], -1, p)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv_all * pref[i] % p
        inv_all = inv_all * denoms[i] % p
    out = [0] * n
    wi = 1
    base = zt * n_inv % p
    for i in range(n):
        out[i] = base * wi % p * invs[i] % p
        wi = wi * omega % p
    return out


def _qap_eval_at_t(cs: ConstraintSystem, t: int, n: int, omega: int):
    """Per-wire A_w(t), B_w(t), C_w(t) via one pass over constraint terms
    (reference: setupABC, setup.go:352)."""
    p = cs.modulus
    L = lagrange_coeffs_at(t, n, omega, p)
    coeffs = cs.coeffs
    nw = cs.n_wires
    A = [0] * nw
    B = [0] * nw
    C = [0] * nw
    for i, c in enumerate(cs.constraints):
        li = L[i]
        for cid, vid in c.L:
            A[vid] = (A[vid] + coeffs[cid] * li) % p
        for cid, vid in c.R:
            B[vid] = (B[vid] + coeffs[cid] * li) % p
        for cid, vid in c.O:
            C[vid] = (C[vid] + coeffs[cid] * li) % p
    return A, B, C


def k_pk_wires_for(cs: ConstraintSystem) -> list[int]:
    """Wire ids backing pk.K: private wires minus BSB22 commitment wires and
    committed wires (whose K points live in the Pedersen basis / vk instead;
    reference setup.go:163-197). Identity order."""
    cw_set = {c.commitment_index for c in cs.commitments}
    committed = {w for cm in cs.commitments for w in cm.private_committed}
    return [
        w
        for w in range(cs.n_public, cs.n_wires)
        if w not in cw_set and w not in committed
    ]


def dummy_setup(cs: ConstraintSystem, device="cuda"):
    """ProvingKey with the right shapes but meaningless values, for
    benchmarking the prover without a trusted setup (gnark's DummySetup,
    gnark/backend/groth16/bn254/setup.go:482), computed on `device`: the
    card, unless the caller passes "cpu". The seeded draw over BN254's r of
    tpusnark's dummy_setup, so the keys equal tpusnark's. Proofs made with
    it do NOT verify."""
    rng_state = random.Random(0xD00D)
    pk, _vk = setup(cs, rng=lambda: rng_state.randrange(1, ref.R), device=device)
    return pk


def _fp2_inv(fa2, x):
    """Inverse over Fp[u]/(u^2 + q): (a + bu)^-1 = (a - bu) / (a^2 + q b^2);
    inv(0) = 0."""
    f = fa2.f
    a, b = x
    d = f.inv(f.add(f.mul(a, a), small_mul(f, f.mul(b, b), fa2.q)))
    return (f.mul(a, d), f.neg(f.mul(b, d)))


def _fp4_inv(fa4, x):
    """Inverse over Fp2[v]/(v^2 - Z2) through the norm: (a + bv)^-1 =
    (a - bv) / (a^2 - Z2 b^2), the norm inverted over Fp2; inv(0) = 0."""
    f2 = fa4.f2
    a, b = x
    aa, bb = f2.mul_many([(a, a), (b, b)])
    ni = _fp2_inv(f2, f2.sub(aa, fa4._mul_z2(bb)))
    return (f2.mul(a, ni), f2.neg(f2.mul(b, ni)))


def to_affine(ops, pt):
    """Projective points -> device affine (X, Y, inf); inf lanes hold (0, 1).
    Over Fp2 and Fp4 the inverse of Z goes down the tower to one batched
    Fermat inversion over Fp."""
    fa = ops.fa
    X, Y, Z = pt
    inf = fa.is_zero(Z)
    zi = _fp4_inv(fa, Z) if ops.fp4 else _fp2_inv(fa, Z) if ops.fp2 else fa.f.inv(Z)
    x, y = fa.mul(X, zi), fa.mul(Y, zi)
    ident = ops.identity_like(x)
    return (fa.select(inf, ident[0], x), fa.select(inf, ident[1], y), inf)


def to_host(ops, aff, host):
    """Device affine points -> list[(x, y) | None] as points of the curve's
    host module `host`: coordinates of its Fp4 class (G2 over Fp4), its Fp2
    class (over Fp2), or plain ints (over Fp)."""
    f = ops.fa.f
    X, Y, inf = aff
    comps = [c for v in (X, Y) for c in ops.fa.components(v)]
    vals = [f.decode(f.from_mont(c), mont=False) for c in comps]
    inf = inf.cpu().tolist()
    if ops.fp4:
        Fp2, Fp4 = host.Fp2, host.Fp4

        def coord(c, i):
            return Fp4((Fp2((c[0][i], c[1][i])), Fp2((c[2][i], c[3][i]))))

        xs, ys = vals[:4], vals[4:]
        return [None if inf[i] else (coord(xs, i), coord(ys, i)) for i in range(len(inf))]
    if ops.fp2:
        x0, x1, y0, y1 = vals
        return [
            None if inf[i] else (host.Fp2(x0[i], x1[i]), host.Fp2(y0[i], y1[i]))
            for i in range(len(inf))
        ]
    xs, ys = vals
    return [None if inf[i] else (xs[i], ys[i]) for i in range(len(inf))]


def _batch(cfg, ops, ladder, scalars, device, mark):
    """[s_i * G] for all i: (device affine table, host points). mark(phase)
    closes a timed phase: the scalars' encode, the fixed-base products and
    the inversion (on `device`), the decode to host points."""
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    mul = FixedBaseMul(ops, fr)
    words = fr.encode(scalars, mont=False, device=device)
    mark("encode")
    aff = to_affine(ops, mul(ladder(fp, mul.n_bits, cfg.name, device), words))
    mark("fixed_base")
    pts = to_host(ops, aff, cfg.host)
    mark("to_host")
    return aff, pts


def _cols(aff, lo: int, hi: int):
    return tree_map(lambda a: a[..., lo:hi].contiguous(), aff)


def setup(cs, rng=None, device="cuda", curve: str = "bn254", timings: dict | None = None):
    """(pk, vk) for an R1CS over `curve`'s r, with the key points computed
    on `device`: the card, unless the caller passes "cpu" (the plain
    versions, as the tests run them). rng: callable -> int in [1, r), as tpusnark's setup takes;
    it is drawn in tpusnark's order, so the same rng gives the same keys as
    tpusnark's setup(..., curve=curve).

    `timings`: optional dict filled with per-phase wall-clock seconds:
    `scalars` (the host's Lagrange and QAP evaluation and the key scalars),
    `encode` (their words, copied to the device), `fixed_base` (the
    fixed-base products and the affine normalisation on the device),
    `to_host` (the points decoded to the host) and `keys` (the Pedersen
    keys and the containers); timing synchronises the device between
    phases, so pass it only to measure."""
    cfg = ported_curve(curve)
    if cs.modulus != cfg.host.R:
        raise ValueError(f"circuit modulus is not {curve}'s r")
    if cs.commitments and curve != "bn254":
        raise NotImplementedError("BSB22 commitments are BN254-only for now")
    device = compute_device(device)
    t_last = time.perf_counter()

    def mark(name):
        nonlocal t_last
        if timings is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + (t - t_last)
        t_last = t

    p = cfg.host.R
    rand = rng or (lambda: secrets.randbelow(p - 1) + 1)
    n = _next_pow2(max(1, len(cs.constraints)))
    dom = Domain(cfg.fr_spec, n)

    alpha, beta, gamma, delta, t = (rand() for _ in range(5))
    while pow(t, n, p) == 1:
        t = rand()
    A, B, C = _qap_eval_at_t(cs, t, n, dom.generator)
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    npub = cs.n_public

    def k_at(w, coeff):
        return (beta * A[w] + alpha * B[w] + C[w]) * coeff % p

    # BSB22 split of K (tpusnark setup.py:201-224): the commitment wires are
    # injected by the verifier, so their K goes to the vk (/gamma); the
    # committed private wires' K become the Pedersen bases (/gamma); every
    # other private wire's goes to pk.K (/delta)
    cw_sorted = sorted({c.commitment_index for c in cs.commitments})
    k_vk_s = [k_at(w, gamma_inv) for w in range(npub)] + [k_at(w, gamma_inv) for w in cw_sorted]
    ck_s = [[k_at(w, gamma_inv) for w in cm.private_committed] for cm in cs.commitments]
    k_pk_wires = k_pk_wires_for(cs)
    k_pk_s = [k_at(w, delta_inv) for w in k_pk_wires]
    zt = (pow(t, n, p) - 1) % p
    z_s, ti = [], 1
    for _ in range(n - 1):
        z_s.append(zt * delta_inv % p * ti % p)
        ti = ti * t % p

    g1, g2 = curve_ops(curve)
    # one G1 batch: [A | B | K_vk | K_pk | CK... | Z | alpha, beta, delta]
    nw = cs.n_wires
    ck_flat = [x for lst in ck_s for x in lst]
    mark("scalars")
    g1_dev, g1_pts = _batch(
        cfg, g1, g1_generator_ladder, A + B + k_vk_s + k_pk_s + ck_flat + z_s + [alpha, beta, delta], device, mark
    )
    bounds = {}
    o = 0
    sizes = [("a", nw), ("b1", nw), ("k_vk", len(k_vk_s)), ("k", len(k_pk_s))]
    sizes += [(("ck", j), len(lst)) for j, lst in enumerate(ck_s)] + [("z", n - 1)]
    for name, size in sizes:
        bounds[name] = (o, o + size)
        o += size
    alpha_g1, beta_g1, delta_g1 = g1_pts[o : o + 3]
    g2_dev, g2_pts = _batch(cfg, g2, g2_generator_ladder, B + [beta, gamma, delta], device, mark)
    beta_g2, gamma_g2, delta_g2 = g2_pts[nw : nw + 3]

    def host_pts(name):
        lo, hi = bounds[name]
        return g1_pts[lo:hi]

    commitment_keys, commitment_vk = [], None
    if cs.commitments:
        sigma = rand()  # pedersen_setup's draw
        sig_pts = []
        if ck_flat:
            sig_pts = _batch(cfg, g1, g1_generator_ladder, [s * sigma % p for s in ck_flat], device, mark)[1]
        o = 0
        for j, lst in enumerate(ck_s):
            basis_exp_sigma = sig_pts[o : o + len(lst)]
            commitment_keys.append(PedersenProvingKey(basis=host_pts(("ck", j)), basis_exp_sigma=basis_exp_sigma))
            o += len(lst)
        g2_gen = ref.G2.generator()
        commitment_vk = PedersenVerifyingKey(g2=g2_gen, g2_sigma_neg=ref.G2.neg(ref.G2.mul(g2_gen, sigma)))
    # the verifier's committed-public index lists: committed publics stay
    # positions into [1 | publics], committed commitment wires become npub +
    # the ordinal of that commitment in the extended public witness
    # (gnark GetPublicAndCommitmentCommitted, constraint/commitment.go:53)
    cw_pos = {w: npub + i for i, w in enumerate(cw_sorted)}
    pub_committed = [[cw_pos.get(w, w) for w in cm.public_and_commitment_committed] for cm in cs.commitments]

    pk = ProvingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        beta_g2=beta_g2,
        delta_g2=delta_g2,
        a=host_pts("a"),
        b1=host_pts("b1"),
        b2=g2_pts[:nw],
        k=host_pts("k"),
        z=host_pts("z"),
        domain_n=n,
        k_wires=k_pk_wires,
        commitment_keys=commitment_keys,
        curve=curve,
    )
    vk = VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        k=host_pts("k_vk"),
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        commitment_key=commitment_vk,
        public_and_commitment_committed=pub_committed,
    )
    tables = {name: _cols(g1_dev, *bounds[name]) for name in ("a", "b1", "k", "z")}
    tables["b2"] = _cols(g2_dev, 0, nw)
    set_device_tables(pk, device, tables)
    mark("keys")
    return pk, vk
