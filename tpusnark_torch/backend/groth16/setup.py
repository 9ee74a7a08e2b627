"""Groth16 trusted setup with the point generation on the device
(counterpart of tpusnark/backend/groth16/setup.py:setup, use_device=True).

The scalar work is tpusnark's own host code (``_qap_eval_at_t``,
``k_pk_wires_for``, ``_next_pow2``), in the same order of rng draws, so the
same rng gives the same keys as tpusnark. Every key point is one lane of two
batched fixed-base multiplications (G1 and G2, ``FixedBaseMul``). The results
are normalised to affine on the device (one batched Fermat inversion) and
kept there as the prover's point tables; the host copies in the returned
``ProvingKey`` and ``VerifyingKey`` are decoded from them, as points of the
curve's host module. Curves whose kernels are ported: BN254 and BLS12-381.
BSB22 commitments are not ported yet.
"""

from __future__ import annotations

import secrets

from tpusnark.poly.domain import Domain

from ... import _host
from ...curves.batch_mul import FixedBaseMul, g1_generator_ladder, g2_generator_ladder
from ...curves.tcurve import curve_ops, small_mul
from ...fields.tfield import get_field
from ...msm.pippenger import tree_map
from .keys import ProvingKey, VerifyingKey, ported_curve, set_device_tables


def to_affine(ops, pt):
    """Projective points -> device affine (X, Y, inf); inf lanes hold (0, 1)."""
    fa = ops.fa
    f = fa.f
    X, Y, Z = pt
    inf = fa.is_zero(Z)
    if ops.g2:
        # over u^2 = -q: (a + bu)^-1 = (a - bu) / (a^2 + q b^2)
        a, b = Z
        d = f.inv(f.add(f.mul(a, a), small_mul(f, f.mul(b, b), fa.q)))
        zi = (f.mul(a, d), f.neg(f.mul(b, d)))
    else:
        zi = f.inv(Z)
    x, y = fa.mul(X, zi), fa.mul(Y, zi)
    ident = ops.identity_like(x)
    return (fa.select(inf, ident[0], x), fa.select(inf, ident[1], y), inf)


def to_host(ops, aff, fp2_cls):
    """Device affine points -> list[(x, y) | None] (G2: fp2_cls coordinates,
    the curve's host Fp2 class)."""
    f = ops.fa.f
    X, Y, inf = aff
    comps = [c for v in (X, Y) for c in ops.fa.components(v)]
    vals = [f.decode(f.from_mont(c), mont=False) for c in comps]
    inf = inf.cpu().tolist()
    if ops.g2:
        x0, x1, y0, y1 = vals
        return [
            None if inf[i] else (fp2_cls(x0[i], x1[i]), fp2_cls(y0[i], y1[i]))
            for i in range(len(inf))
        ]
    xs, ys = vals
    return [None if inf[i] else (xs[i], ys[i]) for i in range(len(inf))]


def _batch(cfg, ops, ladder, scalars, device):
    """[s_i * G] for all i: (device affine table, host points)."""
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    mul = FixedBaseMul(ops, fr)
    table = ladder(fp, mul.n_bits, cfg.name, device)
    aff = to_affine(ops, mul(table, fr.encode(scalars, mont=False, device=device)))
    return aff, to_host(ops, aff, cfg.host.Fp2)


def _cols(aff, lo: int, hi: int):
    return tree_map(lambda a: a[..., lo:hi].contiguous(), aff)


def setup(cs, rng=None, device="cpu", curve: str = "bn254"):
    """(pk, vk) for an R1CS over `curve`'s r, with the key points computed
    on `device`. rng: callable -> int in [1, r), as tpusnark's setup takes;
    it is drawn in tpusnark's order, so the same rng gives the same keys as
    tpusnark's setup(..., curve=curve)."""
    cfg = ported_curve(curve)
    if cs.modulus != cfg.host.R:
        raise ValueError(f"circuit modulus is not {curve}'s r")
    if cs.commitments:
        raise NotImplementedError("BSB22 commitments are not ported yet")
    host = _host.setup
    p = cfg.host.R
    rand = rng or (lambda: secrets.randbelow(p - 1) + 1)
    n = host._next_pow2(max(1, len(cs.constraints)))
    dom = Domain(cfg.fr_spec, n)

    alpha, beta, gamma, delta, t = (rand() for _ in range(5))
    while pow(t, n, p) == 1:
        t = rand()
    A, B, C = host._qap_eval_at_t(cs, t, n, dom.generator)
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    npub = cs.n_public

    def k_at(w, coeff):
        return (beta * A[w] + alpha * B[w] + C[w]) * coeff % p

    k_vk_s = [k_at(w, gamma_inv) for w in range(npub)]
    k_pk_wires = host.k_pk_wires_for(cs)
    k_pk_s = [k_at(w, delta_inv) for w in k_pk_wires]
    zt = (pow(t, n, p) - 1) % p
    z_s, ti = [], 1
    for _ in range(n - 1):
        z_s.append(zt * delta_inv % p * ti % p)
        ti = ti * t % p

    g1, g2 = curve_ops(curve)
    # one G1 batch: [A | B | K_vk | K_pk | Z | alpha, beta, delta]
    nw = cs.n_wires
    g1_dev, g1_pts = _batch(
        cfg, g1, g1_generator_ladder, A + B + k_vk_s + k_pk_s + z_s + [alpha, beta, delta], device
    )
    bounds = {}
    o = 0
    for name, size in (("a", nw), ("b1", nw), ("k_vk", npub), ("k", len(k_pk_s)), ("z", n - 1)):
        bounds[name] = (o, o + size)
        o += size
    alpha_g1, beta_g1, delta_g1 = g1_pts[o : o + 3]
    g2_dev, g2_pts = _batch(cfg, g2, g2_generator_ladder, B + [beta, gamma, delta], device)
    beta_g2, gamma_g2, delta_g2 = g2_pts[nw : nw + 3]

    def host_pts(name):
        lo, hi = bounds[name]
        return g1_pts[lo:hi]

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
        commitment_keys=[],
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
        commitment_key=None,
        public_and_commitment_committed=[],
    )
    tables = {name: _cols(g1_dev, *bounds[name]) for name in ("a", "b1", "k", "z")}
    tables["b2"] = _cols(g2_dev, 0, nw)
    set_device_tables(pk, device, tables)
    return pk, vk
