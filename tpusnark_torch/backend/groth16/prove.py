"""Groth16 prover on torch tensors (counterpart of
tpusnark/backend/groth16/prove.py), over any curve whose kernels are ported
(BN254 and BLS12-381); the curve is the proving key's.

Pipeline: solve the witness on the host (``tpusnark.constraint.solver``),
evaluate A/B/C on the device, compute the quotient H (3 INTT, 3 coset NTT,
pointwise (a*b - c)/Z_H, 1 coset INTT, from_mont), run the five MSMs (a, b1,
k, z on G1; b2 on G2), and assemble the proof on the host. Phase names match
tpusnark's (solve / encode / h / msm / assemble). The device solver and BSB22
commitments are not ported yet.
"""

from __future__ import annotations

import secrets
import time

import torch

from tpusnark.backend.config import resolve
from tpusnark.constraint.solver import solve

from ...constraint.eval_torch import abc_evaluator
from ...curves.encoding import g1_from_device_proj, g2_from_device_proj
from ...fields.tfield import canonical_device, get_field
from ...msm.pippenger import get_msm_for
from ...poly.ntt import get_ntt
from .keys import Proof, device_tables, ported_curve


def compute_h_dev(A, B, C, n: int, spec):
    """Quotient H = (A*B - C)/Z_H over the scalar field `spec`, on the
    device of A; returns (words, n-1) NORMAL-form words (the MSM scalar
    format). Inputs are (words, n_constraints) Montgomery, padded to n."""
    p = spec.modulus
    ntt = get_ntt(spec, n, A.device)
    f = ntt.field
    den = pow((pow(ntt.domain.coset_shift, n, p) - 1) % p, -1, p)

    def pad(x):
        return torch.cat([x, f.zeros((n - x.shape[1],), device=x.device)], dim=1)

    ca = ntt.ntt_coset(ntt.intt(pad(A)))
    cb = ntt.ntt_coset(ntt.intt(pad(B)))
    cc = ntt.ntt_coset(ntt.intt(pad(C)))
    num = f.sub(f.mul(ca, cb), cc)
    h = ntt.intt_coset(f.mul(num, f.broadcast_const(f.const(den, mont=True, device=num.device), num)))
    # degree(H) = n - 2: the top coefficient is zero. The MSM wants normal form.
    return f.from_mont(h[:, : n - 1])


def prove(cs, pk, assignment: dict, rng=None, config=None, timings: dict | None = None, device="cpu"):
    """Groth16 proof of `assignment` for `cs` under `pk`, computed on `device`.

    `timings`: optional dict filled with per-phase wall-clock seconds; timing
    synchronises the device between phases, so pass it only to measure."""
    device = canonical_device(device)
    if cs.commitments:
        raise NotImplementedError("BSB22 commitments are not ported yet")
    cfg = ported_curve(pk.curve)

    def mark(name, t0):
        if timings is None:
            return 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + (t - t0)
        return t

    pcfg = resolve(config, rng)
    fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
    G1, G2 = cfg.host.G1, cfg.host.G2
    p = cs.modulus
    rand = pcfg.rng or (lambda: secrets.randbelow(p))
    r, s = rand(), rand()

    t0 = time.perf_counter()
    W = solve(cs, assignment, hint_overrides=pcfg.hint_overrides or None, logs=pcfg.solver_logs)
    t0 = mark("solve", t0)
    n = pk.domain_n
    A, B, C = abc_evaluator(cs, fr, device)(fr.encode(W, mont=True, device=device))
    w_dev = fr.encode(W, mont=False, device=device)
    t0 = mark("encode", t0)
    h_dev = compute_h_dev(A, B, C, n, cfg.fr_spec)
    t0 = mark("h", t0)

    dev = device_tables(pk, device)
    msm_g1 = get_msm_for("g1", cs.n_wires, cfg.name)
    msm_g2 = get_msm_for("g2", cs.n_wires, cfg.name)
    if pk.k_wires is not None:
        priv = w_dev[:, torch.tensor(pk.k_wires, dtype=torch.int64, device=device)]
    else:
        priv = w_dev[:, cs.n_public :].contiguous()
    ar_raw = msm_g1(dev["a"], w_dev)
    bs1_raw = msm_g1(dev["b1"], w_dev)
    bs2_raw = msm_g2(dev["b2"], w_dev)
    krs_k = msm_g1(dev["k"], priv)
    krs_z_raw = msm_g1(dev["z"], h_dev) if len(pk.z) else None
    t0 = mark("msm", t0)

    (ar_sum,) = g1_from_device_proj(ar_raw, fp)
    (bs1_sum,) = g1_from_device_proj(bs1_raw, fp)
    (bs2_sum,) = g2_from_device_proj(bs2_raw, fp, cfg.host.Fp2, cfg.fp2_q)
    (krs_k_sum,) = g1_from_device_proj(krs_k, fp)
    # a 1-constraint domain has deg(H) < 0 and an empty Z table
    krs_z_sum = None if krs_z_raw is None else g1_from_device_proj(krs_z_raw, fp)[0]

    # host assembly (tpusnark prove.py:254-261)
    ar = G1.add(G1.add(pk.alpha_g1, ar_sum), G1.mul(pk.delta_g1, r))
    bs = G2.add(G2.add(pk.beta_g2, bs2_sum), G2.mul(pk.delta_g2, s))
    bs1 = G1.add(G1.add(pk.beta_g1, bs1_sum), G1.mul(pk.delta_g1, s))
    krs = G1.add(krs_k_sum, krs_z_sum)
    krs = G1.add(krs, G1.mul(ar, s))
    krs = G1.add(krs, G1.mul(bs1, r))
    krs = G1.add(krs, G1.mul(pk.delta_g1, (-r * s) % p))
    mark("assemble", t0)
    return Proof(ar=ar, krs=krs, bs=bs, commitments=[], commitment_pok=None)
