"""Groth16 prover on torch tensors (counterpart of
tpusnark/backend/groth16/prove.py), over any curve whose kernels are ported
(BN254, BLS12-381, BLS12-377, BW6-761, BW6-633, BLS24-315 and BLS24-317);
the curve is the proving key's.

Pipeline: solve the witness (``constraint/solver_torch.py:solve_any``: on
the device where the circuit's level shape favours it, W and A/B/C then stay
there; else on the host, A/B/C then evaluated on the device), compute the
quotient H (3 INTT, 3 coset NTT, pointwise (a*b - c)/Z_H, 1 coset INTT,
from_mont), run the five MSMs (a, b1, k, z on G1; b2 on G2), and assemble the
proof on the host. Phase names match tpusnark's (solve / encode / h / msm /
assemble). BSB22 commitments (BN254 only, as in tpusnark): the solver runs
the real Pedersen commitment and hash-to-field in place of the placeholder
hint, and the proof carries the commitments and one folded proof of
knowledge.
"""

from __future__ import annotations

import secrets

import torch

from ... import trace
from ...constraint.eval_torch import abc_evaluator
from ...constraint.hints import bsb22_placeholder
from ...constraint.solver_torch import solve_any
from ...curves.encoding import g1_from_device_proj, g2_from_device_proj, g4_from_device_proj
from ...curves.marshal import g1_raw
from ...curves.pedersen import pedersen_batch_prove, pedersen_commit
from ...fields.tfield import compute_device, get_field
from ...msm.pippenger import get_msm_for
from ...poly.ntt import get_ntt
from ...utils.hash_to_field import COMMITMENT_DST, hash_to_field
from ..config import resolve
from .keys import Proof, device_tables, ported_curve
from .setup import k_pk_wires_for


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


def bsb22_prover_state(cs, pk):
    """BSB22 prover-side hint override (tpusnark prove.py:87-114, gnark
    prove.go:84-112): (overrides | None, proof_commitments, private_vals);
    the lists fill in as the solver runs the overridden hints."""
    n_com = len(cs.commitments)
    proof_commitments: list = [None] * n_com
    private_vals: list = [None] * n_com
    if not n_com:
        return None, proof_commitments, private_vals

    def bsb22_real(p_, ins):
        i = int(ins[0])
        rest = ins[1:]
        n_hashed = len(cs.commitments[i].public_and_commitment_committed)
        hashed = rest[:n_hashed]
        committed = [int(v) % p_ for v in rest[n_hashed:]]
        C = pedersen_commit(pk.commitment_keys[i], committed)
        proof_commitments[i] = C
        private_vals[i] = committed
        msg = g1_raw(C) + b"".join(int(v).to_bytes(32, "big") for v in hashed)
        return [hash_to_field(msg, COMMITMENT_DST, p_)[0]]

    return {bsb22_placeholder: bsb22_real}, proof_commitments, private_vals


def prove(cs, pk, assignment: dict, rng=None, config=None, timings: dict | None = None, device="cuda"):
    """Groth16 proof of `assignment` for `cs` under `pk`, computed on `device`:
    the card, unless the caller passes "cpu" (the plain versions, as the tests
    run them).

    `timings`: optional dict filled with per-phase wall-clock seconds; timing
    synchronises the device between phases, so pass it only to measure. The
    phases are the spans ``groth16.<phase>`` of ``tpusnark_torch.trace``;
    the device solver adds its split of ``solve`` (``solve_levels``,
    ``solve_hints``)."""
    cfg = ported_curve(pk.curve)
    if cs.commitments and cfg.name != "bn254":
        raise NotImplementedError("BSB22 commitments are BN254-only for now")
    device = compute_device(device)
    with trace.span("groth16.prove"):
        return _prove(cs, pk, assignment, rng, config, timings, device, cfg)


def _prove(cs, pk, assignment, rng, config, timings, device, cfg):
    def phase(name):
        return trace.phase(f"groth16.{name}", timings, name, device)

    pcfg = resolve(config, rng)
    fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
    G1, G2 = cfg.host.G1, cfg.host.G2
    p = cs.modulus
    rand = pcfg.rng or (lambda: secrets.randbelow(p))
    r, s = rand(), rand()

    # BSB22: the placeholder hint becomes the real Pedersen commitment and
    # hash-to-field challenge (tpusnark prove.py:155-170)
    overrides, proof_commitments, private_vals = bsb22_prover_state(cs, pk)
    overrides = {**(overrides or {}), **pcfg.hint_overrides}
    with phase("solve"):
        w_mont, abc, W = solve_any(
            cs,
            assignment,
            cfg.fr_spec,
            hint_overrides=overrides or None,
            force_host=pcfg.accelerator == "host",
            logs=pcfg.solver_logs,
            device=device,
            timings=timings,
        )
    n = pk.domain_n

    def wire_ints(idxs):
        if W is not None:
            return [W[i] for i in idxs]
        trace.count("h2d_bytes", 8 * len(idxs))
        return fr.decode(w_mont[:, torch.tensor(idxs, dtype=torch.int64, device=device)])

    with phase("encode"):
        pok = None
        if cs.commitments:
            seeds = b"".join(
                int(v).to_bytes(32, "big") for v in wire_ints([cm.commitment_index for cm in cs.commitments])
            )
            pok = pedersen_batch_prove(pk.commitment_keys, private_vals, seeds)
        if W is not None:  # the host solver's W: A/B/C evaluated on the device
            A, B, C = abc_evaluator(cs, fr, device)(fr.encode(W, mont=True, device=device))
            w_dev = fr.encode(W, mont=False, device=device)
        else:  # W stays on the device; A/B/C come from the solver's bulk check
            A, B, C = abc
            w_dev = fr.from_mont(w_mont)
    with phase("h"):
        h_dev = compute_h_dev(A, B, C, n, cfg.fr_spec)

    with phase("msm"):
        dev = device_tables(pk, device)
        msm_g1 = get_msm_for("g1", cs.n_wires, cfg.name)
        msm_g2 = get_msm_for("g2", cs.n_wires, cfg.name)
        with trace.span("groth16.msm.index"):
            # the wires pk.K stands for: the private ones but the committed and
            # the commitment wires, whose K is in the Pedersen basis or the vk
            k_wires = pk.k_wires if pk.k_wires is not None else k_pk_wires_for(cs)
            trace.count("h2d_bytes", 8 * len(k_wires))
            priv = w_dev[:, torch.tensor(k_wires, dtype=torch.int64, device=device)]
        ar_raw = msm_g1(dev["a"], w_dev)
        bs1_raw = msm_g1(dev["b1"], w_dev)
        bs2_raw = msm_g2(dev["b2"], w_dev)
        krs_k = msm_g1(dev["k"], priv)
        krs_z_raw = msm_g1(dev["z"], h_dev) if len(pk.z) else None

    with phase("assemble"):
        with trace.span("groth16.assemble.decode"):
            (ar_sum,) = g1_from_device_proj(ar_raw, fp)
            (bs1_sum,) = g1_from_device_proj(bs1_raw, fp)
            if cfg.g2_over_fp:  # G2 points are plain int pairs: the G1 decoder
                (bs2_sum,) = g1_from_device_proj(bs2_raw, fp)
            elif cfg.g2_fp4:
                (bs2_sum,) = g4_from_device_proj(bs2_raw, fp, cfg.host.Fp4, cfg.host.Fp2)
            else:
                (bs2_sum,) = g2_from_device_proj(bs2_raw, fp, cfg.host.Fp2, cfg.fp2_q)
            (krs_k_sum,) = g1_from_device_proj(krs_k, fp)
            # a 1-constraint domain has deg(H) < 0 and an empty Z table
            krs_z_sum = None if krs_z_raw is None else g1_from_device_proj(krs_z_raw, fp)[0]

        # host assembly (tpusnark prove.py:254-261)
        with trace.span("groth16.assemble.host"):
            ar = G1.add(G1.add(pk.alpha_g1, ar_sum), G1.mul(pk.delta_g1, r))
            bs = G2.add(G2.add(pk.beta_g2, bs2_sum), G2.mul(pk.delta_g2, s))
            bs1 = G1.add(G1.add(pk.beta_g1, bs1_sum), G1.mul(pk.delta_g1, s))
            krs = G1.add(krs_k_sum, krs_z_sum)
            krs = G1.add(krs, G1.mul(ar, s))
            krs = G1.add(krs, G1.mul(bs1, r))
            krs = G1.add(krs, G1.mul(pk.delta_g1, (-r * s) % p))
    return Proof(ar=ar, krs=krs, bs=bs, commitments=proof_commitments, commitment_pok=pok)
