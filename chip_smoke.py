#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnark_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ``tpusnark_torch/csrc`` (one nvcc per source,
     in parallel) and print the time and each kernel's registers and spills;
then per curve (BLS24-315, BLS24-317, BW6-761, BW6-633, BLS12-377,
BLS12-381, BN254):
  3. check every kernel instance of the curve against its plain PyTorch
     version (run on a CPU copy of the same seeded inputs) at the prove's
     widths (the pointwise curve kernels over a strip row of its MSMs,
     windows x strips lanes; their plain versions on all of them, or for
     the curves of HEAD_TAIL_CURVES on the first and last CHECK_LANES // 2):
     exact equality mod p (the field ops word for word), with both times
     and the bound; B1 with one operand a broadcast constant and B2 on a
     column slice, word for word; B1 and B2 timed through the wrapper and
     alone (20 launches in a CUDA graph) at 2^17 and 2^22 lanes. The MSM's
     fused kernels (strip pass, scan step, window Horner) run
     at the prove's shapes: the strip passes over windows x strips lanes by
     the prove's rows, on keys with long runs, DEAD keys, sign flips and
     repeated points, against the step-by-step loop over the pointwise
     kernels on the card (its CPU run would take minutes: 64 rows of 1-10 s)
     and, at 8 strips a window, against the plain loop on the CPU; a
     segmented step (its plain version over the first and last windows) and a
     fold scan step and the Horner over the curve's windows against the
     plain versions on the CPU. Equality there is word for word. The NTT
     over the curve's r at 2^17: its tables built on the card against the
     host's Python lists, each pass of its plan (``k_ntt_stages``) against
     the plain pass on the CPU, and ntt, intt, ntt_coset and intt_coset on
     the card against the CPU NTT, every lane mod p;
  4. MSMs against a host sum from the curve's host module: with c = 16 on
     the strip path, G1 at N = 1024 and G2 at N = 256, and on the log-scan
     path (N = 160, the window size of that N) both groups;
  5. Groth16 on a 2^17 - 8 constraint multiplication chain over the curve's
     r: compile, setup (seeded), prove, with phase times. The port's host
     verifier must accept the proof and reject a wrong public input (for
     BLS12-381 also the bellman-checked ``bls381.verify``). The verifiers
     run in worker processes beside the later phases, because a BLS24 or
     BW6-761 pairing check is minutes of Python integers; all verdicts are
     collected before the result;
  6. every kernel instance of the prove path was launched by that prove
     (counts zeroed just before ``prove`` and read just after), and every
     setup-only instance by that curve's setup; the NTT's pass kernel exactly
     7 transforms x the passes of the 2^17 plan, B1 over fr exactly 16
     times and B2 over fr 4 times, the pointwise butterflies (still checked
     in phase 3) not at all.
Then, over BN254 fr:
  7. the NTT at 2^20 against ``Domain.ntt_ref``, and at 2^22 the round trip
     and four outputs against a Horner evaluation in Python ints (these
     host references in the worker processes, collected at the end); at
     both sizes one transform timed through the pass kernel and through
     the pointwise stage loop the pass kernel replaced.
Then the device witness solver and BSB22 commitments:
  8. per curve, the wide circuit (``wide_circuit``: 1024 product chains side
     by side, a division, an inverse and a to_binary hint) at 2^14
     constraints over the curve's r: the device solver's W against the host
     solver's, wire for wire, with both times and the launches of a warm
     device solve; over BN254 the wide circuit with a BSB22 commitment at
     2^17: seeded setup, the device solve alone against the host solver,
     one prove through the default device branch and one with
     accelerator="host" under the same rng, equal point for point
     (commitment and proof of knowledge included), each phase timed, and
     the launches of each; the branch each prove took (the chain's proves
     took the host solver: phase 6's B1 and B2 counts; the shape rule keeps
     the chain on the host and sends the wide circuit to the card); then
     tests/test_commit.py's circuit proved on the card. The port's host
     verifier must accept both proofs and reject a wrong public input (in
     the worker processes).
Then PLONK over BN254:
  9. bench.py's PLONK circuit (a mul/add chain, 131,059 gates, a 2^17
     domain): an unsafe SRS of 2^17 + 3 points from a seeded tau made on
     the card (a fixed-base multiplication), setup, one cold and two warm
     proves with phase times (solve, lro, z, quotient, open); the launches
     of setup and of the last warm prove, where every instance of the
     PLONK path ran, the NTT pass kernel exactly as often as the
     transforms and their plans fix, one strip pass over the bases and one
     Horner an MSM, and no pointwise butterfly; the composite-key commits
     of the prove's shapes (k = 3 and 2 polynomials of 2^17 + 2
     coefficients at c = 13) against separate commits at c = 16 and the
     host sum, and k = 3 over 1,024 points against the host sum; then
     tests/test_plonk_commit.py's circuit (one BSB22 commitment) proved on
     the card. The port's PLONK verifier must accept both proofs and reject
     a wrong public input (in the worker processes).
Then the Groth16 MPC ceremony over BN254 (``backend/groth16/mpcsetup.py``):
 10. (a) phase 1 at 2^17 powers of tau (2^18 - 1 tau, 2^17 alpha and 2^17
     beta points in G1, 2^17 tau points in G2): two seeded contributions on
     the card, each timed (host encode, device ladder, to_affine, decode,
     hash), its launches counted from zero (a g1_add and a g1_add_mixed a
     scalar bit for each of the three G1 lists, a g2_add and a g2_add_mixed
     for the G2 one) and its peak memory; after each, every lane of the four
     lists equals FixedBaseMul of the products of the recorded factors on
     the card, the first, last and 16 seeded lanes of each the host
     module's scalar multiple, and compute_hash() the hash; then phase 2's
     rescale of Z (2^17 - 1 points, built as init_phase2 builds them) by one
     delta^-1, every lane against FixedBaseMul. (b) The whole ceremony at
     2^9: init_phase1 and two contributions on the card right after phase
     6, init_phase2 on the wide circuit with 96 chains (450 constraints,
     544 private wires, so that L's rescale takes the card) and the
     verifiers of each link, and of a tampered one that must fail, in the
     worker processes beside phases 7-9; then, after phases 11 and 13 (a)
     (so that init_phase2's ~90 s in a worker need not be waited for), two
     phase-2 contributions on the card, extract_keys, a prove on the card whose
     verdicts the workers give, marshal round trips of the proof, vk and pk
     and the Solidity export holding the vk and the proof's calldata.
Then the sharded device layer (``tpusnark_torch/parallel``,
``backend/*/sharded.py``) over four shards of card 0:
 11. (a) ShardedMSM over BN254 at 2^17 points, G1 and G2, and its .many at
     k = 3, each equal to the unsharded MSM point for point; (b) ShardedNTT
     at 2^17 and 2^20: ntt, intt, ntt_coset and intt_coset equal to the NTT
     on every lane mod p; (c) prove_sharded on phase 5's chain and phase
     8's wide circuit with their keys, equal to their unsharded proofs
     under the same rng point for point, with the workers' verdicts, and
     warm sharded and unsharded chain proves in turns with phase times;
     (d) PLONK's prove_sharded on phase 9's circuit, equal to its proof
     field for field and verified, its proof_to_bytes round trip, its
     Solidity export and 26-word calldata, and the export refusing phase
     9's BSB22 key; each sharded path's launches counted from zero (every
     kernel it must run); (e) (a)-(c) over the distinct cards where torch
     sees several, else one line saying that it did not run.
Then the port's examples and the rollup (``tpusnark_torch/examples``), over
BN254:
 12. (a) the cubic, exponentiate and MiMC examples' main through Groth16 and
     the PLONK example's through PLONK, each with a seeded rng, and the
     SHA-256 gadget over one seeded 32-byte message (a 2^16 domain) set up
     and proved with hashlib's digest as its public input; each proof
     verified and a wrong public input rejected (in the workers), and each
     one's solver branch printed; (b) the rollup at batch 31 over 32
     accounts (depth 5): 1,034,160 constraints in a 2^20 domain, nothing
     cut: compile time and cs.stats(), the operator's batch, a seeded setup
     with its phase times (the card's fixed-base products apart from the
     host's scalars, encode and decode), the shape rule's verdict, a first
     prove and two warm proves, one on the default (device solver)
     branch and one on the host solver, in turns, each with its phase
     times, all under one rng and equal point for point; the device
     solver's witness against the host solver's on every wire; every proof
     verified with the two public roots and one rejected against root_after
     + 1; the peak device memory after setup and after the proves; (c) the
     launches of the first warm default-branch prove, counted from zero,
     every kernel of the prove path among them.
Then the standard gadgets' two proving paths (``tpusnark_torch/gadgets``):
 13. (a) the native 2-chain, run before phase 12 so that its BW6-761
     verdicts, minutes each in the workers, overlap phases 12 and 13 (b):
     phase 5's BLS12-377 chain proof and a second one of the same statement
     under another seeded rng (the proving key is then dropped) verified
     inside one BW6-761 circuit (``gadgets/recursion_native.py``, each
     proof's points secret inputs, its y public): 92,902 constraints in 2,772
     levels, a 2^17 domain, compile time and shape; a seeded BW6-761 setup;
     a prove on the default branch (the shape rule's host solver) and one
     with accelerator="host" under the same rng, equal point for point,
     with phase times, the launches of the second counted from zero (every
     kernel of the prove path among them); the device solver's witness
     (12-word fr, 2,772 levels) against the host solver's on every wire;
     the host solver refusing inner proof 0's Ar.y + 1 (off the curve) and
     the two proofs' Ar swapped (the pairing equation); the port's host
     BW6-761 verifier accepting (y, y) and rejecting (y + 1, y) in the
     workers; peak memory. (b) The commit-based range check over BN254
     (``gadgets/rangecheck.py`` on ``lookup.py``): 1,024 secret values each
     checked to 64 bits and their sum equal to a public input, 26,518
     constraints in 337 levels, a 2^15 domain, one BSB22 commitment; the
     shape rule must pick the device solver; seeded setup, one prove on
     the default branch (its launches counted from zero, every kernel of
     the prove path among them); the device solver's witness
     against the host solver's on every wire; a value of 2^64 refused by
     both solvers; the sum accepted and the sum + 1 rejected by the
     workers.
Then the EVM's precompiles over emulated arithmetic (``gadgets/emulated.py``,
``sw_emulated.py``, ``evmprecompiles.py``), over BN254:
 14. 32 EIP-196 ECADD calls (``ecadd_circuit``: P and Q as secret 64-bit
     limbs, both checked on the curve, R's limbs and identity flag public;
     call 1 doubles, call 2 annihilates): 852,416 constraints in 17 levels,
     a 2^20 domain, compile time and shape (hint-bearing levels among
     them); the shape rule must pick the device solver; a seeded setup with
     its phase times; a prove on the default branch (which must build and
     run the device solver) and one with accelerator="host" under the same
     rng, then one warm prove of each, all equal point for point, each
     with its phase times; the launches of the warm default-branch prove,
     counted from zero, every kernel of the prove path among them; the
     device solver's witness against the host solver's on every wire, with
     both solve times and the time of the device solver's hint syncs; Q.y
     + 1 on a seeded call, a claimed R.x + 1 on call 0 and flag 0 on call 2
     refused by both solvers; the true public inputs accepted and call 0's
     first output limb + 1 rejected (in the workers); peak memory.
Then the last modules of the port, over BN254:
 15. (a) PlonkFRI (``backend/plonkfri``, ``poly/fri.py``): bench.py's
     PLONK chain at 2^14 gates with the default FriParams (blowup 8, 27
     queries, stop degree 8: an LDE domain of 2^17), setup and two proves
     on the card with phase times (the Merkle trees' host leaf packing and
     sha256 apart), equal field for field; the port's host verifier
     accepting the proof and rejecting y + 1, a tampered opening and a
     zeroed root; the launches of the second prove counted from zero (B1,
     B2, add and sub over fr and the NTT pass kernel exactly as often as
     its 4 transforms over n and 5 over 8n fix); peak memory; the chain at
     2^10 proved on the card and on the CPU (in a worker), equal byte for
     byte; the 2^14 SCS through ``constraint/serialize.py``'s dump and
     load, proved again to the same proof. (b) GKR inside Groth16
     (``gadgets/gkr_compile.py`` on ``protocols/gkr.py``):
     tests/test_gkr_compile.py's DAG over 8 seeded instances, 91,886
     constraints, a 2^17 domain: compile time, cs.stats() and the shape
     rule's branch; a seeded setup; a prove on the default branch and one
     with accelerator="host" under the same rng, equal point for point,
     the launches of the second counted from zero (every kernel of the
     prove path among them); the solver refusing o0 + 1; the true outputs
     accepted and o0 + 1 rejected (in the workers). (c) Phase 5's BN254
     chain proof through the port's Groth16 Solidity contract and phase
     9's PLONK proof through its PLONK contract, both executed by
     ``testing/solidity_exec.py``: each accepts and reverts on a wrong
     public input; phase 5's assignment as a ``backend/witness.py``
     Witness through to_bytes and from_bytes.
 16. One JSON line with every kernel instance (with, beside the chain's
prove launches, those of the 2^14 wide device solve; for BW6-761, of a warm
2-chain outer prove; and for BN254, of the 2^17 wide device-branch prove,
of the PLONK prove and setup, of one 2^17 phase-1 contribution, of the
sharded chain and PLONK proves, of a warm rollup prove, of the range-check
prove, of a warm ECADD prove, of the GKR prove and of the PlonkFRI prove),
the card line, and the result line. Any failure exits non-zero before the result line. Imports neither
JAX nor the JAX package ``tpusnark``: the port stands on its own host layer.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import os
import random
import re
import subprocess
import sys
import time
from collections import namedtuple

HERE = os.path.dirname(os.path.abspath(__file__))
LOG2_CONSTRAINTS = 17
SEED = 20261016
# the NTT's large sizes, BN254 fr only (phase 7)
LARGE_NTT_LOG2 = (20, 22)
# the wide circuit (phase 8): chains of products side by side, over every
# curve's r at 2^WIDE_SOLVE_LOG2 constraints, and over BN254 with a BSB22
# commitment at 2^LOG2_CONSTRAINTS
WIDE_CHAINS = 1024
WIDE_SOLVE_LOG2 = 14
# the curves whose verdicts take longest first: they are computed beside the
# rest
CURVES = ("bls24-315", "bls24-317", "bw6-761", "bw6-633", "bls12-377", "bls12-381", "bn254")
# the pointwise curve kernels are timed over a strip row of the MSMs and held
# against their plain versions on every lane of it, but for these curves on
# its first and last CHECK_LANES // 2 lanes (the launch's first and last
# blocks), which keeps the plain CPU runs of the wider rows to seconds
HEAD_TAIL_CURVES = ("bw6-761", "bls12-377", "bls12-381", "bn254")
CHECK_LANES = 2048

# The card's peaks for the kernels' bounds. Device memory: 3.35 TB/s (NVIDIA's
# H100 SXM data sheet). 32-bit integer multiply-adds: the data sheet's 67
# TFLOP/s of float32 are 33.5e12 fused multiply-adds a second on 128 lanes
# per SM; an SM has 64 int32 lanes, so 16.75e12 integer multiply-adds.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12

CSRC = "tpusnark_torch/csrc"
JFIELD, JNTT, JCURVE = "tpusnark/fields/jfield.py", "tpusnark/poly/ntt.py", "tpusnark/curves/jcurve.py"
JPIP = "tpusnark/msm/pippenger.py"
# the tpusnark function each op replaces; add, sub and neg were XLA ops
# there, the others reach the TPU kernel through fuse()
REPLACES = {
    "mul": f"{JFIELD}:468",
    "from_mont": f"{JFIELD}:510",
    "add": f"{JFIELD}:278",
    "sub": f"{JFIELD}:283",
    "neg": f"{JFIELD}:292",
    "butterfly": f"{JNTT}:177",
    "butterfly4": f"{JNTT}:200",
    "ntt_stages": f"{JNTT}:200",
    "g1_add": f"{JCURVE}:466",
    "g2_add": f"{JCURVE}:466",
    "g1_add_mixed": f"{JCURVE}:470",
    "g2_add_mixed": f"{JCURVE}:470",
}
# the fused MSM kernels replace the TPU kernel whose group law they run,
# and absorb the tpusnark loop around it (strip_flush; fold_sum,
# log_scan_buckets and small_weighted; the Horner scan over the windows)
# the NTT's pass kernel runs B4's step and B3's, and the stage loop
ABSORBS = {"ntt_stages": f"{JNTT}:177, :130"}
for _g in ("g1", "g2"):
    REPLACES[f"{_g}_strip_mixed"] = f"{JCURVE}:470"
    ABSORBS[f"{_g}_strip_mixed"] = f"{JPIP}:420"
    for _op, _loops in (("strip", ":420"), ("scan_step", ":371, :391, :491"), ("horner", ":658")):
        REPLACES[f"{_g}_{_op}"] = f"{JCURVE}:466"
        ABSORBS[f"{_g}_{_op}"] = JPIP + _loops
# the pointwise mixed add runs once per scalar bit of setup's fixed-base
# multiplication; the prove's mixed adds are all inside the strip kernel
SETUP_ONLY_CURVE_OPS = ("g1_add_mixed", "g2_add_mixed")
# Checked in phase 3 but on neither the setup's nor the prove's path at 2^17,
# where G2 lies over Fp (no Fp2 or Fp4 inversion): neg[fp] then serves only the
# MSM's log-scan path (96 < records < 2^15), which phase 4 drives.
OFF_PATH_OPS = ("neg",)
# B3 and B4 pointwise, over every scalar field: checked in phase 3, and on no
# path since the transform runs as passes of the pass kernel
OFF_PATH_NTT_OPS = ("butterfly", "butterfly4")
# transforms a prove runs: 3 INTT, 3 coset NTT and 1 coset INTT (compute_h_dev)
NTTS_PER_PROVE = 7
# B1 and B2 over fr a prove launches: per A, B, C the coefficient products,
# a product by R^2 and a REDC (reduce_columns), a product by 1/n (INTT) and
# a coset scaling; then a*b, the product by 1/Z_H, and the coset INTT's 1/n
# and scaling; one REDC of h
B1_PER_PROVE = 16
B2_PER_PROVE = 4
# B1 and B2 alone at this width too (phase 3)
WIDE_LOG2 = 22
# the B1 and B2 rows' extra keys in the kernel line: times alone (a CUDA
# graph of launches), at 2^WIDE_LOG2, and of the broadcast and strided forms
B1_B2_KEYS = ("alone_ms", "ms_2p22", "alone_ms_2p22", "bound_ms_2p22", "broadcast", "column_slice")
# per 2^17 prove: one strip pass over the bases and one Horner per MSM, and
# at most this many launches of the B6 family (pointwise add, projective
# strip pass, scan step, Horner) at any window count
MSMS_PER_PROVE = 5
MAX_B6_LAUNCHES = 450
# base-field ops the prove never launches: setup's Fermat inversion and key
# decode (to_affine, to_host) are the only base-field muls, add/subs, negs
# and from_monts outside the curve kernels (the prove negated the gathered
# bases with neg[fp] until the strip kernel took that over). Checked in
# phase 3, launched by setup.
SETUP_ONLY_OPS = ("mul", "add", "sub", "neg", "from_mont")
# (the add, sub and neg come from the Fp2 inversion of to_affine, also inside
# the Fp4 one of the BLS24 curves: the BW6 curves, whose G2 lies over Fp,
# have no add and no sub instance, and their neg is OFF_PATH_OPS above).


# a circuit, its keys and assignment, a proof and the seed of its rng (phases
# 5, 8 and 9 hand theirs to phase 11)
Proved = namedtuple("Proved", "cs pk vk assign proof seed")

_POOL = None  # the verifier processes, once started


def stop_workers() -> None:
    global _POOL
    if _POOL is not None:
        _POOL.terminate()
        _POOL.join()
        _POOL = None


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    stop_workers()
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def kernel_table():
    """instance -> (source, replaces), per curve; the setup-only ones; and
    the ones off the 2^17 path."""
    from tpusnark_torch import kernels

    table, setup_only, off_path = {}, set(), set()
    for curve, (_, fp) in kernels.CURVES.items():
        for name in kernels.instances(curve):
            op, arg = name[:-1].split("[")
            if op[3:] in kernels.MSM_KERNELS:
                unit = kernels._tag(fp) if curve in kernels.G2_OVER_FP else f"{kernels._tag(fp)}_{op[:2]}"
                src = f"{CSRC}/msm_{unit}.cu"
            elif op.startswith("g"):
                src = f"{CSRC}/curve_{kernels._tag(fp)}.cu"
            else:
                src = f"{CSRC}/{'ntt' if op.startswith(('butterfly', 'ntt')) else 'field'}.cu"
            table[name] = (src, REPLACES[op])
            if (arg == fp and op in OFF_PATH_OPS and curve in kernels.G2_OVER_FP) or op in OFF_PATH_NTT_OPS:
                off_path.add(name)
            elif (arg == fp and op in SETUP_ONLY_OPS) or op in SETUP_ONLY_CURVE_OPS:
                setup_only.add(name)
    return table, setup_only, off_path


# ---------------------------------------------------------------- phase 1
def phase_card():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "tpusnark_torch")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        card = ""
    if not card:
        fail("nvidia-smi did not report the card")
    say(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    return torch, card


# ---------------------------------------------------------------- phase 2
def ptxas_summary(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function of an `nvcc -Xptxas -v` report."""
    rows, name, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)  # the entry, or a device function it calls
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and props == name:
            rows.append([name, None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    return rows


def phase_build():
    from tpusnark_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    say(
        f"[2 build] {time.perf_counter() - t0:.2f} s "
        f"(compiled={kernels.BUILD_INFO['compiled']}) {kernels.BUILD_INFO['path']}"
    )
    for src, sec in kernels.BUILD_INFO.get("source_seconds", {}).items():
        say(f"[2 build] {src} {sec:.2f} s")
    for name, regs, st, ld in ptxas_summary(kernels.BUILD_INFO["ptxas"]):
        say(f"[2 regs] {name} registers={regs} spill_stores={st} spill_loads={ld}")


# ---------------------------------------------------------------- phase 3
def _lazy_words(np_rng, n, p, words):
    """(words, n) uint32 words of values in [0, 2p), edge cases first."""
    import numpy as np

    top = ((2 * p).bit_length() - 1) // 32  # the highest nonzero word of 2p
    w = np_rng.integers(0, 1 << 32, size=(words, n), dtype=np.uint64)
    w[top] = np_rng.integers(0, (2 * p) >> (32 * top), size=n, dtype=np.uint64)
    w[top + 1 :] = 0
    for i, v in enumerate((0, 1, p - 1, p, p + 1, 2 * p - 1)):
        for k in range(words):
            w[k, i] = (v >> (32 * k)) & 0xFFFFFFFF
    return w.astype(np.uint32).view(np.int32)


def _time_cuda(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph(torch, fn, reps=20, replays=3):
    """ms a launch of the kernels fn() launches, without the host's launch
    path: reps calls of fn captured into one CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def _time_host(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _compare(torch, field, got, want):
    """Mismatching lanes and max |difference| of the values mod p."""
    g, w = field.canon(got.cpu()), field.canon(want)
    bad = (g != w).any(dim=0)
    n_bad = int(bad.sum())
    err = 0.0
    if n_bad:
        idx = torch.nonzero(bad).flatten()[:64]
        gi = field.decode(g[:, idx], mont=False)
        wi = field.decode(w[:, idx], mont=False)
        err = float(max(abs(a - b) for a, b in zip(gi, wi)))
    return n_bad, err


# Fp products of one product over Fp, Fp2 (Karatsuba) and Fp4 (Karatsuba
# over Fp2)
PRODUCTS_PER_MUL = {1: 1, 2: 3, 4: 9}


def mont_imads(words: int) -> int:
    """32-bit integer multiply-add instructions of one Montgomery product of
    `words` words (CIOS, csrc/mont.cuh): 2 words^2 word products (a*b and
    m*p), each a low and a high half, and the low half of the `words`
    products m = t0 * inv."""
    return 4 * words * words + words


def kernel_bound(words, lanes, rows_in, rows_out, products, extra_bytes=0, active=None):
    """(bound_ms, bound_by) of one launch: the larger of its bytes over the
    card's memory rate and its integer multiply-adds over the card's rate.
    rows_in / rows_out: element rows read and written per lane, each read or
    written once; products: Montgomery products per active lane (for REDC
    alone half a product); active: the lanes that do the arithmetic in this
    run's data (add_mixed's infinity lanes only copy)."""
    byts = (rows_in + rows_out) * 4 * words * lanes + extra_bytes
    ops = products * mont_imads(words) * (lanes if active is None else active)
    return bound_of(byts, ops)


def bound_of(byts, imads):
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and integer multiply-adds over the card's rate."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_b1_b2(torch, field, a, b, a_c):
    """B1 by a broadcast constant and B2 on a column slice of a, every lane
    against the plain versions word for word; then B1 and B2 (and those
    forms) timed through the wrapper and alone, at a's width (the prove's)
    and at 2^WIDE_LOG2 lanes. Returns the extra keys of the mul row and of
    the from_mont row."""
    words, n, name = field.n, a.shape[1], field.spec.name
    c = field.const(SEED % field.modulus, mont=True, device=a.device)
    bc = field.broadcast_const(c, a)
    cols = a[:, : n - 1]  # compute_h_dev's h[:, : n - 1]: rows at stride n
    cases = (
        ("mul by a broadcast constant", lambda: field.mul(a, bc), lambda: field.mul(a_c, field.broadcast_const(c.cpu(), a_c))),
        ("from_mont of a column slice", lambda: field.from_mont(cols), lambda: field.from_mont(a_c[:, : n - 1])),
    )
    for what, run, plain in cases:
        got = run()
        torch.cuda.synchronize()
        bad = _words_differ(torch, [got], [plain()])
        if bad:
            fail(f"kernel {name}: {what} disagrees with the plain version on {bad} lanes (word for word)")
    wide = 1 << WIDE_LOG2
    a22, b22 = a.repeat(1, wide // n), b.repeat(1, wide // n)
    bc22 = field.broadcast_const(c, a22)
    runs = {
        "mul": (lambda x, y: field.mul(x, y), (a, b), (a22, b22), (2, 1, 1)),
        "mul_bcast": (lambda x, y: field.mul(x, y), (a, bc), (a22, bc22), (1, 1, 1)),
        "from_mont": (lambda x: field.from_mont(x), (a,), (a22,), (1, 1, 0.5)),
        "from_mont_slice": (lambda x: field.from_mont(x), (cols,), (a22[:, : wide - 1],), (1, 1, 0.5)),
    }
    out = {}
    for label, (fn, args, args22, shape) in runs.items():
        row = dict(
            ms=_time_cuda(torch, lambda: fn(*args)),
            alone_ms=_time_graph(torch, lambda: fn(*args)),
            bound_ms=kernel_bound(words, n, *shape)[0],
            ms_2p22=_time_cuda(torch, lambda: fn(*args22)),
            alone_ms_2p22=_time_graph(torch, lambda: fn(*args22)),
            bound_ms_2p22=kernel_bound(words, wide, *shape)[0],
        )
        out[label] = row
        say(
            f"[3 b1b2] {label}[{name}] 2^{n.bit_length() - 1}: wrapper {row['ms']:.4f} ms, alone "
            f"{row['alone_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms | 2^{WIDE_LOG2}: wrapper "
            f"{row['ms_2p22']:.4f} ms, alone {row['alone_ms_2p22']:.4f} ms, bound {row['bound_ms_2p22']:.4f} ms"
        )
    del a22, b22, bc22
    torch.cuda.empty_cache()
    say(f"[3 check] {name}: mul by a broadcast constant and from_mont of a column slice equal the plain versions word for word")

    def keys(plain, form, form_name):
        r = out[plain]
        return dict(
            alone_ms=r["alone_ms"],
            ms_2p22=r["ms_2p22"],
            alone_ms_2p22=r["alone_ms_2p22"],
            bound_ms_2p22=r["bound_ms_2p22"],
            **{form_name: out[form]},
        )

    return keys("mul", "mul_bcast", "broadcast"), keys("from_mont", "from_mont_slice", "column_slice")


def phase_kernels(torch, curve, np_rng, n_wires):
    """Every kernel instance of one curve against its plain version, at the
    widths that a prove over `n_wires` wires gives it."""
    from tpusnark_torch import kernels
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.tcurve import CurveOps, curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import get_msm_for
    from tpusnark_torch.poly.ntt import get_ntt

    dev = torch.device("cuda")
    results = {}

    def record(name, field, run_kernel, run_plain, lanes, bound, sel=None, words=False):
        """run_kernel() -> CUDA outputs; run_plain() -> the CPU outputs of
        the plain version on the same inputs, or on the lanes `sel` (an index
        tensor) of them, which are then the kernel's lanes compared; with
        `words`, word for word and not only mod p."""
        got = run_kernel()
        torch.cuda.synchronize()
        want, plain_ms = _time_host(run_plain)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        n_bad, err = 0, 0.0
        for g, w in zip(got, want):
            b, e = _compare(torch, field, g if sel is None else g[:, sel.to(g.device)], w)
            if words:
                b = max(b, _words_differ(torch, [w], [g]))
            n_bad += b
            err = max(err, e)
        ms = _time_cuda(torch, run_kernel)
        results[name] = dict(
            lanes=lanes,
            plain_lanes=lanes if sel is None else len(sel),
            mismatches=n_bad,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound[0],
            bound_by=bound[1],
        )
        if n_bad:
            fail(f"kernel {name} disagrees with its plain version on {n_bad} lanes")

    n = 1 << LOG2_CONSTRAINTS  # compute_h's pointwise products
    cfg = get_curve(curve)
    fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
    # (element rows read, rows written, Montgomery products) per lane
    field_shape = {"mul": (2, 1, 1), "add": (2, 1, 0), "sub": (2, 1, 0), "from_mont": (1, 1, 0.5), "neg": (1, 1, 0)}
    for field in (fr, fp):
        p, words, name = field.modulus, field.n, field.spec.name
        a_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
        b_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
        a, b = a_c.to(dev), b_c.to(dev)
        for op in kernels.BASE_FIELDS.get(name, kernels.FIELD_OPS):
            binary = op in ("mul", "add", "sub")
            record(
                f"{op}[{name}]",
                field,
                (lambda: getattr(field, op)(a, b)) if binary else (lambda: getattr(field, op)(a)),
                (lambda: getattr(field, op)(a_c, b_c)) if binary else (lambda: getattr(field, op)(a_c)),
                n,
                kernel_bound(words, n, *field_shape[op]),
                words=True,
            )
        b1, b2 = phase_b1_b2(torch, field, a, b, a_c)
        results[f"mul[{name}]"].update(b1)
        results[f"from_mont[{name}]"].update(b2)

    # NTT butterflies over fr, at the flat widths of a 2^17 transform
    p, words, tag = fr.modulus, fr.n, fr.spec.name
    ntt_c, ntt_g = get_ntt(cfg.fr_spec, 2, "cpu"), get_ntt(cfg.fr_spec, 2, dev)
    n2, n4 = n // 2, n // 4
    xs_c = [torch.from_numpy(_lazy_words(np_rng, n2, p, words)) for _ in range(7)]
    xs = [x.to(dev) for x in xs_c]
    record(
        f"butterfly[{tag}]",
        fr,
        lambda: ntt_g.butterfly(*xs[:3]),
        lambda: ntt_c.butterfly(*xs_c[:3]),
        n2,
        kernel_bound(words, n2, 3, 2, 1),
    )
    xs4_c = [x[:, :n4].contiguous() for x in xs_c]
    xs4 = [x.to(dev) for x in xs4_c]
    record(
        f"butterfly4[{tag}]",
        fr,
        lambda: ntt_g.butterfly4(*xs4),
        lambda: ntt_c.butterfly4(*xs4_c),
        n4,
        kernel_bound(words, n4, 7, 4, 4),
    )

    # curve kernels on arbitrary coordinates (the formulas are polynomial
    # identities), with identity lanes, P + P lanes and infinity lanes, over
    # one strip row of the prove's MSMs: windows x strips lanes (16 x 2048 for
    # scalars up to 255 bits, 20 x 2048 for BW6-633's 315, 24 x 2048 for
    # BW6-761's 377)
    p = fp.modulus
    for group, ops in zip(("g1", "g2"), curve_ops(curve)):
        msm = get_msm_for(group, n_wires, curve)
        nc = msm.n_windows * msm.strip_shape(n_wires)[0]
        plain = CurveOps(ops.fa)
        d = ops.degree
        # Fp products per point add: 12 (add) or 11 (add_mixed) products and
        # two by 3b (none where 3b = 9 is an add chain); an Fp2 product is 3,
        # an Fp4 product 9
        b3_products = 0 if (d == 1 and ops.fa.b3 == 9) else 2
        per = PRODUCTS_PER_MUL[d]

        def coords(k):
            return [torch.from_numpy(_lazy_words(np_rng, nc, p, fp.n)) for _ in range(k * d)]

        P1 = coords(3)
        Q = coords(3)
        one = fp.encode([1] * 8)
        for c in range(d):  # lanes 0..7: P1 = identity (0 : 1 : 0)
            P1[c][:, :8] = 0
            P1[d + c][:, :8] = one if c == 0 else 0
            P1[2 * d + c][:, :8] = 0
        for k in range(3 * d):  # lanes 8..15: Q = P1 (doubling)
            Q[k][:, 8:16] = P1[k][:, 8:16]
        inf_c = torch.from_numpy(np_rng.random(nc) < 0.1)

        def pt(cs):
            return tuple(ops.fa.from_components(cs[i * d : (i + 1) * d]) for i in range(3))

        def flat(out):
            return [c for x in out for c in ops.fa.components(x)]

        Pg = [x.to(dev) for x in P1]
        Qg = [x.to(dev) for x in Q]
        inf_g = inf_c.to(dev)
        sel = None
        if curve in HEAD_TAIL_CURVES:
            h = CHECK_LANES // 2
            sel = torch.cat([torch.arange(h), torch.arange(nc - h, nc)])
            P1, Q, inf_c = [x[:, sel] for x in P1], [x[:, sel] for x in Q], inf_c[sel]
        record(
            f"{group}_add[{curve}]",
            fp,
            lambda: flat(ops.add(pt(Pg), pt(Qg))),
            lambda: flat(plain.add(pt(P1), pt(Q))),
            nc,
            kernel_bound(fp.n, nc, 6 * d, 3 * d, per * (12 + b3_products)),
            sel,
        )
        aff_g = pt(Qg)[:2] + (inf_g,)
        aff_c = pt(Q)[:2] + (inf_c,)
        record(
            f"{group}_add_mixed[{curve}]",
            fp,
            lambda: flat(ops.add_mixed(pt(Pg), aff_g)),
            lambda: flat(plain.add_mixed(pt(P1), aff_c)),
            nc,
            kernel_bound(
                fp.n, nc, 5 * d, 3 * d, per * (11 + b3_products), extra_bytes=nc, active=nc - int(inf_g.sum())
            ),
            sel,
        )

    results.update(phase_ntt(torch, curve, np_rng, dev))
    for name, r in results.items():
        r["plain_device"] = "cpu"
    results.update(phase_msm_kernels(torch, curve, np_rng, n_wires, dev))
    for name, r in results.items():
        say(
            f"[3 check] {name:26s} lanes={r['lanes']:6d} mismatches={r['mismatches']} "
            f"kernel={r['ms']:.4f} ms bound={r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"plain({r['plain_device']}, {r['plain_lanes']} lanes)={r['plain_ms']:.1f} ms"
        )
    missing = sorted(set(kernels.instances(curve)) - set(results))
    if missing:
        fail(f"kernels not checked: {missing}")
    return results


def ntt_pass_bound(words, lanes, s0, m):
    """(bound_ms, bound_by) of one pass of the NTT over `lanes` lanes: each
    element read and written once, the pass's columns of the twiddle table
    (stages s0 .. s0+m-1) read once, m/2 products an element."""
    cols = (1 << (s0 + m)) - (1 << s0)
    return bound_of((2 * lanes + cols) * 4 * words, m * (lanes // 2) * mont_imads(words))


def ntt_bound(words, n):
    """(bound_ms, bound_by) of one transform of n: the data read and written
    once, the whole table read once, log2(n) stages of n/2 products."""
    k = n.bit_length() - 1
    return bound_of((3 * n - 1) * 4 * words, k * (n // 2) * mont_imads(words))


def host_packed(p, n, w):
    """The packed twiddle table of the n-th root w in Python ints: stage s at
    columns [2^s - 1, 2^(s+1) - 1) holds w^(j n / 2^(s+1)), j < 2^s."""
    out = []
    for s in range(n.bit_length() - 1):
        step, v = pow(w, n >> (s + 1), p), 1
        for _ in range(1 << s):
            out.append(v)
            v = v * step % p
    return out


def phase_ntt(torch, curve, np_rng, dev):
    """The NTT over the curve's r at 2^17: tables, passes and transforms
    against the host and the plain versions. Returns the pass kernel's row."""
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.poly.ntt import NTT, get_ntt

    n = 1 << LOG2_CONSTRAINTS
    spec = get_curve(curve).fr_spec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ntt = get_ntt(spec, n, dev)  # the prove's, built here
    cs, csi = ntt._coset_tables()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    fr, d = ntt.field, ntt.domain
    p, words, name = fr.modulus, fr.n, f"ntt_stages[{spec.name}]"
    host, host_ms = _time_host(
        lambda: [
            host_packed(p, n, d.generator),
            host_packed(p, n, d.generator_inv),
            d.coset_powers(inv=False),
            d.coset_powers(inv=True),
        ]
    )
    for what, got, want in zip(("twiddles", "inverse twiddles", "coset powers", "inverse coset powers"),
                               (ntt._tw_fwd, ntt._tw_inv, cs, csi), host):
        n_bad, _ = _compare(torch, fr, got, fr.encode(want))
        if n_bad:
            fail(f"{curve}: the card's NTT {what} differ from the host's on {n_bad} columns")
    say(
        f"[3 ntt] {curve}: tables built on the card in {build_ms:.1f} ms equal the host's Python lists "
        f"(host {host_ms:.0f} ms, without encoding)"
    )

    # each pass of the plan on the card against the plain pass on the CPU, on
    # the same input: the first on a bit-reversed row, each later one on the
    # plain output of the one before
    x_c = torch.from_numpy(_lazy_words(np_rng, n, p, words))
    cur_c, tw_c = x_c.index_select(-1, ntt._bitrev.cpu()), ntt._tw_fwd.cpu()
    rows = []
    for s0, m in ntt.plan:
        cur_g = cur_c.to(dev)
        got = ntt.ntt_stages(cur_g, ntt._tw_fwd, s0, m)
        torch.cuda.synchronize()
        want, plain_ms = _time_host(lambda: ntt.ntt_stages_plain(cur_c, tw_c, s0, m))
        n_bad, err = _compare(torch, fr, got, want)
        words_bad = int((got.cpu() != want).any(dim=0).sum())
        if n_bad or words_bad:
            fail(f"kernel {name} pass ({s0}, {m}) disagrees with the plain pass on {n_bad} lanes ({words_bad} by words)")
        ms = _time_cuda(torch, lambda: ntt.ntt_stages(cur_g, ntt._tw_fwd, s0, m))
        bound = ntt_pass_bound(words, n, s0, m)
        rows.append((ms, plain_ms, bound, err))
        say(
            f"[3 check] {name} pass (s0={s0}, m={m}) lanes={n} mismatches=0 (word for word) kernel={ms:.4f} ms "
            f"bound={bound[0]:.4f} ms ({bound[1]}) plain(cpu)={plain_ms:.1f} ms"
        )
        cur_c = want

    # the four transforms on the card against the CPU NTT, every lane
    ntt_c = NTT(spec, n, "cpu")
    x_g = x_c.to(dev)
    times = []
    for op in ("ntt", "intt", "ntt_coset", "intt_coset"):
        got = getattr(ntt, op)(x_g)
        torch.cuda.synchronize()
        want, plain_ms = _time_host(lambda: getattr(ntt_c, op)(x_c))
        n_bad, _ = _compare(torch, fr, got, want)
        if n_bad:
            fail(f"{curve}: the card's {op} at 2^{LOG2_CONSTRAINTS} differs from the CPU NTT on {n_bad} lanes")
        times.append(f"{op}={_time_cuda(torch, lambda: getattr(ntt, op)(x_g)):.4f} ms (cpu {plain_ms:.0f} ms)")
    tb = ntt_bound(words, n)
    say(
        f"[3 ntt] {curve}: 2^{LOG2_CONSTRAINTS} transforms on the card equal the CPU NTT on every lane, "
        f"{len(ntt.plan)} passes {ntt.plan}: " + " ".join(times) + f" | transform bound {tb[0]:.4f} ms ({tb[1]})"
    )
    k = len(rows)
    by = max(rows, key=lambda r: r[2][0])[2][1]
    return {
        name: dict(
            lanes=n,
            plain_lanes=n,
            mismatches=0,
            max_abs_err=max(r[3] for r in rows),
            # one launch: the mean over the plan's passes
            ms=sum(r[0] for r in rows) / k,
            plain_ms=sum(r[1] for r in rows) / k,
            bound_ms=sum(r[2][0] for r in rows) / k,
            bound_by=by,
        )
    }


def _words_differ(torch, got, want):
    """Lanes on which two lists of (words, *batch) word tensors, or (*batch)
    key tensors, differ."""
    bad = None
    for g, w in zip(got, want):
        d = g != w.to(g.device)
        # keys (int64) have no word axis
        d = d.reshape(-1) if g.dtype == torch.int64 else d.reshape(g.shape[0], -1).any(dim=0)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def strip_inputs(torch, np_rng, fp, fr, n0, fa):
    """Bases, scalars and an infinity mask (CPU tensors) for a strip pass over
    n0 records a window, coordinates as the arithmetic `fa` holds them:
    arbitrary coordinates (the formulas are polynomial identities), a
    repeated point under a repeated scalar (a doubling inside a key run), 300
    records under one scalar (a run longer than a strip), one-word scalars
    (DEAD keys in every upper window), zero scalars and infinity inputs."""
    from tpusnark_torch.msm.pippenger import tree_map

    def coord():
        words = (torch.from_numpy(_lazy_words(np_rng, n0, fp.modulus, fp.n)) for _ in range(fa.degree))
        return fa.from_components(list(words))

    def each(fn, x):
        return tree_map(fn, x)

    def repeat_point(a):
        a[:, 8:12] = a[:, 7:8]
        return a

    X, Y = each(repeat_point, coord()), each(repeat_point, coord())
    scalars = torch.from_numpy(_lazy_words(np_rng, n0, fr.modulus // 2, fr.n))
    scalars[:, 8:12] = scalars[:, 7:8]
    scalars[:, 100:400] = scalars[:, 99:100]
    scalars[1:, 1000:1200] = 0
    inf = torch.from_numpy(np_rng.random(n0) < 0.01)
    return X, Y, scalars, inf


def phase_msm_kernels(torch, curve, np_rng, n_wires, dev):
    """The MSM's fused kernels of one curve (csrc/msm.cuh) at the shapes of a
    prove over `n_wires` wires, each against its plain version."""
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import _pad_last, _take, get_msm_for, tree_map

    cfg = get_curve(curve)
    fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
    results = {}

    def to(x, device):
        return tree_map(lambda a: a.to(device), x)

    def flat(pt):
        """The leaves of a point (coordinates over any tower), in order."""
        return [c for x in pt for c in (flat(x) if isinstance(x, tuple) else (x,))]

    def record(name, run_kernel, want, plain_ms, plain_device, lanes, bound, reps, plain_lanes=None, cut=None):
        """cut(outputs) -> the part of the kernel's outputs that the plain
        version computed (its first windows), where it ran on a part."""
        got = run_kernel()
        torch.cuda.synchronize()
        n_bad = _words_differ(torch, got if cut is None else cut(got), want)
        if n_bad:
            fail(f"kernel {name} disagrees with its plain version on {n_bad} lanes")
        results[name] = dict(
            lanes=lanes,
            plain_lanes=plain_lanes or lanes,
            mismatches=0,
            max_abs_err=0.0,
            ms=_time_cuda(torch, run_kernel, reps),
            plain_ms=plain_ms,
            plain_device=plain_device,
            bound_ms=bound[0],
            bound_by=bound[1],
        )

    for group, ops in zip(("g1", "g2"), curve_ops(curve)):
        msm = get_msm_for(group, n_wires, curve)
        W, c = msm.n_windows, msm.c
        C, R = msm.strip_shape(n_wires)
        dead = msm.nbuckets  # DEAD: the first key that reaches no bucket
        sent = dead + 1
        d = ops.degree
        imads = PRODUCTS_PER_MUL[d] * mont_imads(fp.n)
        b3_products = 0 if (d == 1 and ops.fa.b3 == 9) else 2
        row = 4 * fp.n * d  # bytes of one coordinate

        def strip_case(n0, C, R):
            X, Y, scalars, inf = strip_inputs(torch, np_rng, fp, fr, n0, ops.fa)
            skey, order, ssgn = msm._sort_records(scalars[:, None, :], inf, C * R)
            return (X, Y), skey, order, ssgn

        def run_strip_mixed(XY, skey, order, ssgn, C, R):
            fk, fp_ = msm._strip_mixed(skey, order, ssgn, XY, 1, C, R, dead, sent)
            return [fk] + flat(fp_)

        def strip_loop(XY, skey, order, ssgn, C, R):
            """The strip pass step by step (one pointwise kernel per row on
            the card, the plain group law on the CPU)."""
            Xg, Yg = msm._gather_bases(XY, 1, C * R, order)
            Yg = ops.fa.select(ssgn, ops.fa.neg(Yg), Yg)
            fk, fp_ = msm._strip_flush(skey, (Xg, Yg), C, R, dead, sent, mixed=True)
            return [fk] + flat(fp_)

        def adds_of(skey, C, R, dead):
            """The adds a strip pass makes: a row in its key's run, below dead."""
            k2 = skey.reshape(skey.shape[0], C, R)
            return int(((k2[..., 1:] == k2[..., :-1]) & (k2[..., 1:] < dead)).sum())

        # --- the strip pass over the bases: B5
        # cut to 8 strips a window against the plain loop on the CPU
        XY_c, skey_c, order_c, ssgn_c = strip_case(8 * R - 12, 8, R)
        want_small, small_ms = _time_host(lambda: strip_loop(XY_c, skey_c, order_c, ssgn_c, 8, R))
        got_small = run_strip_mixed(to(XY_c, dev), skey_c.to(dev), order_c.to(dev), ssgn_c.to(dev), 8, R)
        n_bad = _words_differ(torch, got_small, want_small)
        if n_bad:
            fail(f"kernel {group}_strip_mixed[{curve}] disagrees with the plain CPU loop on {n_bad} records")
        say(
            f"[3 check] {group}_strip_mixed[{curve}] at {W} x 8 strips x {R} rows equals the plain CPU loop "
            f"(plain {small_ms:.1f} ms)"
        )
        # the prove's shape against the loop over the pointwise kernels
        XY, skey, order, ssgn = (to(x, dev) for x in strip_case(n_wires, C, R))
        want = strip_loop(XY, skey, order, ssgn, C, R)  # also warms the allocator for the timed run
        torch.cuda.synchronize()
        _, loop_ms = _time_host(lambda: (strip_loop(XY, skey, order, ssgn, C, R), torch.cuda.synchronize())[0])
        adds = adds_of(skey, C, R, dead)
        n_rec = W * (R + 1) * C
        byts = 17 * W * C * R + 2 * row * n_wires + n_rec * (8 + 3 * row)
        record(
            f"{group}_strip_mixed[{curve}]",
            lambda: run_strip_mixed(XY, skey, order, ssgn, C, R),
            want,
            loop_ms,
            "cuda",
            W * C,
            bound_of(byts, adds * (11 + b3_products) * imads),
            3,
        )
        fkeys, fpts = want[0], msm.ops._point(want[1:])
        del want

        # --- the strip pass over projective records: B6, on the flush
        # records above, as weighted_from_records re-sorts them (hi part)
        K = min(fkeys.shape[-1], msm.nbuckets + C)
        ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K]
        skey2 = torch.gather(fkeys, -1, ridx) >> 8
        pts2 = tree_map(lambda a: _take(a, ridx), fpts)
        del fkeys, fpts
        C2 = max(128, min(1024, 1 << max(0, (K - 1).bit_length() - 5)))
        R2 = -(-K // C2)
        dead2 = msm.nbuckets >> 8  # the hi pass's dropped overflow key
        sent2 = dead2 + 1
        skey2 = _pad_last(skey2, C2 * R2, sent2)
        pts2 = tree_map(lambda a: _pad_last(a, C2 * R2), pts2)

        def run_strip(skey, pts, C, R):
            fk, fp_ = msm._strip(skey, pts, C, R, dead2, sent2)
            return [fk] + flat(fp_)

        def strip_proj_loop(skey, pts, C, R):
            fk, fp_ = msm._strip_flush(skey, pts, C, R, dead2, sent2, mixed=False)
            return [fk] + flat(fp_)

        # cut to the first 8 strips of every window against the plain CPU loop
        sk_c = skey2[:, : 8 * R2].contiguous()
        pt_c = tree_map(lambda a: a[..., : 8 * R2].contiguous(), pts2)
        want_small, small_ms = _time_host(lambda: strip_proj_loop(sk_c.cpu(), to(pt_c, "cpu"), 8, R2))
        n_bad = _words_differ(torch, run_strip(sk_c, pt_c, 8, R2), want_small)
        if n_bad:
            fail(f"kernel {group}_strip[{curve}] disagrees with the plain CPU loop on {n_bad} records")
        say(
            f"[3 check] {group}_strip[{curve}] at {W} x 8 strips x {R2} rows equals the plain CPU loop "
            f"(plain {small_ms:.1f} ms)"
        )
        want = strip_proj_loop(skey2, pts2, C2, R2)
        torch.cuda.synchronize()
        _, loop_ms = _time_host(lambda: (strip_proj_loop(skey2, pts2, C2, R2), torch.cuda.synchronize())[0])
        adds = adds_of(skey2, C2, R2, dead2)
        byts = W * C2 * R2 * (8 + 3 * row) + W * (R2 + 1) * C2 * (8 + 3 * row)
        record(
            f"{group}_strip[{curve}]",
            lambda: run_strip(skey2, pts2, C2, R2),
            want,
            loop_ms,
            "cuda",
            W * C2,
            bound_of(byts, adds * (12 + b3_products) * imads),
            3,
        )
        fkeys2, fpts2 = want[0], msm.ops._point(want[1:])
        del want, pts2

        # --- scan steps: B6. A segmented step over the strip pass's
        # survivors (shift -8 under the keys) and a fold step over 256 slots
        # a window, against the plain versions on the CPU
        K2 = min(fkeys2.shape[-1], (msm.nbuckets >> 8) + C2)
        ridx = torch.argsort(fkeys2, dim=-1, stable=True)[:, :K2]
        skey3 = torch.gather(fkeys2, -1, ridx)
        pts3 = tree_map(lambda a: _take(a, ridx), fpts2)
        del fkeys2, fpts2
        F = min(256, K2)  # the fold of weighted_from_records' 256 lo slots
        fold = tree_map(lambda a: a[..., :F].reshape(a.shape[0], W, 1, F).contiguous(), pts3)
        # the segmented step's plain version over the first and the last
        # window (the windows are independent rows of the step)
        ends = torch.tensor([0, W - 1], device=dev)
        pts3_c = tree_map(lambda a: a[:, ends].cpu(), pts3)
        want_seg, seg_ms = _time_host(lambda: flat(msm._scan_step(pts3_c, -8, K2, skey3[ends].cpu())))
        want_fold, fold_ms = _time_host(lambda: flat(msm._scan_step(to(fold, "cpu"), F // 2, F)))
        seg_adds = int((skey3[:, 8:] == skey3[:, :-8]).sum())
        seg_lanes, fold_lanes = W * K2, W * F
        if _words_differ(torch, flat(msm._scan_step(fold, F // 2, F)), want_fold):
            fail(f"kernel {group}_scan_step[{curve}] disagrees with the plain fold step")
        fold_kernel_ms = _time_cuda(torch, lambda: msm._scan_step(fold, F // 2, F))
        say(
            f"[3 check] {group}_scan_step[{curve}] fold step over {fold_lanes} lanes equals the plain CPU step: "
            f"kernel={fold_kernel_ms:.4f} ms plain(cpu)={fold_ms:.1f} ms"
        )
        record(
            f"{group}_scan_step[{curve}]",
            lambda: flat(msm._scan_step(pts3, -8, K2, skey3)),
            want_seg,
            seg_ms,
            "cpu",
            seg_lanes,
            bound_of(seg_lanes * (8 + 6 * row), seg_adds * (12 + b3_products) * imads),
            20,
            plain_lanes=2 * K2,
            cut=lambda outs: [a[:, ends] for a in outs],
        )

        # --- the window Horner: B6, one result over the curve's windows
        ws = tree_map(lambda a: a[..., :1].contiguous(), pts3)
        want_h, h_ms = _time_host(lambda: flat(msm._horner(to(ws, "cpu"))))
        record(
            f"{group}_horner[{curve}]",
            lambda: flat(msm._horner(ws)),
            want_h,
            h_ms,
            "cpu",
            1,
            bound_of((W + 1) * 3 * row, (W - 1) * (c + 1) * (12 + b3_products) * imads),
            5,
        )
    return results


# ---------------------------------------------------------------- phase 4
def phase_msm(torch, dev, curve, sizes=(1024, 256), small=160):
    """MSMs against host sums: per group one at c = 16 on the strip path
    (`sizes` points) and one of `small` points at its own window size on the
    log-scan path (the segmented scan and the bucket weighting)."""
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.encoding import (
        g1_from_device_proj,
        g1_to_device,
        g2_from_device_proj,
        g2_to_device,
        g4_from_device_proj,
        g4_to_device,
    )
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import MSM, auto_c

    cfg = get_curve(curve)
    host, R = cfg.host, cfg.host.R
    rng = random.Random(SEED)
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    g1, g2 = curve_ops(curve)

    def dec2(out, fp):
        return g2_from_device_proj(out, fp, host.Fp2, cfg.fp2_q)

    def dec4(out, fp):
        return g4_from_device_proj(out, fp, host.Fp4, host.Fp2)

    # a G2 over Fp (the BW6 curves) has plain int points: the G1 encoders
    if cfg.g2_over_fp:
        g2_codec = (g1_to_device, g1_from_device_proj)
    else:
        g2_codec = (g4_to_device, dec4) if cfg.g2_fp4 else (g2_to_device, dec2)
    for label, G, ops, size, enc, dec in (
        ("G1", host.G1, g1, sizes[0], g1_to_device, g1_from_device_proj),
        ("G2", host.G2, g2, sizes[1], *g2_codec),
    ):
        for n, msm, path in (
            (size, MSM(ops, fr, c=16, strip_threshold=128), "c=16 strip path"),
            (small, MSM(ops, fr, c=auto_c(small)), f"c={auto_c(small)} log-scan path"),
        ):
            # points i*g with known discrete logs, plus an infinity, duplicates
            # and a negation; zero scalars included
            g = G.generator()
            logs, pts, P = [], [], None
            for i in range(1, n - 3):
                P = G.add(P, g)
                logs.append(i)
                pts.append(P)
            logs += [0, logs[0], logs[0], (-logs[1]) % R]
            pts += [None, pts[0], pts[0], G.neg(pts[1])]
            scs = [rng.randrange(R) for _ in range(n - 4)] + [7, 0, 5, 1]
            scs[3] = 0
            want = G.mul(g, sum(s * d for s, d in zip(scs, logs)) % R)
            t0 = time.perf_counter()
            out = msm(enc(pts, fp, device=dev), fr.encode(scs, mont=False, device=dev))
            got = dec(out, fp)[0]
            dt = time.perf_counter() - t0
            if got != want:
                fail(f"MSM {curve} {label} N={n} {path} disagrees with the host sum")
            say(f"[4 msm] {curve} {label} N={n} {path} matches the host sum ({dt:.2f} s)")


# ---------------------------------------------------------------- phase 5
def mul_chain(log2n: int, p: int):
    """bench.py's Groth16 circuit over the field of p: x^n + x + 5 == y,
    n = 2^log2n - 8."""
    from tpusnark_torch.frontend.builder import Builder

    n = (1 << log2n) - 8
    b = Builder(p)
    x = b.secret("x")
    y = b.public("y")
    acc = x
    for _ in range(n - 1):
        acc = b.mul(acc, x)
    b.assert_is_equal(b.add(acc, x, 5), y)
    cs = b.compile()
    return cs, {"x": 3, "y": (pow(3, n, p) + 3 + 5) % p}


def wide_circuit(log2n: int, p: int, chains: int | None = None, commit: bool = False, builder=None):
    """A circuit the device solver takes (tpusnark's prefer_device rule
    holds at 2^14 and up): `chains` (WIDE_CHAINS) independent product chains over seeded
    64-bit secrets, s_i times s_(i+1) a step, as deep as fits in 2^log2n
    constraints (more than half of them). One step of every chain is a
    division (an inverse, its unknown in R, then a product) and one an
    inverse; a to_binary of s_0 adds a hint to the first level; the chain
    ends are summed into the one public output (`chains` terms of one
    constraint). With `commit`, a BSB22 commitment to the first four chains
    at their midpoint, whose challenge multiplies each of them in a later
    constraint. `builder`: the Builder class (the port's by default).
    Returns (cs, assignment)."""
    if builder is None:
        from tpusnark_torch.frontend.builder import Builder as builder
    chains = chains or WIDE_CHAINS
    extra = 66 + (4 if commit else 0)  # to_binary (64 bits + recomposition), output, commitment
    depth = ((1 << log2n) - extra - chains) // chains
    d_div, d_inv, d_com = depth // 3, 2 * depth // 3, depth // 2
    rng = random.Random(SEED + log2n)
    secrets = [rng.randrange(1, 1 << 64) for _ in range(chains)]
    b = builder(p)
    s = [b.secret(f"s{i}") for i in range(chains)]
    b.to_binary(s[0], 64)
    acc, val = list(s), list(secrets)
    for d in range(depth):
        for i in range(chains):
            if d == d_div:
                acc[i], val[i] = b.div(s[i], acc[i]), secrets[i] * pow(val[i], -1, p) % p
            elif d == d_inv:
                acc[i], val[i] = b.inverse(acc[i]), pow(val[i], -1, p)
            else:
                j = (i + 1) % chains
                acc[i], val[i] = b.mul(acc[i], s[j]), val[i] * secrets[j] % p
        if commit and d == d_com:
            c = b.commit(*acc[:4])
            for i in range(4):
                b.mul(c, acc[i])
    b.assert_is_equal(b.add(*acc), b.public("y"))
    cs = b.compile()
    assert (1 << (log2n - 1)) < len(cs.constraints) <= 1 << log2n, len(cs.constraints)
    return cs, {"y": sum(val) % p, **{f"s{i}": v for i, v in enumerate(secrets)}}


def verifier_names(curve):
    return ("verify", "bls381.verify") if curve == "bls12-381" else ("verify",)


class Fp4Ints(tuple):
    """The four Fp components of a host Fp4 element, as a worker process
    receives them: the tower's classes are made at run time
    (curves/tower.py make_ext) and do not pickle."""


def portable(v):
    """Host points, keys and proofs with every Fp4 element as Fp4Ints."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{f.name: portable(getattr(v, f.name)) for f in dataclasses.fields(v) if f.init})
    if isinstance(v, (list, tuple)):
        return type(v)(portable(x) for x in v)
    if hasattr(v, "c") and hasattr(v, "DEG"):  # a tower element
        return Fp4Ints(f.v for f2 in v.c for f in f2.c)
    return v


def restored(v, host):
    """portable(v) back, with host's Fp4 and Fp2 classes."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{f.name: restored(getattr(v, f.name), host) for f in dataclasses.fields(v) if f.init})
    if isinstance(v, Fp4Ints):
        return host.Fp4((host.Fp2(v[:2]), host.Fp2(v[2:])))
    if isinstance(v, (list, tuple)):
        return type(v)(restored(x, host) for x in v)
    return v


def verdict(curve, name, proof, vk, pubs):
    """(accepted?, seconds) of the port's host verifier `name` for `curve`.
    Top level, so that a worker process can run it; proof and vk as
    portable() made them."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from tpusnark_torch.curves.config import get_curve

    host = get_curve(curve).host
    proof, vk = restored(proof, host), restored(vk, host)
    t0 = time.perf_counter()
    if name == "verify":
        from tpusnark_torch.backend.groth16 import verify

        ok = verify(proof, vk, pubs, curve=curve)
    else:
        from tpusnark_torch.backend.groth16 import bls381 as B

        vkb = B.VerifyingKeyBLS(
            alpha_g1=vk.alpha_g1,
            beta_g1=vk.beta_g1,
            beta_g2=vk.beta_g2,
            gamma_g2=vk.gamma_g2,
            delta_g1=vk.delta_g1,
            delta_g2=vk.delta_g2,
            k=vk.k,
        )
        ok = B.verify(B.ProofBLS(ar=proof.ar, bs=proof.bs, krs=proof.krs), vkb, pubs)
    return bool(ok), time.perf_counter() - t0


def start_workers():
    """The verifier processes (spawned: the parent holds a CUDA context): one
    a verdict, leaving two cores to the main process's plain checks and the
    card's host work."""
    global _POOL
    if _POOL is None:
        verdicts = sum(2 * len(verifier_names(c)) for c in CURVES)
        _POOL = multiprocessing.get_context("spawn").Pool(max(1, min(verdicts, (os.cpu_count() or 4) - 2)))
    return _POOL


def submit_verdicts(pool, curve, proof, vk, good, wrong):
    """Ask the workers for the verdicts on the proof with the right and a
    wrong public input: [(verifier, expected verdict, pending result)]."""
    proof, vk = portable(proof), portable(vk)
    return [
        (name, expect, pool.apply_async(verdict, (curve, name, proof, vk, pubs)))
        for name in verifier_names(curve)
        for pubs, expect in ((good, True), (wrong, False))
    ]


def collect_verdicts(curve, log2n, pending):
    """Wait for the verdicts of one curve; fail unless the proof was
    accepted and the wrong public input rejected by every verifier."""
    times = []
    for name, expect, res in pending:
        ok, dt = res.get()
        times.append(f"{name}({'good' if expect else 'wrong'} input)={dt:.3f}s")
        if expect and not ok:
            fail(f"{name} rejected the port's {curve} 2^{log2n} proof")
        if ok and not expect:
            fail(f"{name} accepted the {curve} proof with a wrong public input")
    names = ", ".join(dict.fromkeys(name for name, _, _ in pending))
    say(f"[5 verify] {curve}: proof accepted ({names}), wrong public input rejected | " + " ".join(times))


def phase_groth16(torch, dev, curve, pool, cs, assign, compile_s):
    """Setup and one prove of the circuit `cs` (compiled in `compile_s`
    seconds) on `dev`; the verdicts are asked of the worker `pool` and
    returned pending."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import prove, setup

    times = {"compile": compile_s}
    rng = random.Random(SEED)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    # setup and prove return host points, so each has finished on the card
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, cs.modulus), device=dev, curve=curve)
    times["setup"] = time.perf_counter() - t0
    setup_launches = dict(kernels.LAUNCHES)
    prng = random.Random(SEED + 1)
    phases: dict = {}
    kernels.reset_launches()  # the main path: one prove
    t0 = time.perf_counter()
    proof = prove(
        cs, pk, assign, rng=lambda: prng.randrange(cs.modulus), timings=phases, device=dev
    )
    times["prove"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    times.update(phases)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    wrong = [(assign["y"] + 1) % cs.modulus]
    pending = submit_verdicts(pool, curve, proof, vk, [assign["y"]], wrong)
    proved = Proved(cs, pk, vk, assign, proof, SEED + 1)
    say(
        f"[5 groth16] {curve}: {len(cs.constraints)} constraints, {cs.n_wires} wires, domain "
        f"2^{pk.domain_n.bit_length() - 1}: proved | "
        + " ".join(f"{k}={v:.3f}s" for k, v in times.items())
        + f" | peak device memory {peak:.3f} GB"
    )
    return setup_launches, launches, pending, proved


def check_launches(curve, setup_only, off_path, setup_launches, launches):
    """Every instance of the curve's path ran in its run: the prove path's
    in the prove, the setup-only ones in the setup and not in the prove."""
    from tpusnark_torch import kernels
    from tpusnark_torch.fields.tfield import n_words
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.poly.ntt import max_stages, pass_plan

    names = [k for k in kernels.instances(curve) if k not in off_path]
    stray = [k for k in kernels.instances(curve) if k in off_path and launches[k] + setup_launches[k] > 0]
    if stray:
        fail(f"{curve}: kernels listed as off the path were launched: {stray}")
    idle = [k for k in names if k not in setup_only and launches[k] <= 0]
    if idle:
        fail(f"{curve}: kernels of the prove path never launched by the prove: {idle}")
    stale = [k for k in names if k in setup_only and launches[k] > 0]
    if stale:
        fail(f"{curve}: kernels listed as setup-only were launched by the prove: {stale}")
    idle = [k for k in names if k in setup_only and setup_launches[k] <= 0]
    if idle:
        fail(f"{curve}: setup-only kernels never launched by the setup: {idle}")
    other = [k for k in kernels.LAUNCHES if k not in names and launches[k] + setup_launches[k] > 0]
    if other:
        fail(f"{curve}: kernels of another curve ran in its path: {other}")
    strips = [launches[f"{g}_strip_mixed[{curve}]"] for g in ("g1", "g2")]
    horners = [launches[f"{g}_horner[{curve}]"] for g in ("g1", "g2")]
    if sum(strips) != MSMS_PER_PROVE or sum(horners) != MSMS_PER_PROVE:
        fail(f"{curve}: {MSMS_PER_PROVE} MSMs took {strips} strip passes over the bases and {horners} Horner launches")
    b6 = sum(launches[f"{g}_{op}[{curve}]"] for g in ("g1", "g2") for op in ("add", "strip", "scan_step", "horner"))
    if b6 > MAX_B6_LAUNCHES:
        fail(f"{curve}: {b6} launches of the B6 family in one prove, more than {MAX_B6_LAUNCHES}")
    fr_spec = get_curve(curve).fr_spec
    passes = len(pass_plan(LOG2_CONSTRAINTS, max_stages(n_words(fr_spec))))
    ntt_launches = launches[f"ntt_stages[{fr_spec.name}]"]
    if ntt_launches != NTTS_PER_PROVE * passes:
        fail(f"{curve}: {ntt_launches} NTT pass launches in one prove, not {NTTS_PER_PROVE} x {passes}")
    b1, b2 = launches[f"mul[{fr_spec.name}]"], launches[f"from_mont[{fr_spec.name}]"]
    if (b1, b2) != (B1_PER_PROVE, B2_PER_PROVE):
        fail(f"{curve}: B1 over fr launched {b1} times and B2 {b2} in one prove, not {B1_PER_PROVE} and {B2_PER_PROVE}")
    say(
        f"[6 launches] {curve} prove: B5 family {sum(strips)}, B6 family {b6}, NTT passes {ntt_launches}, "
        f"B1 {b1}, B2 {b2}"
    )
    say(f"[6 launches] {curve} prove: " + " ".join(f"{k}={launches[k]}" for k in names if k not in setup_only))
    say(f"[6 launches] {curve} setup: " + " ".join(f"{k}={setup_launches[k]}" for k in names))
    say(f"[6 launches] {curve} setup only (not in the prove): " + " ".join(k for k in names if k in setup_only))
    if any(k in off_path for k in kernels.instances(curve)):
        say(
            f"[6 launches] {curve} off the 2^17 path (held against the plain version only): "
            + " ".join(k for k in kernels.instances(curve) if k in off_path)
        )


# ---------------------------------------------------------------- phase 7
def pointwise_stage_loop(torch, ntt, x):
    """The forward transform as it ran before the pass kernel, kept to time
    against it: the bit-reverse gather, then the stages in pairs through the
    pointwise B4 kernel and an odd last one through B3, each launch on flat
    operands copied out of the row and twiddle rows tiled across the groups,
    its outputs stacked back into the row."""
    from tpusnark_torch import kernels

    n, L, k, table = ntt.n, ntt.field.n, ntt.k, ntt._tw_fwd
    x = x.index_select(-1, ntt._bitrev)

    def flat(a):
        return a.reshape(L, -1).contiguous()

    def tile(w, groups, half):
        return w.reshape(L, 1, half).expand(L, groups, half).reshape(L, -1).contiguous()

    s = 0
    while s + 1 < k:
        half = 1 << s
        groups = n // (4 * half)
        v = x.reshape(L, groups, 4, half)
        w1, w2 = table[:, half - 1 : 2 * half - 1], table[:, 2 * half - 1 : 4 * half - 1]
        outs = kernels.butterfly4(
            ntt.spec,
            *(flat(v[:, :, i]) for i in range(4)),
            tile(w1, groups, half),
            tile(w2[:, :half], groups, half),
            tile(w2[:, half:], groups, half),
        )
        x = torch.stack([o.view(L, groups, half) for o in outs], dim=2).reshape(L, n)
        s += 2
    if s < k:
        half = 1 << s
        v = x.reshape(L, 1, 2, half)
        a, b = kernels.butterfly(ntt.spec, flat(v[:, :, 0]), flat(v[:, :, 1]), tile(table[:, half - 1 :], 1, half))
        x = torch.stack([a.view(L, 1, half), b.view(L, 1, half)], dim=2).reshape(L, n)
    return x


def ntt_host_check(log2n, x_words, y_words, spots=None):
    """(lanes that disagree, seconds) of the host reference for phase 7's
    transform of x_words (Montgomery words) into y_words: at every lane
    against Domain.ntt_ref, or with `spots` at those outputs against Python
    Horner evaluations (y_words then holds just them). Top level, so that a
    worker process runs it beside the card's work."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.fields.tfield import words_to_ints
    from tpusnark_torch.poly.domain import Domain

    t0 = time.perf_counter()
    spec = get_curve("bn254").fr_spec
    p, dom = spec.modulus, Domain(spec, 1 << log2n)
    xs, got = words_to_ints(spec, x_words), words_to_ints(spec, y_words)
    if spots is None:
        n_bad = sum(a != b for a, b in zip(dom.ntt_ref(xs), got))
    else:
        n_bad = 0
        for pos, v in zip(spots, got):
            wk, acc = pow(dom.generator, pos, p), 0
            for c in reversed(xs):
                acc = (acc * wk + c) % p
            n_bad += acc != v
    return n_bad, time.perf_counter() - t0


def phase_ntt_large(torch, dev, np_rng, pool):
    """BN254 fr: the NTT at 2^20 against Domain.ntt_ref, at 2^22 the round
    trip and four outputs against Python Horner evaluations; at both sizes
    one transform timed through the pass kernel and through the pointwise
    stage loop it replaced, beside the transform's bound. The host
    references run in the workers (ntt_host_check): returns their pending
    results for collect_ntt_checks."""
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.poly.ntt import NTT

    spec = get_curve("bn254").fr_spec
    rng = random.Random(SEED + 7)
    pending = []
    for log2n in LARGE_NTT_LOG2:
        n = 1 << log2n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ntt = NTT(spec, n, dev)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        fr = ntt.field
        words = fr.n
        x_host = _lazy_words(np_rng, n, fr.modulus, words)
        x = torch.from_numpy(x_host).to(dev)
        y = ntt.ntt(x)
        if log2n < max(LARGE_NTT_LOG2):
            job = (log2n, x_host, y.cpu().numpy())
            what = "equals Domain.ntt_ref"
        else:
            n_bad, _ = _compare(torch, fr, ntt.intt(y), x.cpu())
            if n_bad:
                fail(f"the 2^{log2n} NTT over bn254 fr does not invert on {n_bad} lanes")
            spots = sorted(rng.randrange(n) for _ in range(4))
            job = (log2n, x_host, y[:, spots].cpu().numpy(), spots)
            what = f"round trip, and outputs {spots} equal Python Horner evaluations"
        pending.append((f"bn254 fr 2^{log2n}: {what}", pool.apply_async(ntt_host_check, job)))
        old = pointwise_stage_loop(torch, ntt, x)
        n_bad, _ = _compare(torch, fr, old, y.cpu())
        if n_bad:
            fail(f"the pointwise stage loop at 2^{log2n} disagrees with the pass kernel on {n_bad} lanes")
        new_ms = _time_cuda(torch, lambda: ntt.ntt(x), 10)
        old_ms = _time_cuda(torch, lambda: pointwise_stage_loop(torch, ntt, x), 5)
        bound = ntt_bound(words, n)
        say(
            f"[7 ntt] bn254 fr 2^{log2n}: tables built on the card in {build_ms:.1f} ms; one ntt: {len(ntt.plan)} "
            f"passes {ntt.plan} {new_ms:.4f} ms, the pointwise stage loop {old_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}); its host reference in a worker"
        )
        del ntt, x, y, old
        torch.cuda.empty_cache()
    return pending


def collect_ntt_checks(pending):
    """Fail unless every host reference of phase 7 agreed with the card."""
    for what, res in pending:
        n_bad, host_s = res.get()
        if n_bad:
            fail(f"the NTT disagrees with its host reference on {n_bad} lanes ({what})")
        say(f"[7 ntt] {what} (host, in a worker, {host_s:.1f} s)")


# ---------------------------------------------------------------- phase 8
# the field kernels the device solver launches, over the curve's r
SOLVER_OPS = ("mul", "from_mont", "add", "sub")


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def solver_launches(curve, launches):
    """{op: launches over the curve's fr} of SOLVER_OPS."""
    from tpusnark_torch.curves.config import get_curve

    fr = get_curve(curve).fr_spec.name
    return {op: launches.get(f"{op}[{fr}]", 0) for op in SOLVER_OPS}


def _fmt(counts):
    return " ".join(f"{k}={v}" for k, v in counts.items())


def check_prove_path(dev, curve, launches, setup_only, off_path, what):
    """On the card, every kernel instance of the curve's prove path ran in
    `launches` (the counts read 0 on the CPU)."""
    from tpusnark_torch import kernels

    idle = [k for k in kernels.instances(curve) if k not in setup_only | off_path and launches[k] <= 0]
    if dev.type == "cuda" and idle:
        fail(f"kernels of the prove path never launched by {what}: {idle}")


def phase_wide_solve(torch, dev, curve):
    """The device solver against the host solver on the wide circuit at
    2^WIDE_SOLVE_LOG2 constraints over the curve's r, wire for wire
    (decoded), with both times; returns the launches of a warm device solve
    (counts zeroed just before it, read just after)."""
    from tpusnark_torch import kernels
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import get_level_solver, prefer_device
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.fields.tfield import get_field

    cfg = get_curve(curve)
    cs, assign = wide_circuit(WIDE_SOLVE_LOG2, cfg.host.R)
    if not prefer_device(cs):
        fail(f"{curve}: the shape rule keeps the wide circuit on the host")
    t0 = time.perf_counter()
    want = solve(cs, assign)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls = get_level_solver(cs, cfg.fr_spec, dev)
    build_s = time.perf_counter() - t0
    times = []
    for _ in range(2):  # the first solve builds the bulk check's evaluator
        kernels.reset_launches()
        t0 = time.perf_counter()
        W, _ = ls.solve_with_abc(assign)
        _sync(torch, dev)
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    got = get_field(cfg.fr_spec).decode(W)
    n_bad = sum(a != b for a, b in zip(got, want))
    if n_bad or len(got) != len(want):
        fail(f"{curve}: the device solver differs from the host solver on {n_bad} of {len(want)} wires")
    counts = solver_launches(curve, launches)
    if dev.type == "cuda" and not (counts["mul"] and counts["from_mont"]):
        fail(f"{curve}: the device solve launched no B1 or no B2 over fr: {counts}")
    n_levels = len(cs.compute_levels())
    say(
        f"[8 solve] {curve}: wide circuit, {len(cs.constraints)} constraints in {n_levels} levels: the device "
        f"solver's W equals the host solver's on all {len(want)} wires | host {host_s:.4f} s, device: solver "
        f"built {build_s:.4f} s, first solve {times[0]:.4f} s, warm {times[1]:.4f} s | warm solve's launches "
        f"over fr: {_fmt(counts)}"
    )
    return launches


def commit_circuit(p):
    """tests/test_commit.py's circuit: y == x^3 + c*x + 5 + pub with c =
    Commit(x, pub), a BSB22 challenge."""
    from tpusnark_torch.frontend.builder import Builder

    b = Builder(p)
    x = b.secret("x")
    pub = b.public("pub")
    c = b.commit(x, pub)
    b.assert_is_equal(b.add(b.mul(x, x, x), b.mul(c, x), 5, pub), b.public("y"))
    return b.compile()


def _proof_image(proof):
    return (proof.ar, proof.bs, proof.krs, proof.commitments, proof.commitment_pok)


def phase_wide_prove(torch, dev, pool, setup_only, off_path):
    """BN254, the wide circuit with a BSB22 commitment at 2^LOG2_CONSTRAINTS:
    seeded setup; the device solve (the prove's solve phase, alone) against
    the host solver; a prove through the default device branch and one with
    accelerator="host" under the same rng, equal point for point; then
    tests/test_commit.py's circuit. Returns the launches of the device solve
    and of the device-branch prove, and the pending verdicts."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.backend.groth16.prove import bsb22_prover_state
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import solve_any
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.marshal import g1_raw
    from tpusnark_torch.curves.pedersen import pedersen_commit
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.utils.hash_to_field import COMMITMENT_DST, hash_to_field

    curve, cfg = "bn254", get_curve("bn254")
    p, fr = cfg.host.R, get_field(cfg.fr_spec)
    times = {}
    t0 = time.perf_counter()
    cs, assign = wide_circuit(LOG2_CONSTRAINTS, p, commit=True)
    times["compile"] = time.perf_counter() - t0
    rng = random.Random(SEED + 2)
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, p), device=dev, curve=curve)
    times["setup"] = time.perf_counter() - t0
    # the solve phase alone, with the prover's BSB22 override
    overrides, _, _ = bsb22_prover_state(cs, pk)
    t0 = time.perf_counter()
    want = solve(cs, assign, hint_overrides=overrides)
    times["host_solve"] = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    w, _, ints = solve_any(cs, assign, cfg.fr_spec, hint_overrides=overrides, device=dev)
    _sync(torch, dev)
    times["device_solve_first"] = time.perf_counter() - t0
    solve_launches = dict(kernels.LAUNCHES)
    if ints is not None:
        fail("the wide circuit took the host solver")
    n_bad = sum(a != b for a, b in zip(fr.decode(w), want))
    if n_bad:
        fail(f"the device solver differs from the host solver on {n_bad} wires of the 2^{LOG2_CONSTRAINTS} wide circuit")
    proofs, phases, launches = {}, {}, {}
    for branch, config in (("device", None), ("host", ProverConfig().with_accelerator("host"))):
        prng = random.Random(SEED + 3)
        phases[branch] = {}
        kernels.reset_launches()  # the path: one prove
        t0 = time.perf_counter()
        proofs[branch] = prove(
            cs, pk, assign, rng=lambda: prng.randrange(p), config=config, timings=phases[branch], device=dev
        )
        phases[branch]["prove"] = time.perf_counter() - t0
        launches[branch] = dict(kernels.LAUNCHES)
    if _proof_image(proofs["device"]) != _proof_image(proofs["host"]):
        fail("the device and host branches gave different proofs of the wide circuit")
    proof = proofs["device"]
    wide = Proved(cs, pk, vk, assign, proof, SEED + 3)
    if len(proof.commitments) != 1 or proof.commitments[0] is None or proof.commitment_pok is None:
        fail("the wide circuit's proof carries no commitment")
    # the branches the shape rule gives: the host branch's prove launches B1
    # and B2 over fr as the chain's does, the device branch's solve many more
    fr_name = cfg.fr_spec.name
    host_b = (launches["host"][f"mul[{fr_name}]"], launches["host"][f"from_mont[{fr_name}]"])
    dev_b = (launches["device"][f"mul[{fr_name}]"], launches["device"][f"from_mont[{fr_name}]"])
    if dev.type == "cuda" and (host_b != (B1_PER_PROVE, B2_PER_PROVE) or dev_b[0] <= B1_PER_PROVE):
        fail(f"wide prove: B1/B2 over fr {dev_b} on the device branch, {host_b} on the host branch")
    check_prove_path(dev, curve, launches["device"], setup_only, off_path, "the wide device-branch prove")
    pending = submit_verdicts(pool, curve, proof, vk, [assign["y"]], [(assign["y"] + 1) % p])
    say(
        f"[8 wide] bn254: wide circuit with a BSB22 commitment, {len(cs.constraints)} constraints, {cs.n_wires} "
        f"wires, {len(cs.compute_levels())} levels: the device solver's W equals the host solver's; the device and "
        f"host branches' proofs are equal point for point, commitment and PoK included | "
        + " ".join(f"{k}={v:.4f}s" for k, v in times.items())
    )
    for branch in ("device", "host"):
        say(f"[8 wide] bn254 {branch} branch: " + " ".join(f"{k}={v:.4f}s" for k, v in phases[branch].items()))
    say(f"[8 wide] bn254 device solve's launches over fr: {_fmt(solver_launches(curve, solve_launches))}")
    say(
        f"[8 wide] bn254 prove launches over fr: device branch {_fmt(solver_launches(curve, launches['device']))}; "
        f"host branch {_fmt(solver_launches(curve, launches['host']))}"
    )
    # tests/test_commit.py's circuit on the card
    cs, x, pub = commit_circuit(p), 3, 11
    rng = random.Random(SEED + 4)
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, p), device=dev, curve=curve)
    C = pedersen_commit(pk.commitment_keys[0], [x])
    (c,) = hash_to_field(g1_raw(C) + pub.to_bytes(32, "big"), COMMITMENT_DST, p)
    y = (x**3 + c * x + 5 + pub) % p
    prng = random.Random(SEED + 5)
    proof = prove(cs, pk, {"x": x, "pub": pub, "y": y}, rng=lambda: prng.randrange(p), device=dev)
    if proof.commitments != [C]:
        fail("the commit circuit's proof carries another commitment than the prover's")
    pending += submit_verdicts(pool, curve, proof, vk, [pub, y], [pub, (y + 1) % p])
    say(f"[8 commit] bn254: tests/test_commit.py's circuit proved on {dev.type}")
    return solve_launches, launches["device"], pending, wide


# ---------------------------------------------------------------- phase 9
# PLONK over BN254 on bench.py's PLONK circuit: a mul/add chain of
# 2^PLONK_LOG2 - 16 steps, 2^PLONK_LOG2 - 13 gates, a 2^PLONK_LOG2 domain
PLONK_LOG2 = 17
PLONK_PROVES = 3  # one cold, two warm
# NTT calls (each one launch of the pass kernel a pass of its plan) in one
# PLONK prove without commitments: over n the three wire INTTs (one batched
# call), the z INTT, the public-input INTT and the four coset slices (one
# batched NTT each); over 4n the coset INTT of the quotient. Setup: the five
# selector and three permutation INTTs over n. A BSB22 commitment adds one
# INTT over n to the prove (its committed polynomial) and one to setup (its
# qcp column).
PLONK_NTT_CALLS = {"prove": {1: 7, 4: 1}, "setup": {1: 8}}
# the MSMs of one PLONK prove: l, r, o (k = 3), z, h1-h3 (k = 3), the
# linearized polynomial and the two opening quotients (k = 2); of setup, the
# eight trace commitments
PLONK_MSMS = {"prove": 5, "setup": 8}
# the instances a PLONK prove launches over BN254 (B1, B2, add, sub over fr;
# the NTT pass kernel; the strip passes, scan steps, Horner and the
# pointwise add of the MSMs), and those setup launches (B1 and B2 over fr,
# the NTT and the MSMs; the unsafe SRS's fixed-base multiplication, B5
# pointwise, and its affine normalisation, B1 and B2 over fp)
_PLONK_MSM_OPS = tuple(f"g1_{op}[bn254]" for op in ("strip_mixed", "strip", "scan_step", "horner", "add"))
PLONK_OPS = {
    "prove": ("mul[{fr}]", "from_mont[{fr}]", "add[{fr}]", "sub[{fr}]", "ntt_stages[{fr}]") + _PLONK_MSM_OPS,
    "setup": ("mul[{fr}]", "from_mont[{fr}]", "ntt_stages[{fr}]", "g1_add_mixed[bn254]", "mul[{fp}]", "from_mont[{fp}]")
    + _PLONK_MSM_OPS,
}


def plonk_chain(log2n: int, p: int, builder=None):
    """bench.py's PLONK circuit over the field of p: a chain alternating
    acc * x and acc + x for 2^log2n - 16 steps (so that gate CSE cannot
    collapse it), equal to the public y. `builder`: the PlonkBuilder class
    (the port's by default)."""
    if builder is None:
        from tpusnark_torch.frontend.plonk_builder import PlonkBuilder as builder

    n = (1 << log2n) - 16
    b = builder(p)
    x = b.secret("x")
    y = b.public("y")
    acc = x
    for i in range(n):
        acc = b.mul(acc, x) if i % 2 == 0 else b.add(acc, x)
    b.assert_is_equal(acc, y)
    xv = av = 3
    for i in range(n):
        av = av * xv % p if i % 2 == 0 else (av + xv) % p
    return b.compile(), {"x": xv, "y": av}


def plonk_commit_circuit(p):
    """tests/test_plonk_commit.py's circuit: x^2 == y, c = Commit(x),
    x != c, (x - c)^2 == x^2 - 2cx + c^2."""
    from tpusnark_torch.frontend.plonk_builder import PlonkBuilder

    b = PlonkBuilder(p)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.mul(x, x), y)
    c = b.commit(x)
    b.assert_is_different(x, c)
    d = b.mul(b.sub(x, c), b.sub(x, c))
    b.assert_is_equal(d, b.add(b.mul(x, x), b.mul(b._scale(c, p - 2), x), b.mul(c, c)))
    return b.compile()


def plonk_verdict(proof, vk, pubs):
    """(accepted?, seconds) of the port's PLONK verifier; top level, so that
    a worker process can run it."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from tpusnark_torch.backend import plonk

    t0 = time.perf_counter()
    ok = plonk.verify(proof, vk, pubs)
    return bool(ok), time.perf_counter() - t0


def submit_plonk_verdicts(pool, proof, vk, good, wrong):
    return [
        ("plonk.verify", expect, pool.apply_async(plonk_verdict, (proof, vk, pubs)))
        for pubs, expect in ((good, True), (wrong, False))
    ]


def plonk_launches_expected(n: int, n_com: int, run: str) -> int:
    """The NTT pass kernel's launches in one PLONK prove or setup over a
    domain of n, fixed by PLONK_NTT_CALLS and the pass plans."""
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.fields.tfield import n_words
    from tpusnark_torch.poly.ntt import max_stages, pass_plan

    cap = max_stages(n_words(BN254_FR))
    calls = dict(PLONK_NTT_CALLS[run])
    calls[1] += n_com
    return sum(c * len(pass_plan((m * n).bit_length() - 1, cap)) for m, c in calls.items())


def check_plonk_launches(run: str, launches: dict, n: int, n_com: int) -> None:
    """Every instance of the PLONK path ran (setup: with its own), the NTT
    pass kernel exactly as often as its calls fix, one strip pass over the
    bases and one Horner an MSM, and no pointwise butterfly."""
    from tpusnark_torch import kernels
    from tpusnark_torch.fields.spec import BN254_FP, BN254_FR

    names = {"fr": BN254_FR.name, "fp": BN254_FP.name}
    want = [k.format(**names) for k in PLONK_OPS[run]]
    idle = [k for k in want if launches[k] <= 0]
    if idle:
        fail(f"PLONK {run}: kernels of its path never launched: {idle}")
    fr = names["fr"]
    stray = [k for k in (f"butterfly[{fr}]", f"butterfly4[{fr}]") if launches[k]]
    if stray:
        fail(f"PLONK {run}: the pointwise butterflies ran: {stray}")
    other = [k for k, v in launches.items() if v and k not in kernels.instances("bn254")]
    if other:
        fail(f"PLONK {run}: kernels of another curve ran: {other}")
    ntt = launches[f"ntt_stages[{fr}]"]
    if ntt != plonk_launches_expected(n, n_com, run):
        fail(f"PLONK {run}: {ntt} NTT pass launches, not {plonk_launches_expected(n, n_com, run)}")
    msms = PLONK_MSMS[run] + n_com
    strips, horners = launches["g1_strip_mixed[bn254]"], launches["g1_horner[bn254]"]
    if (strips, horners) != (msms, msms):
        fail(f"PLONK {run}: {msms} MSMs took {strips} strip passes over the bases and {horners} Horners")


def check_composite_commits(torch, dev, srs, tau: int, n: int) -> None:
    """commit_many_dev at the prove's shapes (k = 3 and k = 2 polynomials of
    n + 2 coefficients: c = 13, the strip path, 20 windows) against k
    separate commit_dev calls (c = 16) and against the host sum, which the
    SRS's discrete logs make one scalar multiplication: sum_i s_i tau^i G;
    and k = 3 over 1,024 points (the log-scan path) against the host sum."""
    from tpusnark_torch.curves.ref import G1, R
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import auto_c, auto_c_many
    from tpusnark_torch.poly import kzg

    fr = get_field(BN254_FR)
    rng = random.Random(SEED + 20)
    for k, m, separately in ((3, n + 2, True), (2, n + 2, True), (3, min(1024, n + 2), False)):
        scalars = [[rng.randrange(R) for _ in range(m)] for _ in range(k)]
        scalars[0][:3] = [0, 1, R - 1]  # a zero digit run, the smallest and the largest scalar
        stack = fr.encode([s for row in scalars for s in row], mont=False, device=dev).view(fr.n, k, m)
        t0 = time.perf_counter()
        many = kzg.commit_many_dev(srs, stack)
        many_s = time.perf_counter() - t0
        taus = [1] * m
        for i in range(1, m):
            taus[i] = taus[i - 1] * tau % R
        host = [G1.mul(G1.generator(), sum(s * t for s, t in zip(row, taus)) % R) for row in scalars]
        if many != host:
            fail(f"commit_many_dev (k={k}, {m} points, c={auto_c_many(m, k)}) disagrees with the host sum")
        line = f"k={k} over {m} points at c={auto_c_many(m, k)} equals the host sum ({many_s:.4f} s)"
        if separately:
            t0 = time.perf_counter()
            single = [kzg.commit_dev(srs, stack[:, i]) for i in range(k)]
            single_s = time.perf_counter() - t0
            if single != many:
                fail(f"commit_many_dev (k={k}, {m} points) disagrees with {k} commit_dev calls")
            line += f" and {k} commit_dev calls at c={auto_c(m)} ({single_s:.4f} s)"
        say(f"[9 kzg] commit_many_dev {line}")


def phase_plonk(torch, dev, pool):
    """PLONK over BN254 at a 2^PLONK_LOG2 domain: an unsafe SRS from a seeded
    tau made on the card, setup, one cold and two warm proves with phase
    times, the launches of setup and of the last warm prove; the composite
    commits; tests/test_plonk_commit.py's circuit proved on the card.
    Returns (setup launches, prove launches, pending verdicts)."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend import plonk
    from tpusnark_torch.backend.plonk.setup import _next_pow2
    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.poly import kzg

    times = {}
    t0 = time.perf_counter()
    cs, assign = plonk_chain(PLONK_LOG2, R)
    times["compile"] = time.perf_counter() - t0
    n = _next_pow2(max(8, cs.n_gates))
    if n != 1 << PLONK_LOG2:
        fail(f"the PLONK circuit has {cs.n_gates} gates: a domain of {n}, not 2^{PLONK_LOG2}")
    tau = random.Random(SEED + 10).randrange(2, R)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # setup's path: the SRS and setup
    t0 = time.perf_counter()
    srs = kzg.new_srs_unsafe(n + 3, tau=tau, device=dev)
    times["srs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk, vk = plonk.setup(cs, srs=srs, device=dev)
    times["setup"] = time.perf_counter() - t0
    setup_launches = dict(kernels.LAUNCHES)
    if pk.domain_n != 1 << PLONK_LOG2:
        fail(f"PLONK setup chose a domain of {pk.domain_n}")
    if on_card:
        check_plonk_launches("setup", setup_launches, n, 0)
    proves = []
    for i in range(PLONK_PROVES):
        prng = random.Random(SEED + 11 + i)
        phases: dict = {}
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proof = plonk.prove(cs, pk, assign, rng=lambda: prng.randrange(1, R), timings=phases)
        phases["prove"] = time.perf_counter() - t0
        proves.append(phases)
    launches = dict(kernels.LAUNCHES)
    if on_card:
        check_plonk_launches("prove", launches, n, 0)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    pending = submit_plonk_verdicts(pool, proof, vk, [assign["y"]], [(assign["y"] + 1) % R])
    chain = Proved(cs, pk, vk, assign, proof, SEED + 11 + PLONK_PROVES - 1)
    say(
        f"[9 plonk] bn254: {cs.n_gates} gates, {cs.n_wires} wires, domain 2^{PLONK_LOG2}: set up and proved | "
        + " ".join(f"{k}={v:.4f}s" for k, v in times.items())
        + f" | peak device memory {peak:.3f} GB"
    )
    for i, phases in enumerate(proves):
        label = "cold" if i == 0 else "warm"
        say(f"[9 plonk] prove {i + 1} ({label}): " + " ".join(f"{k}={v:.4f}s" for k, v in phases.items()))
    for run, counts in (("setup", setup_launches), ("warm prove", launches)):
        say(
            f"[9 launches] PLONK {run}: "
            + " ".join(f"{k}={v}" for k, v in counts.items() if v)
            + f" | all port launches {sum(counts.values())}"
        )
    check_composite_commits(torch, dev, srs, tau, n)
    # tests/test_plonk_commit.py's circuit on the card
    cs = plonk_commit_circuit(R)
    pk, vk = plonk.setup(cs, tau=SEED + 12, device=dev)
    prng = random.Random(SEED + 13)
    kernels.reset_launches()
    proof = plonk.prove(cs, pk, {"x": 3, "y": 9}, rng=lambda: prng.randrange(1, R))
    if len(proof.bsb22_commitments) != 1 or proof.bsb22_commitments[0] is None:
        fail("the PLONK commit circuit's proof carries no BSB22 commitment")
    ntt = kernels.LAUNCHES[f"ntt_stages[{BN254_FR.name}]"]
    if on_card and ntt != plonk_launches_expected(pk.domain_n, 1, "prove"):
        fail(f"PLONK commit prove: {ntt} NTT pass launches, not {plonk_launches_expected(pk.domain_n, 1, 'prove')}")
    pending += submit_plonk_verdicts(pool, proof, vk, [9], [10])
    say(f"[9 commit] bn254: tests/test_plonk_commit.py's circuit (domain {pk.domain_n}) proved on {dev.type}")
    return setup_launches, launches, pending, (chain, vk)


# ---------------------------------------------------------------- phase 10
# The MPC ceremony over BN254 (backend/groth16/mpcsetup.py): phase 1 at
# 2^CEREMONY_POWER powers of tau on the card (a), and the whole ceremony at
# 2^CEREMONY_E2E_POWER (b) on the wide circuit with CEREMONY_CHAINS chains:
# at most 2^9 constraints and more than 512 private wires, so that L's
# rescale also reaches the device threshold (Z's 511 points stay on the host)
CEREMONY_POWER = 17
CEREMONY_E2E_POWER = 9
CEREMONY_CHAINS = 96
CEREMONY_SPOT_LANES = 16
# one scalar bit: a doubling (B6) and a mixed add (B5) per list rescaled
CEREMONY_BITS = 254
# the rescaled lists of a phase-1 contribution: three in G1, one in G2
CEREMONY_G1_LISTS, CEREMONY_G2_LISTS = 3, 1


def ceremony_rng(seed, draws):
    """rng for contribute: each draw in [1, r) appended to `draws`."""
    from tpusnark_torch.curves.ref import R

    st = random.Random(seed)

    def rng():
        draws.append(st.randrange(1, R))
        return draws[-1]

    return rng


def ceremony_circuit(log2n: int, chains: int):
    """The circuit phase 2 binds: wide_circuit at 2^log2n constraints with
    `chains` chains over BN254's r."""
    from tpusnark_torch.curves.ref import R

    return wide_circuit(log2n, R, chains=chains)


def ceremony_job(kind, *args):
    """A ceremony step on the host, top level, so that a worker process can
    run it: ("verify_phase1" | "verify_phase2", prev, cur) -> (None or the
    error, seconds); ("init_phase2", phase1, log2n, chains) -> ((phase2,
    evals), seconds) on ceremony_circuit(log2n, chains)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from tpusnark_torch.backend.groth16 import mpcsetup

    t0 = time.perf_counter()
    if kind == "init_phase2":
        phase1, log2n, chains = args
        cs, _ = ceremony_circuit(log2n, chains)
        return mpcsetup.init_phase2(cs, phase1), time.perf_counter() - t0
    try:
        getattr(mpcsetup, kind)(*args)
        err = None
    except ValueError as e:
        err = str(e)
    return err, time.perf_counter() - t0


def _contribute(torch, dev, phase, rng, what):
    """One contribution on `dev`, timed and its peak memory printed; returns
    its launches, counted from zero."""
    from tpusnark_torch import kernels

    timings: dict = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the path: one contribution
    t0 = time.perf_counter()
    phase.contribute(rng, device=dev, timings=timings)
    _sync(torch, dev)
    timings["wall"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    timings["host other"] = timings["wall"] - sum(v for k, v in timings.items() if k != "wall")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    say(
        f"[10 ceremony] {what}: " + " ".join(f"{k}={v:.4f}s" for k, v in timings.items())
        + f" | peak device memory {peak:.3f} GB | launches "
        + " ".join(f"{k}={v}" for k, v in launches.items() if v)
    )
    return launches


def check_ceremony_launches(launches, g1_lists, g2_lists, what):
    """The ladders ran on the card: a B6 and a B5 launch a scalar bit a
    list, per group, and no other curve kernel."""
    want = {
        "g1_add[bn254]": g1_lists * CEREMONY_BITS,
        "g1_add_mixed[bn254]": g1_lists * CEREMONY_BITS,
        "g2_add[bn254]": g2_lists * CEREMONY_BITS,
        "g2_add_mixed[bn254]": g2_lists * CEREMONY_BITS,
    }
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{what}: curve kernel launches {got}, not {want}")
    stray = [k for k, v in launches.items() if v and "[bn254]" in k and k not in want]
    if stray:
        fail(f"{what}: other curve kernels launched: {stray}")


def check_fixed_base(torch, dev, group, points, scalars, what):
    """Every lane of the host points `points` equals [s_i]G of the group's
    generator, made on `dev` by FixedBaseMul: affine words equal."""
    from tpusnark_torch.backend.groth16.setup import to_affine
    from tpusnark_torch.curves.batch_mul import FixedBaseMul, g1_generator_ladder, g2_generator_ladder
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.encoding import g1_to_device, g2_to_device
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import tree_map

    cfg = get_curve("bn254")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    g1, g2 = curve_ops("bn254")
    if group == "g1":
        ops, ladder, enc = g1, g1_generator_ladder, g1_to_device
    else:
        ops, ladder, enc = g2, g2_generator_ladder, g2_to_device
    mul = FixedBaseMul(ops, fr)
    table = ladder(fp, mul.n_bits, "bn254", dev)
    X, Y, inf = to_affine(ops, mul(table, fr.encode(scalars, mont=False, device=dev)))
    want = [c for v in tree_map(fp.canon, (X, Y)) for c in ops.fa.components(v)]
    got = enc(points, fp, dev)
    bad = got[2] != inf
    for a, b in zip([c for v in got[:2] for c in ops.fa.components(v)], want):
        bad |= (a != b).any(dim=0) & ~inf
    n_bad = int(bad.sum())
    if n_bad:
        fail(f"{what}: {n_bad} of {len(points)} lanes differ from FixedBaseMul")


def check_phase1_lanes(torch, dev, phase1, tau, alpha, beta, what, seed):
    """Every lane of a phase-1 transcript grown from the generators by
    factors tau, alpha, beta against FixedBaseMul on `dev`; the first, last
    and CEREMONY_SPOT_LANES seeded lanes of each list against the host
    module; the hash."""
    from tpusnark_torch.backend.groth16.mpcsetup import _powers
    from tpusnark_torch.curves.ref import G1, G2, R

    n = phase1.n
    taus = _powers(tau, 2 * n - 1)
    lists = (
        ("tau_g1", "g1", phase1.tau_g1, taus),
        ("alpha_tau_g1", "g1", phase1.alpha_tau_g1, [alpha * t % R for t in taus[:n]]),
        ("beta_tau_g1", "g1", phase1.beta_tau_g1, [beta * t % R for t in taus[:n]]),
        ("tau_g2", "g2", phase1.tau_g2, taus[:n]),
    )
    t0 = time.perf_counter()
    for name, group, points, scalars in lists:
        check_fixed_base(torch, dev, group, points, scalars, f"{what} {name}")
    t_fixed = time.perf_counter() - t0
    spot = random.Random(seed)
    for name, group, points, scalars in lists:
        G = G1 if group == "g1" else G2
        lanes = [0, len(points) - 1] + [spot.randrange(len(points)) for _ in range(CEREMONY_SPOT_LANES)]
        for i in lanes:
            if points[i] != G.mul(G.generator(), scalars[i]):
                fail(f"{what} {name}[{i}] differs from the host module's scalar multiple")
    if phase1.beta_g2 != G2.mul(G2.generator(), beta):
        fail(f"{what} beta_g2 differs from the host module's")
    if phase1.compute_hash() != phase1.hash:
        fail(f"{what}: compute_hash() differs from the transcript's hash")
    say(
        f"[10 ceremony] {what}: every lane of the four lists ({2 * n - 1} + {n} + {n} G1, {n} G2) equals "
        f"FixedBaseMul on {dev.type} ({t_fixed:.2f} s), {2 + CEREMONY_SPOT_LANES} lanes a list and beta_g2 the host "
        "module's, compute_hash() the hash"
    )


def phase_ceremony_full(torch, dev, power=None):
    """(a) Phase 1 at 2^power powers of tau (CEREMONY_POWER): two seeded
    contributions on `dev`, each timed and counted, each transcript held lane
    for lane; then phase 2's rescale of Z at full width. Returns the
    launches of the second contribution."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import mpcsetup
    from tpusnark_torch.curves.ref import G1, R

    power = power or CEREMONY_POWER
    t0 = time.perf_counter()
    phase1 = mpcsetup.init_phase1(power)
    say(f"[10 ceremony] init_phase1({power}): {time.perf_counter() - t0:.4f} s")
    tau = alpha = beta = 1  # the products of the contributions' factors
    for i in (1, 2):
        draws = []
        rng = ceremony_rng(SEED + 20 + i, draws)
        launches = _contribute(torch, dev, phase1, rng, f"2^{power} phase-1 contribution {i}")
        if dev.type == "cuda":
            check_ceremony_launches(launches, CEREMONY_G1_LISTS, CEREMONY_G2_LISTS, f"2^{power} contribution {i}")
        tau, alpha, beta = tau * draws[0] % R, alpha * draws[1] % R, beta * draws[2] % R
        check_phase1_lanes(torch, dev, phase1, tau, alpha, beta, f"2^{power} after contribution {i}", SEED + 30 + i)
    # phase 2's rescale of Z (init_phase2's Z, one delta^-1) at full width
    n = phase1.n
    t0 = time.perf_counter()
    z = [G1.add(phase1.tau_g1[i + n], G1.neg(phase1.tau_g1[i])) for i in range(n - 1)]
    t_z = time.perf_counter() - t0
    delta_inv = pow(random.Random(SEED + 29).randrange(1, R), -1, R)
    timings: dict = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    scaled = mpcsetup._scale_g1(z, [delta_inv] * (n - 1), dev, timings)
    t_scale = time.perf_counter() - t0
    z_launches = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        check_ceremony_launches(z_launches, 1, 0, f"2^{power} Z rescale")
    taus = mpcsetup._powers(tau, 2 * n - 1)
    check_fixed_base(
        torch, dev, "g1", scaled, [(taus[i + n] - taus[i]) * delta_inv % R for i in range(n - 1)], f"2^{power} Z rescale"
    )
    say(
        f"[10 ceremony] 2^{power} Z rescale ({n - 1} points, built in {t_z:.2f} s): {t_scale:.4f} s ("
        + " ".join(f"{k}={v:.4f}s" for k, v in timings.items())
        + f"), every lane equals FixedBaseMul of (tau^(i+n) - tau^i) / delta | launches "
        + " ".join(f"{k}={v}" for k, v in z_launches.items() if v)
    )
    return launches


def phase_ceremony_start(torch, dev, pool, power=None):
    """(b), first half: init_phase1 at 2^power (CEREMONY_E2E_POWER) and two
    contributions on `dev`; the workers verify each link and a tampered one
    and run init_phase2 on the ceremony circuit. Returns the state."""
    from tpusnark_torch.backend.groth16 import mpcsetup

    power = power or CEREMONY_E2E_POWER
    chain = [mpcsetup.init_phase1(power)]
    for i in (1, 2):
        nxt = copy.deepcopy(chain[-1])
        launches = _contribute(torch, dev, nxt, ceremony_rng(SEED + 40 + i, []), f"2^{power} phase-1 contribution {i}")
        if dev.type == "cuda":
            check_ceremony_launches(launches, CEREMONY_G1_LISTS, CEREMONY_G2_LISTS, f"2^{power} contribution {i}")
        chain.append(nxt)
    bad = copy.deepcopy(chain[2])
    bad.tau_g1[2] = bad.tau_g1[1]
    bad.hash = bad.compute_hash()
    jobs = {"init_phase2": pool.apply_async(ceremony_job, ("init_phase2", chain[2], power, CEREMONY_CHAINS))}
    for i in (1, 2):
        jobs[f"phase-1 link {i}"] = pool.apply_async(ceremony_job, ("verify_phase1", chain[i - 1], chain[i]))
    jobs["tampered phase-1 link"] = pool.apply_async(ceremony_job, ("verify_phase1", chain[1], bad))
    say(f"[10 ceremony] 2^{power}: two phase-1 contributions on {dev.type}; init_phase2 and the verifiers in the workers")
    return {"power": power, "chains": CEREMONY_CHAINS, "phase1": chain[2], "jobs": jobs}


def phase_ceremony_finish(torch, dev, pool, state):
    """(b), second half: phase 2 from the workers' init_phase2, two
    contributions on `dev`, the links to the workers; extract_keys, a prove
    on `dev` (its verdicts to the workers); marshal round trips and the
    Solidity export. Returns the pending proof verdicts."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import export_solidity, marshal, mpcsetup, proof_to_solidity_calldata, prove
    from tpusnark_torch.curves.ref import R

    power, jobs = state["power"], state["jobs"]
    (phase2, evals), dt = jobs.pop("init_phase2").get()
    cs, assign = ceremony_circuit(power, state["chains"])
    n_private = cs.n_wires - cs.n_public
    say(
        f"[10 ceremony] 2^{power} init_phase2 (a worker): {dt:.2f} s on the ceremony circuit ({len(cs.constraints)} "
        f"constraints, {cs.n_wires} wires, {n_private} private: L {len(phase2.l_g1)} points, Z {len(phase2.z_g1)})"
    )
    if len(phase2.l_g1) < mpcsetup._DEVICE_THRESHOLD or len(cs.constraints) > 1 << power:
        fail(f"the ceremony circuit has {len(phase2.l_g1)} L points and {len(cs.constraints)} constraints")
    chain = [phase2]
    for i in (1, 2):
        nxt = copy.deepcopy(chain[-1])
        launches = _contribute(torch, dev, nxt, ceremony_rng(SEED + 50 + i, []), f"2^{power} phase-2 contribution {i}")
        if dev.type == "cuda":  # L on the card, Z (n - 1 < 512 points) on the host
            check_ceremony_launches(launches, 1, 0, f"2^{power} phase-2 contribution {i}")
        chain.append(nxt)
    for i in (1, 2):
        jobs[f"phase-2 link {i}"] = pool.apply_async(ceremony_job, ("verify_phase2", chain[i - 1], chain[i]))
    pk, vk = mpcsetup.extract_keys(cs, state["phase1"], chain[2], evals)
    prng = random.Random(SEED + 60)
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove(cs, pk, assign, rng=lambda: prng.randrange(R), device=dev)
    t_prove = time.perf_counter() - t0
    prove_launches = dict(kernels.LAUNCHES)
    pending = submit_verdicts(pool, "bn254", proof, vk, [assign["y"]], [(assign["y"] + 1) % R])
    # what ships the keys: gnark's byte layout and the Solidity verifier
    t0 = time.perf_counter()
    if marshal.proof_from_bytes(marshal.proof_to_bytes(proof)) != proof:
        fail("the ceremony proof does not survive marshal")
    if marshal.vk_from_bytes(marshal.vk_to_bytes(vk)) != vk:
        fail("the ceremony vk does not survive marshal")
    back = marshal.pk_from_bytes(marshal.pk_to_bytes(pk))
    fields = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z", "domain_n")
    if [getattr(back, f) for f in fields] != [getattr(pk, f) for f in fields]:
        fail("the ceremony pk does not survive marshal")
    t_marshal = time.perf_counter() - t0
    src = export_solidity(vk)
    words = proof_to_solidity_calldata(proof)
    consts = [f"ALPHA_X = {vk.alpha_g1[0]};", f"DELTA_X0 = {vk.delta_g2[0].c0};", f"K_Y_1 = {vk.k[1][1]};"]
    want = [proof.ar[0], proof.ar[1], proof.bs[0].c1, proof.bs[0].c0, proof.bs[1].c1, proof.bs[1].c0, proof.krs[0], proof.krs[1]]
    if any(c not in src for c in consts) or "uint256[1] calldata input" not in src or words != want:
        fail("export_solidity/proof_to_solidity_calldata do not hold the ceremony's vk and proof")
    say(
        f"[10 ceremony] 2^{power}: extract_keys, prove on {dev.type} {t_prove:.4f} s (launches "
        + " ".join(f"{k}={v}" for k, v in prove_launches.items() if v)
        + f"); proof, vk and pk survive marshal ({t_marshal:.2f} s); the Solidity verifier ({len(src)} bytes) holds "
        "the vk and the calldata the proof"
    )
    return pending


def collect_ceremony(state, pending):
    """Wait for the ceremony's links and proof verdicts: every link passes,
    the tampered one raises, the proof is accepted and a wrong input not."""
    for name, res in state["jobs"].items():
        err, dt = res.get()
        if (err is None) == name.startswith("tampered"):
            fail(f"ceremony {name}: {'passed' if err is None else err}")
        say(f"[10 verify] ceremony {name}: {'rejected: ' + err if err else 'verified'} ({dt:.2f} s)")
    collect_verdicts("bn254", f"{state['power']} ceremony", pending)


# ---------------------------------------------------------------- phase 11
# Sharding over a device list (tpusnark_torch/parallel/sharding.py,
# backend/groth16/sharded.py, backend/plonk/sharded.py): SHARDS shards of
# card 0, and (e) one shard a card where torch sees several. MSMs at
# 2^SHARD_LOG2 points in both groups, .many at k = SHARD_MANY_K, NTTs at
# each of SHARD_NTT_LOG2; the proves on the keys of phases 5, 8 and 9.
SHARDS = 4
SHARD_LOG2 = 17
SHARD_NTT_LOG2 = (17, 20)
SHARD_MANY_K = 3
SHARD_WARM = 2  # warm proves, sharded and unsharded in turns
# the instances over BN254 each sharded path must launch: the MSMs' strip,
# scan-step and Horner kernels and the tree's pointwise adds; the NTT's pass
# kernel and B1; the Groth16 prove all of them and B2, PLONK its G1 ones
_SHARD_MSM = tuple(f"{g}_{op}[bn254]" for g in ("g1", "g2") for op in ("strip_mixed", "strip", "scan_step", "horner", "add"))
SHARD_OPS = {
    "msm": _SHARD_MSM,
    "ntt": ("ntt_stages[bn254_fr]", "mul[bn254_fr]"),
    "groth16": ("ntt_stages[bn254_fr]", "mul[bn254_fr]", "from_mont[bn254_fr]") + _SHARD_MSM,
    "plonk": ("ntt_stages[bn254_fr]", "mul[bn254_fr]", "from_mont[bn254_fr]")
    + tuple(k for k in _SHARD_MSM if k.startswith("g1")),
}


def check_shard_launches(what: str, kind: str, launches: dict) -> None:
    """Every instance of the sharded path ran, and nothing over another
    curve."""
    from tpusnark_torch import kernels

    idle = [k for k in SHARD_OPS[kind] if launches[k] <= 0]
    if idle:
        fail(f"{what}: kernels of the sharded path never launched: {idle}")
    other = [k for k, v in launches.items() if v and k not in kernels.instances("bn254")]
    if other:
        fail(f"{what}: kernels of another curve ran: {other}")


def _wall(torch, devices, fn):
    """(fn(), seconds) with every device of the list synchronised."""
    for d in set(devices):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


def card_points(torch, dev, group: str, n: int, seed: int):
    """n points of BN254's G1 or G2 made on the card, as setup makes its keys
    (FixedBaseMul of seeded scalars, then to_affine); lanes 0 and 1 have the
    scalar 0, so they are infinity inputs."""
    from tpusnark_torch.backend.groth16.setup import to_affine
    from tpusnark_torch.curves.batch_mul import FixedBaseMul, g1_generator_ladder, g2_generator_ladder
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field

    cfg = get_curve("bn254")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    ops = curve_ops("bn254")[0 if group == "g1" else 1]
    mul = FixedBaseMul(ops, fr)
    ladder = (g1_generator_ladder if group == "g1" else g2_generator_ladder)(fp, mul.n_bits, "bn254", dev)
    rng = random.Random(seed)
    scalars = [0, 0] + [rng.randrange(1, fr.modulus) for _ in range(n - 2)]
    return to_affine(ops, mul(ladder, fr.encode(scalars, mont=False, device=dev)))


def card_scalars(fr, dev, shape, seed: int):
    """Seeded normal-form scalars (words, *shape): the first four 0, 0, 1
    and r - 1 (a zero digit run, the smallest and the largest scalar)."""
    rng = random.Random(seed)
    n = 1
    for d in shape:
        n *= d
    vals = [0, 0, 1, fr.modulus - 1] + [rng.randrange(fr.modulus) for _ in range(n - 4)]
    return fr.encode(vals, mont=False, device=dev).view(fr.n, *shape)


def phase_shard_msm(torch, devices, tag: str):
    """(a) ShardedMSM over BN254 at 2^SHARD_LOG2 points, G1 and G2, and its
    .many at k = SHARD_MANY_K: each equals the unsharded MSM point for
    point; warm times of both. Returns the launches of the sharded calls."""
    from tpusnark_torch import kernels
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.encoding import g1_from_device_proj, g2_from_device_proj
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import get_msm_for, get_msm_many_for
    from tpusnark_torch.parallel.sharding import ShardedMSM

    cfg = get_curve("bn254")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    d0, n, k = devices[0], 1 << SHARD_LOG2, SHARD_MANY_K
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for i, group in enumerate(("g1", "g2")):
        decode = (lambda pt: g1_from_device_proj(pt, fp)) if group == "g1" else (
            lambda pt: g2_from_device_proj(pt, fp, cfg.host.Fp2, cfg.fp2_q))
        pts = card_points(torch, d0, group, n, SEED + 30 + i)
        sc = card_scalars(fr, d0, (n,), SEED + 32 + i)
        sck = card_scalars(fr, d0, (k, n), SEED + 34 + i)
        smsm = ShardedMSM(get_msm_for(group, n // len(devices), "bn254"), devices)
        table = smsm.shard_points(pts)
        single, many = get_msm_for(group, n, "bn254"), get_msm_many_for(group, n, k, "bn254")
        kernels.reset_launches()  # the sharded path
        got, got_k = decode(smsm(table, sc)), decode(smsm.many(table, sck))
        for name, v in kernels.LAUNCHES.items():
            launches[name] += v
        if got != decode(single(pts, sc)):
            fail(f"[11 {tag}] ShardedMSM over bn254 {group} at 2^{SHARD_LOG2} differs from the MSM")
        if got_k != decode(many.many(pts, sck)):
            fail(f"[11 {tag}] ShardedMSM.many (k={k}) over bn254 {group} differs from MSM.many")
        times = {}
        for name, fn in (
            ("sharded", lambda: smsm(table, sc)),
            ("unsharded", lambda: single(pts, sc)),
            ("sharded", lambda: smsm(table, sc)),
            ("unsharded", lambda: single(pts, sc)),
            ("sharded many", lambda: smsm.many(table, sck)),
            ("unsharded many", lambda: many.many(pts, sck)),
        ):
            times.setdefault(name, []).append(_wall(torch, devices, fn)[1])
        say(
            f"[11 {tag} msm] bn254 {group} at 2^{SHARD_LOG2} over {len(devices)} shards "
            f"(c={smsm.msm.c} a shard, c={single.c} unsharded): equals the MSM point for point, and .many at k={k} "
            f"(c={many.c} unsharded) MSM.many | warm s: "
            + " ".join(f"{name} {','.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items())
        )
        del pts, table, sc, sck
    check_shard_launches(f"[11 {tag}] ShardedMSM", "msm", launches)
    return launches


def phase_shard_ntt(torch, devices, np_rng, tag: str):
    """(b) ShardedNTT over BN254 fr at each size of SHARD_NTT_LOG2: ntt,
    intt, ntt_coset and intt_coset equal the port's NTT on every lane mod p;
    one ntt of each timed. Returns the launches of the sharded transforms."""
    from tpusnark_torch import kernels
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.parallel.sharding import ShardedNTT
    from tpusnark_torch.poly.ntt import get_ntt

    names = ("ntt", "intt", "ntt_coset", "intt_coset")
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for log2n in SHARD_NTT_LOG2:
        n = 1 << log2n
        sntt, ntt = ShardedNTT(BN254_FR, n, devices), get_ntt(BN254_FR, n, devices[0])
        fr = ntt.field
        x = torch.from_numpy(_lazy_words(np_rng, n, fr.modulus, fr.n)).to(devices[0])
        kernels.reset_launches()  # the sharded path
        got = {name: getattr(sntt, name)(x) for name in names}
        for name, v in kernels.LAUNCHES.items():
            launches[name] += v
        bad = [name for name in names if not torch.equal(fr.canon(got[name]), fr.canon(getattr(ntt, name)(x)))]
        if bad:
            fail(f"[11 {tag}] ShardedNTT at 2^{log2n} differs from the NTT: {bad}")
        s_ms = _time_cuda(torch, lambda: sntt.ntt(x), 10)
        u_ms = _time_cuda(torch, lambda: ntt.ntt(x), 10)
        say(
            f"[11 {tag} ntt] bn254 fr 2^{log2n} over {len(devices)} shards (n1={sntt.n1}, n2={sntt.n2}): "
            f"ntt, intt, ntt_coset and intt_coset equal the NTT on every lane | one ntt: sharded {s_ms:.4f} ms, "
            f"unsharded {u_ms:.4f} ms"
        )
        del sntt, x, got
    check_shard_launches(f"[11 {tag}] ShardedNTT", "ntt", launches)
    return launches


def phase_shard_groth16(torch, devices, pool, cases, tag: str, warm: bool):
    """(c) prove_sharded on phase 5's chain and phase 8's wide circuit with
    their keys: under the proof's own seeded rng it equals the unsharded
    proof point for point, and the workers give its verdicts. With `warm`,
    the chain is proved SHARD_WARM more times each way, in turns, with
    phase times. Returns (launches of the last warm sharded prove, pending)."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import prove
    from tpusnark_torch.backend.groth16.sharded import prove_sharded

    pending, launches = [], None
    for label, case in cases:
        p = case.cs.modulus
        prng = random.Random(case.seed)
        phases = {}
        proof, cold = _wall(
            torch,
            devices,
            lambda: prove_sharded(
                case.cs, case.pk, case.assign, devices, rng=lambda: prng.randrange(p), timings=phases
            ),
        )
        if _proof_image(proof) != _proof_image(case.proof):
            fail(f"[11 {tag}] the sharded proof of the {label} differs from the unsharded one")
        y = case.assign["y"]
        pending += submit_verdicts(pool, "bn254", proof, case.vk, [y], [(y + 1) % p])
        say(
            f"[11 {tag} groth16] {label}: {len(case.cs.constraints)} constraints over {len(devices)} shards: equals "
            f"the unsharded proof point for point | first {cold:.4f} s: "
            + " ".join(f"{k}={v:.4f}s" for k, v in phases.items())
        )
        if not warm or label != "chain":
            continue
        provers = {
            "unsharded": lambda rng, ph: prove(
                case.cs, case.pk, case.assign, rng=rng, timings=ph, device=devices[0]
            ),
            "sharded": lambda rng, ph: prove_sharded(case.cs, case.pk, case.assign, devices, rng=rng, timings=ph),
        }
        rows = []
        for _ in range(SHARD_WARM):
            for name, run_prove in provers.items():
                prng = random.Random(case.seed)
                phases = {}
                kernels.reset_launches()  # the sharded path: one warm prove
                proof, t = _wall(torch, devices, lambda: run_prove(lambda: prng.randrange(p), phases))
                if name == "sharded":
                    launches = dict(kernels.LAUNCHES)
                if _proof_image(proof) != _proof_image(case.proof):
                    fail(f"[11 {tag}] a warm {name} proof of the chain differs")
                rows.append(f"{name} {t:.4f} s (" + " ".join(f"{k}={v:.4f}" for k, v in phases.items()) + ")")
        for row in rows:
            say(f"[11 {tag} warm] bn254 chain 2^{LOG2_CONSTRAINTS}: {row}")
        check_shard_launches(f"[11 {tag}] sharded Groth16 prove", "groth16", launches)
        say(f"[11 {tag} launches] sharded Groth16 prove: " + _fmt({k: v for k, v in launches.items() if v}))
    return launches, pending


def phase_shard_plonk(torch, devices, pool, case, commit_vk):
    """(d) PLONK's prove_sharded on phase 9's circuit with its keys: equal to
    its last warm proof field for field under the same rng, the workers'
    verdicts, a proof_to_bytes round trip, export_solidity and the 26-word
    calldata, and the export refusing phase 9's BSB22 key; warm sharded and
    unsharded proves in turns. Returns (launches of a sharded prove,
    pending)."""
    import dataclasses

    from tpusnark_torch import kernels
    from tpusnark_torch.backend import plonk
    from tpusnark_torch.backend.plonk.marshal import proof_from_bytes, proof_to_bytes
    from tpusnark_torch.backend.plonk.sharded import prove_sharded
    from tpusnark_torch.backend.plonk.solidity import export_solidity, proof_to_solidity_calldata
    from tpusnark_torch.curves.ref import R

    def same(a, b):
        return all(getattr(a, f.name) == getattr(b, f.name) for f in dataclasses.fields(b))

    provers = {
        "sharded": lambda rng, ph: prove_sharded(case.cs, case.pk, case.assign, devices, rng=rng, timings=ph),
        "unsharded": lambda rng, ph: plonk.prove(case.cs, case.pk, case.assign, rng=rng, timings=ph),
    }
    rows, launches = [], None
    for i in range(1 + SHARD_WARM):
        for name in ("sharded", "unsharded") if i else ("sharded",):
            prng = random.Random(case.seed)
            phases = {}
            kernels.reset_launches()  # the sharded path: one prove
            proof, t = _wall(torch, devices, lambda: provers[name](lambda: prng.randrange(1, R), phases))
            if name == "sharded":
                launches = dict(kernels.LAUNCHES)
            if not same(proof, case.proof):
                fail(f"[11 plonk] a {name} PLONK proof differs from phase 9's under the same rng")
            rows.append(f"{'first ' if not i else ''}{name} {t:.4f} s (" + " ".join(
                f"{k}={v:.4f}" for k, v in phases.items()) + ")")
    check_shard_launches("[11] sharded PLONK prove", "plonk", launches)
    pending = submit_plonk_verdicts(pool, proof, case.vk, [case.assign["y"]], [(case.assign["y"] + 1) % R])
    data = proof_to_bytes(proof)
    if not same(proof_from_bytes(data), proof):
        fail("[11 plonk] proof_from_bytes(proof_to_bytes(proof)) is not the proof")
    src, calldata = export_solidity(case.vk), proof_to_solidity_calldata(proof)
    if "contract PlonkVerifier" not in src or len(calldata) != 26:
        fail(f"[11 plonk] the Solidity export or its calldata ({len(calldata)} words) is malformed")
    try:
        export_solidity(commit_vk)
        fail("[11 plonk] export_solidity took the BSB22 key")
    except NotImplementedError:
        pass
    say(
        f"[11 plonk] bn254 2^{PLONK_LOG2} over {len(devices)} shards: equals the unsharded proof field for field; "
        f"{len(data)} proof bytes round-trip; Solidity export {len(src)} characters, calldata 26 words; the export "
        "refuses the BSB22 key"
    )
    for row in rows:
        say(f"[11 plonk warm] {row}")
    say("[11 launches] sharded PLONK prove: " + _fmt({k: v for k, v in launches.items() if v}))
    return launches, pending


def phase_shard(torch, card, pool, np_rng, chain, wide, plonk_case, plonk_commit_vk):
    """Phase 11: (a)-(d) over SHARDS shards of card 0; (e) (a)-(c) over one
    shard a card where torch sees several. Returns the launches of the
    sharded Groth16 and PLONK proves, and the pending verdicts."""
    devices = (torch.device("cuda", 0),) * SHARDS
    say(f"[11 shard] {SHARDS} shards of cuda:0 | {card}")
    phase_shard_msm(torch, devices, "one card")
    phase_shard_ntt(torch, devices, np_rng, "one card")
    g16_launches, pending = phase_shard_groth16(
        torch, devices, pool, (("chain", chain), ("wide circuit", wide)), "one card", warm=True
    )
    plonk_launches, more = phase_shard_plonk(torch, devices, pool, plonk_case, plonk_commit_vk)
    pending += more
    count = torch.cuda.device_count()
    if count > 1:
        cards = tuple(torch.device("cuda", i) for i in range(count))
        say(f"[11 multi-card] (e) one shard on each of {count} cards")
        phase_shard_msm(torch, cards, "multi-card")
        phase_shard_ntt(torch, cards, np_rng, "multi-card")
        pending += phase_shard_groth16(
            torch, cards, pool, (("chain", chain), ("wide circuit", wide)), "multi-card", warm=False
        )[1]
    else:
        say(
            "[11 multi-card] (e) did not run: torch sees 1 card, so the shards on distinct cards (peer copies, "
            "each launch with its tensor's card current, the NTT pass kernel's shared-memory attribute on each "
            "card) are not exercised"
        )
    return g16_launches, plonk_launches, pending


# ---------------------------------------------------------------- phase 12
# The port's examples (tpusnark_torch/examples) on the card: gnark's cubic,
# exponentiate and MiMC examples through Groth16, its PLONK example, and
# the SHA-256 gadget on one seeded 32-byte message; then the rollup at batch
# 31 over 32 accounts (depth 5): 1,034,160 constraints in a 2^20 domain,
# nothing cut.
SHA_BYTES = 32
SHA_LOG2 = 16
ROLLUP_BATCH = 31
ROLLUP_ACCOUNTS = 32
ROLLUP_LOG2 = 20
# the warm proves after the first, in turns: the default branch (the shape
# rule sends the rollup to the device solver) and the host solver; two,
# because with phase 15 the script runs near 80 % of its time limit
ROLLUP_TURNS = ("device", "host")


def _seeded(seed, lo=1):
    """A seeded draw in [lo, r) over BN254's r."""
    from tpusnark_torch.curves.ref import R

    rng = random.Random(seed)
    return lambda: rng.randrange(lo, R)


def _branch(cs) -> str:
    from tpusnark_torch.constraint.solver_torch import prefer_device

    return "device" if prefer_device(cs) else "host"


def sha256_circuit(n_bytes: int, seed: int):
    """The SHA-256 gadget over n_bytes secret bytes (each range-checked to 8
    bits), its digest equal to the public bytes d0..d31; the assignment of a
    seeded message with hashlib's digest, and that digest."""
    import hashlib

    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.frontend.builder import Builder
    from tpusnark_torch.gadgets.sha2 import sha256_of_bytes

    b = Builder(R)
    ins = [b.secret(f"m{i}") for i in range(n_bytes)]
    for v in ins:
        b.to_binary(v, 8)
    for i, d in enumerate(sha256_of_bytes(b, ins)):
        b.assert_is_equal(d, b.public(f"d{i}"))
    rng = random.Random(seed)
    msg = bytes(rng.randrange(256) for _ in range(n_bytes))
    digest = list(hashlib.sha256(msg).digest())
    assign = {f"m{i}": c for i, c in enumerate(msg)}
    assign.update({f"d{i}": c for i, c in enumerate(digest)})
    return b.compile(), assign, digest


def phase_examples(torch, dev, pool):
    """(a) The port's examples on `dev`: each main with a seeded rng (its
    own host verifier inside), the verdicts of the proof with its public
    inputs and with a wrong one asked of the workers; then the SHA-256
    circuit at 2^SHA_LOG2: seeded setup and prove, the proof's public digest
    hashlib's (a satisfied solve and an accepted proof say that the
    circuit's digest is hashlib's) and a wrong digest byte rejected. Prints
    the solver branch of each. Returns the pending verdicts."""
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.examples import cubic, exponentiate, mimc, plonk_example

    pending = []
    for i, mod in enumerate((cubic, exponentiate, mimc)):
        t0 = time.perf_counter()
        cs, _, vk, proof, pubs = mod.main(device=dev, rng=_seeded(SEED + 60 + i))
        dt = time.perf_counter() - t0
        pending += submit_verdicts(pool, "bn254", proof, vk, pubs, [(pubs[0] + 1) % R] + pubs[1:])
        say(
            f"[12 examples] {mod.__name__}: {len(cs.constraints)} constraints, Groth16 on {dev.type}, solver "
            f"branch {_branch(cs)}: main {dt:.3f} s"
        )
    t0 = time.perf_counter()
    cs, _, vk, proof, pubs = plonk_example.main(
        device=dev, tau=random.Random(SEED + 63).randrange(2, R), rng=_seeded(SEED + 64)
    )
    dt = time.perf_counter() - t0
    pending += submit_plonk_verdicts(pool, proof, vk, pubs, [(pubs[0] + 1) % R])
    say(f"[12 examples] {plonk_example.__name__}: {cs.n_gates} gates, PLONK on {dev.type} (SCS solved on the host): main {dt:.3f} s")
    times = {}
    t0 = time.perf_counter()
    cs, assign, digest = sha256_circuit(SHA_BYTES, SEED + 65)
    times["compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=_seeded(SEED + 66), device=dev)
    times["setup"] = time.perf_counter() - t0
    if pk.domain_n != 1 << SHA_LOG2:
        fail(f"the SHA-256 circuit has {len(cs.constraints)} constraints: a domain of {pk.domain_n}, not 2^{SHA_LOG2}")
    phases = {}
    t0 = time.perf_counter()
    proof = prove(cs, pk, assign, rng=_seeded(SEED + 67, 0), timings=phases, device=dev)
    times["prove"] = time.perf_counter() - t0
    wrong = [digest[0] ^ 1] + digest[1:]
    pending += submit_verdicts(pool, "bn254", proof, vk, digest, wrong)
    say(
        f"[12 sha256] {SHA_BYTES} seeded bytes: {len(cs.constraints)} constraints in {len(cs.compute_levels())} "
        f"levels, domain 2^{SHA_LOG2}, solver branch {_branch(cs)}: proved with the public digest "
        f"{bytes(digest).hex()} = hashlib.sha256 | " + " ".join(f"{k}={v:.4f}s" for k, v in {**times, **phases}.items())
    )
    return pending


def _peak(torch, dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else float("nan")


def phase_rollup(torch, dev, pool, setup_only, off_path):
    """(b) The rollup at ROLLUP_BATCH transfers over ROLLUP_ACCOUNTS
    accounts: compile, the operator's batch, a seeded setup with its phase
    times, the shape rule's verdict, a first prove and the warm proves of
    ROLLUP_TURNS, all under one seeded rng, so that every proof, on either
    branch, must be the same point for point; the device solver's witness
    against the host solver's, every wire; the peak memory after setup and
    after the proves. (c) The launches of the first warm default-branch
    prove (counts zeroed just before it, read just after), every kernel of
    the prove path among them. Returns them and the pending verdicts: each
    proof with the two public roots, and one with root_after + 1."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import (
        MIN_MEAN_LEVEL_WIDTH,
        MIN_TOTAL_INSTRUCTIONS,
        get_level_solver,
        prefer_device,
    )
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.examples import rollup
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.frontend.builder import Builder

    cfg = get_curve("bn254")
    p, fr = cfg.host.R, get_field(cfg.fr_spec)
    depth = ROLLUP_ACCOUNTS.bit_length() - 1
    t0 = time.perf_counter()
    b = Builder(p)
    rollup.define_batch(b, ROLLUP_BATCH, depth=depth)
    cs = b.compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = cs.stats()
    levels_s = time.perf_counter() - t0
    hint_levels = sum(any(cs.instructions[i][0] == "hint" for i in lv) for lv in cs.compute_levels())
    n = 1 << (len(cs.constraints) - 1).bit_length()
    if n != 1 << ROLLUP_LOG2:
        fail(f"the rollup has {len(cs.constraints)} constraints: a domain of {n}, not 2^{ROLLUP_LOG2}")
    n_hints = sum(1 for inst in cs.instructions if inst[0] == "hint")
    say(
        f"[12 rollup] batch {ROLLUP_BATCH} over {ROLLUP_ACCOUNTS} accounts (depth {depth}): compile {compile_s:.2f} s, "
        f"levels grouped in {levels_s:.2f} s | cs.stats() {stats} | {n_hints} hints in {hint_levels} levels | "
        f"domain 2^{ROLLUP_LOG2}"
    )
    t0 = time.perf_counter()
    _, transfers = rollup.make_batch(ROLLUP_BATCH, ROLLUP_ACCOUNTS)
    assign = rollup.batch_assignment(transfers)
    operator_s = time.perf_counter() - t0
    pubs = [transfers[0]["root_before"], transfers[-1]["root_after"]]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=_seeded(SEED + 70), device=dev, timings=setup_t)
    setup_s = time.perf_counter() - t0
    peak_setup = _peak(torch, dev)
    if pk.domain_n != n:
        fail(f"the rollup's setup chose a domain of {pk.domain_n}")
    say(
        f"[12 rollup] operator's batch {operator_s:.2f} s; seeded setup {setup_s:.2f} s: "
        + " ".join(f"{k}={v:.2f}s" for k, v in setup_t.items())
        + f" (on the card: fixed_base; the host: scalars, encode, to_host, keys) | peak device memory {peak_setup:.3f} GB"
    )
    on_device = prefer_device(cs)
    n_inst, n_levels = cs._torch_level_shape
    say(
        f"[12 rollup] prefer_device: {on_device} ({n_inst} instructions in {n_levels} levels, a mean width of "
        f"{n_inst / n_levels:.1f}; the rule: at least {MIN_TOTAL_INSTRUCTIONS} instructions and a mean width of "
        f"at least {MIN_MEAN_LEVEL_WIDTH})"
    )
    if not on_device:
        fail("the shape rule keeps the rollup on the host solver")
    proofs, warm_launches = [], None
    for i, branch in enumerate(("device",) + ROLLUP_TURNS):
        config = None if branch == "device" else ProverConfig().with_accelerator("host")
        prng = random.Random(SEED + 71)
        phases = {}
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proofs.append(prove(cs, pk, assign, rng=lambda: prng.randrange(p), config=config, timings=phases, device=dev))
        phases["prove"] = time.perf_counter() - t0
        if i and branch == "device" and warm_launches is None:
            warm_launches = dict(kernels.LAUNCHES)
        label = "first prove" if not i else f"warm prove {i}"
        say(f"[12 rollup] {label}, {branch} branch: " + " ".join(f"{k}={v:.4f}s" for k, v in phases.items()))
    peak_prove = _peak(torch, dev)
    if any(_proof_image(pf) != _proof_image(proofs[0]) for pf in proofs[1:]):
        fail("the rollup's proofs differ between proves under the same rng")
    pending = [("verify", True, pool.apply_async(verdict, ("bn254", "verify", proof, vk, pubs))) for proof in proofs]
    wrong = [pubs[0], (pubs[1] + 1) % p]
    pending.append(("verify", False, pool.apply_async(verdict, ("bn254", "verify", proofs[0], vk, wrong))))
    t0 = time.perf_counter()
    want = solve(cs, assign)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    W = get_level_solver(cs, cfg.fr_spec, dev).solve(assign)
    _sync(torch, dev)
    device_s = time.perf_counter() - t0
    got = fr.decode(W)
    n_bad = sum(a != b for a, b in zip(got, want))
    if n_bad or len(got) != len(want):
        fail(f"the rollup: the device solver differs from the host solver on {n_bad} of {len(want)} wires")
    check_prove_path(dev, "bn254", warm_launches, setup_only, off_path, "a warm rollup prove")
    say(
        f"[12 rollup] {len(proofs)} proofs equal point for point on both branches; the device solver's witness "
        f"equals the host solver's on all {len(want)} wires (host solve {host_s:.4f} s, device solve "
        f"{device_s:.4f} s) | peak device memory after the proves {peak_prove:.3f} GB | a warm default-branch "
        f"prove's launches over fr: {_fmt(solver_launches('bn254', warm_launches))}"
    )
    return warm_launches, pending


# ---------------------------------------------------------------- phase 13
# (a) the native 2-chain: BLS12-377 proofs verified inside a BW6-761 circuit
RECURSION_INNER = "bls12-377"
RECURSION_OUTER = "bw6-761"  # its r is BLS12-377's p
RECURSION_PROOFS = 2
RECURSION_LOG2 = 17
# (b) the commit-based range check over BN254
RANGE_VALUES = 1024
RANGE_BITS = 64
RANGE_LOG2 = 15

# the secret inputs of one inner proof in the outer circuit
_PROOF_INPUTS = ("ar_x", "ar_y", "bs_x0", "bs_x1", "bs_y0", "bs_y1", "krs_x", "krs_y")


def recursion_circuit(vk, n_proofs, builder=None, gadget=None):
    """The 2-chain's outer circuit over BLS12-377's p (BW6-761's r):
    `n_proofs` in-circuit Groth16 verifications
    (``gadgets/recursion_native.py``) of BLS12-377 proofs under the inner key
    `vk`, each with its proof's Ar, Bs and Krs coordinates as secret inputs
    (``ar_x<i>``, ...) and its one public input as the public ``y<i>``.
    `builder`, `gadget`: the Builder class and the recursion_native module
    (the port's by default)."""
    if builder is None:
        from tpusnark_torch.frontend.builder import Builder as builder
    if gadget is None:
        from tpusnark_torch.gadgets import recursion_native as gadget
    b = builder(gadget.P)
    vkc = gadget.NativeVkConst.from_vk(vk)
    for i in range(n_proofs):
        ins = {name: b.secret(f"{name}{i}") for name in _PROOF_INPUTS}
        ar = (ins["ar_x"], ins["ar_y"])
        bs = ((ins["bs_x0"], ins["bs_x1"]), (ins["bs_y0"], ins["bs_y1"]))
        krs = (ins["krs_x"], ins["krs_y"])
        gadget.NativeGroth16Verifier(b).assert_proof(vkc, ar, bs, krs, [b.public(f"y{i}")])
    return b.compile()


def recursion_assignment(proofs, ys):
    """The outer circuit's inputs for host BLS12-377 proofs and their
    public inputs."""
    assign = {}
    for i, (pf, y) in enumerate(zip(proofs, ys)):
        vals = (pf.ar[0], pf.ar[1], pf.bs[0].c0, pf.bs[0].c1, pf.bs[1].c0, pf.bs[1].c1, pf.krs[0], pf.krs[1])
        assign.update({f"{name}{i}": v for name, v in zip(_PROOF_INPUTS, vals)})
        assign[f"y{i}"] = y
    return assign


def rangecheck_circuit(n, bits, p, seed, builder=None, checker=None):
    """`n` secret values, each checked to `bits` bits by the commit-based
    range checker (``gadgets/rangecheck.py``: 8-bit limbs looked up in one
    log-derivative table that one BSB22 commitment closes), their sum equal
    to the public ``sum``. `builder`, `checker`: the Builder class and the
    rangecheck module (the port's by default). Returns (cs, the assignment
    of seeded values)."""
    if builder is None:
        from tpusnark_torch.frontend.builder import Builder as builder
    if checker is None:
        from tpusnark_torch.gadgets import rangecheck as checker
    b = builder(p)
    rc = checker.range_checker(b)
    xs = [b.secret(f"v{i}") for i in range(n)]
    for x in xs:
        rc.check(x, bits)
    b.assert_is_equal(b.add(*xs), b.public("sum"))
    rng = random.Random(seed)
    vals = [rng.randrange(1 << bits) for _ in range(n)]
    return b.compile(), {"sum": sum(vals) % p, **{f"v{i}": v for i, v in enumerate(vals)}}


def inner_proofs(dev, chain):
    """Phase 5's BLS12-377 chain proof and a second one of the same
    statement under the same key with another seeded rng: (vk, the two
    proofs, their public y). The proving key is not kept."""
    from tpusnark_torch.backend.groth16 import prove

    cs, pk, vk, assign, proof, seed = chain
    prng = random.Random(seed + 100)
    second = prove(cs, pk, assign, rng=lambda: prng.randrange(cs.modulus), device=dev)
    if _proof_image(second) == _proof_image(proof):
        fail("the two inner proofs are equal")
    return vk, [proof, second], assign["y"]


def _refused(solve, what, hint_checks=False):
    """Fail unless solve() raises an unsatisfied constraint or, with
    hint_checks, a hint's own check (the emulated field's quotient and carry
    hints assert that their identity holds)."""
    from tpusnark_torch.constraint.solver import UnsatisfiedConstraintError

    try:
        solve()
    except (UnsatisfiedConstraintError, AssertionError) as e:
        if isinstance(e, AssertionError) and not hint_checks:
            raise
        return f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:80]}"
    fail(f"{what}: the solver accepted it")


def _times(d):
    return " ".join(f"{k}={v:.4f}s" for k, v in d.items())


def phase_recursion(torch, dev, pool, inner, setup_only, off_path):
    """(a) The native 2-chain: the outer circuit over the two inner
    BLS12-377 proofs (`inner`, from inner_proofs), its 2^RECURSION_LOG2
    domain, a seeded BW6-761 setup, a prove on the default branch and one
    with accelerator="host" under the same rng, equal point for point (the
    launches of the second, warm, counted from zero); the device solver's
    witness against the host solver's, every wire; the host solver refusing
    inner proof 0's Ar off the curve and the two proofs' Ar swapped. Returns
    the warm prove's launches and the pending verdicts: (y, y) accepted,
    (y + 1, y) rejected."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import get_level_solver, prefer_device
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.fields.tfield import get_field

    vk_in, proofs, y = inner
    cfg = get_curve(RECURSION_OUTER)
    p, fr = cfg.host.R, get_field(cfg.fr_spec)
    if p != get_curve(RECURSION_INNER).host.P:
        fail("BW6-761's r is not BLS12-377's p")
    times = {}
    t0 = time.perf_counter()
    cs = recursion_circuit(vk_in, RECURSION_PROOFS)
    times["compile"] = time.perf_counter() - t0
    assign = recursion_assignment(proofs, [y] * RECURSION_PROOFS)
    t0 = time.perf_counter()
    on_device = prefer_device(cs)
    times["levels"] = time.perf_counter() - t0
    n_inst, n_levels = cs._torch_level_shape
    say(
        f"[13 recursion] outer circuit over {RECURSION_OUTER}'s r: {RECURSION_PROOFS} in-circuit verifications "
        f"of {RECURSION_INNER} proofs, {len(cs.constraints)} constraints, {cs.n_wires} wires, {n_levels} levels, "
        f"a mean width of {n_inst / n_levels:.1f}: solver branch {'device' if on_device else 'host'} | "
        + _times(times)
    )
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = random.Random(SEED + 80)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, p), device=dev, curve=RECURSION_OUTER, timings=setup_t)
    setup_t["setup"] = time.perf_counter() - t0
    if pk.domain_n != 1 << RECURSION_LOG2:
        fail(f"the outer circuit's domain is {pk.domain_n}, not 2^{RECURSION_LOG2}")
    say(f"[13 recursion] domain 2^{RECURSION_LOG2}; seeded setup: " + _times(setup_t) + f" | peak device memory {_peak(torch, dev):.3f} GB")
    proved, launches = {}, {}
    for branch, config in (("default", None), ("host", ProverConfig().with_accelerator("host"))):
        prng = random.Random(SEED + 81)
        phases = {}
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proved[branch] = prove(cs, pk, assign, rng=lambda: prng.randrange(p), config=config, timings=phases, device=dev)
        phases["prove"] = time.perf_counter() - t0
        launches[branch] = dict(kernels.LAUNCHES)
        say(f"[13 recursion] prove, {branch} branch: " + _times(phases))
    if _proof_image(proved["default"]) != _proof_image(proved["host"]):
        fail("the outer circuit's proofs differ between the default and the host branch")
    check_prove_path(dev, RECURSION_OUTER, launches["host"], setup_only, off_path, "a warm outer prove")
    ys = [y] * RECURSION_PROOFS
    pending = submit_verdicts(pool, RECURSION_OUTER, proved["default"], vk, ys, [(y + 1) % p] + ys[1:])
    t0 = time.perf_counter()
    want = solve(cs, assign)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls = get_level_solver(cs, cfg.fr_spec, dev)
    build_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    W = ls.solve(assign)
    _sync(torch, dev)
    device_s = time.perf_counter() - t0
    solve_launches = solver_launches(RECURSION_OUTER, kernels.LAUNCHES)
    got = fr.decode(W)
    n_bad = sum(a != b for a, b in zip(got, want))
    if n_bad or len(got) != len(want):
        fail(f"the outer circuit: the device solver differs from the host solver on {n_bad} of {len(want)} wires")
    say(
        f"[13 recursion] the device solver's witness equals the host solver's on all {len(want)} wires | host "
        f"solve {host_s:.4f} s, device: solver built {build_s:.4f} s, solve {device_s:.4f} s, its launches over "
        f"fr: {_fmt(solve_launches)} | peak device memory {_peak(torch, dev):.3f} GB"
    )
    off_curve = dict(assign, ar_y0=(assign["ar_y0"] + 1) % p)
    swapped = dict(assign)
    for k in ("ar_x", "ar_y"):
        swapped[f"{k}0"], swapped[f"{k}1"] = assign[f"{k}1"], assign[f"{k}0"]
    for what, bad in (("inner proof 0's Ar.y + 1", off_curve), ("the two proofs' Ar swapped", swapped)):
        t0 = time.perf_counter()
        why = _refused(lambda: solve(cs, bad), f"the outer circuit with {what}")
        say(f"[13 recursion] the host solver refuses {what}: {why} ({time.perf_counter() - t0:.4f} s)")
    say(f"[13 recursion] a warm outer prove's launches: {_fmt({k: v for k, v in launches['host'].items() if v})}")
    return launches["host"], pending


def phase_rangecheck(torch, dev, pool, setup_only, off_path):
    """(b) RANGE_VALUES values checked to RANGE_BITS bits by the
    commit-based range checker over BN254: compile, the shape rule's
    verdict (the device solver, else fail), seeded setup, one prove on the
    default branch (its launches counted from zero); the device solver's
    witness against the host's, every wire; a value of 2^RANGE_BITS refused
    by both solvers. Returns the prove's launches and the pending verdicts:
    the sum accepted, the sum + 1 rejected."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.backend.groth16.prove import bsb22_prover_state
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import get_level_solver, prefer_device
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.fields.tfield import get_field

    cfg = get_curve("bn254")
    p, fr = cfg.host.R, get_field(cfg.fr_spec)
    times = {}
    t0 = time.perf_counter()
    cs, assign = rangecheck_circuit(RANGE_VALUES, RANGE_BITS, p, SEED + 90)
    times["compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_device = prefer_device(cs)
    times["levels"] = time.perf_counter() - t0
    n_inst, n_levels = cs._torch_level_shape
    say(
        f"[13 rangecheck] {RANGE_VALUES} values checked to {RANGE_BITS} bits over bn254: {len(cs.constraints)} "
        f"constraints, {cs.n_wires} wires, {n_levels} levels, a mean width of {n_inst / n_levels:.1f}, "
        f"{len(cs.commitments)} BSB22 commitment: solver branch {'device' if on_device else 'host'} | "
        + _times(times)
    )
    if not on_device:
        fail("the shape rule keeps the range check on the host solver")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = random.Random(SEED + 91)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, p), device=dev, curve="bn254", timings=setup_t)
    setup_t["setup"] = time.perf_counter() - t0
    if pk.domain_n != 1 << RANGE_LOG2:
        fail(f"the range check's domain is {pk.domain_n}, not 2^{RANGE_LOG2}")
    say(f"[13 rangecheck] domain 2^{RANGE_LOG2}; seeded setup: " + _times(setup_t))
    prng = random.Random(SEED + 92)
    phases = {}
    kernels.reset_launches()  # the main path: one prove
    t0 = time.perf_counter()
    proof = prove(cs, pk, assign, rng=lambda: prng.randrange(p), timings=phases, device=dev)
    phases["prove"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("[13 rangecheck] prove, default branch: " + _times(phases) + f" | peak device memory {_peak(torch, dev):.3f} GB")
    if len(proof.commitments) != 1 or proof.commitment_pok is None:
        fail("the range check's proof carries no commitment")
    check_prove_path(dev, "bn254", launches, setup_only, off_path, "the range-check prove")
    pending = submit_verdicts(pool, "bn254", proof, vk, [assign["sum"]], [(assign["sum"] + 1) % p])
    overrides, _, _ = bsb22_prover_state(cs, pk)
    t0 = time.perf_counter()
    want = solve(cs, assign, hint_overrides=overrides)
    host_s = time.perf_counter() - t0
    ls = get_level_solver(cs, cfg.fr_spec, dev)
    t0 = time.perf_counter()
    W = ls.solve(assign, hint_overrides=overrides)
    _sync(torch, dev)
    device_s = time.perf_counter() - t0
    got = fr.decode(W)
    n_bad = sum(a != b for a, b in zip(got, want))
    if n_bad or len(got) != len(want):
        fail(f"the range check: the device solver differs from the host solver on {n_bad} of {len(want)} wires")
    say(
        f"[13 rangecheck] the device solver's witness equals the host solver's on all {len(want)} wires | host "
        f"solve {host_s:.4f} s, device solve {device_s:.4f} s"
    )
    big = 1 << RANGE_BITS
    bad = dict(assign, v0=big, sum=(assign["sum"] - assign["v0"] + big) % p)
    for name, solve_bad in (
        ("host", lambda: solve(cs, bad, hint_overrides=overrides)),
        ("device", lambda: ls.solve(bad, hint_overrides=overrides)),
    ):
        why = _refused(solve_bad, f"the range check with a value of 2^{RANGE_BITS}")
        say(f"[13 rangecheck] the {name} solver refuses a value of 2^{RANGE_BITS}: {why}")
    say(f"[13 rangecheck] the prove's launches: {_fmt({k: v for k, v in launches.items() if v})}")
    return launches, pending


# ---------------------------------------------------------------- phase 14
# A batch of EIP-196 ECADD calls (precompile 0x06, gnark's
# std/evmprecompiles/06-bnadd.go) over BN254's G1 in emulated Fp, each with
# its inputs checked on the curve and its output bound to public limbs, as
# a zkEVM prover proves a block's calls: 32 calls, 852,416 constraints in 17
# levels, a 2^20 domain, nothing cut.
ECADD_CALLS = 32
ECADD_LOG2 = 20
# the warm proves after the two that are compared (default, then host), in
# turns: the default branch (the shape rule sends the batch to the device
# solver) and the host solver
ECADD_TURNS = ("device", "host")
_ECADD_INPUTS = ("px", "py", "qx", "qy")


def ecadd_circuit(n_calls, builder=None, gadget=None):
    """`n_calls` ECADD calls (``gadgets/evmprecompiles.py``: ``ecadd`` on
    ``add_unified``) over emulated BN254 Fp inside BN254's r. Call k takes P
    and Q as 4 + 4 secret 64-bit limbs each (``px<k>_<i>``, ``py<k>_<i>``,
    ``qx<k>_<i>``, ``qy<k>_<i>``), checks both on the curve (EIP-196 fails on
    a point off it), and binds R's limbs to the public ``rx<k>_<i>``,
    ``ry<k>_<i>`` and its identity flag to the public ``rz<k>``. `builder`,
    `gadget`: the Builder class and the evmprecompiles module (the port's by
    default)."""
    if builder is None:
        from tpusnark_torch.frontend.builder import Builder as builder
    if gadget is None:
        from tpusnark_torch.gadgets import evmprecompiles as gadget
    b = builder(gadget.BN254_G1.order)
    C = gadget.bn_g1(b)
    F, k = C.F, C.F.pr.n_limbs
    for call in range(n_calls):
        ins = {c: [b.secret(f"{c}{call}_{i}") for i in range(k)] for c in _ECADD_INPUTS}
        P = C.from_limbs(ins["px"], ins["py"])
        Q = C.from_limbs(ins["qx"], ins["qy"])
        C.assert_on_curve(P)
        C.assert_on_curve(Q)
        R, rz = gadget.ecadd(b, C, P, Q)
        for name, v in (("rx", R.x), ("ry", R.y)):
            F.assert_is_equal(v, F.from_limbs([b.public(f"{name}{call}_{i}") for i in range(k)]))
        b.assert_is_equal(rz, b.public(f"rz{call}"))
    return b.compile()


def ecadd_inputs(n_calls, seed):
    """The calls' points from `seed`: call 1 doubles (Q = P), call 2
    annihilates (Q = -P: R = (0, 0), flag 1), every other adds two random
    multiples of the generator; R from ``curves/ref.py``'s G1.add. Returns
    (the assignment, the public inputs in the circuit's order)."""
    from tpusnark_torch.curves.ref import G1
    from tpusnark_torch.curves.ref import P as FP
    from tpusnark_torch.curves.ref import R as ORDER
    from tpusnark_torch.gadgets.emulated import EmuParams

    prm = EmuParams.for_modulus(FP)
    rng = random.Random(seed)
    assign, pubs = {}, []
    for call in range(n_calls):
        pt = G1.mul(G1.generator(), rng.randrange(1, ORDER))
        if call == 1:
            q = pt
        elif call == 2:
            q = G1.neg(pt)
        else:
            q = G1.mul(G1.generator(), rng.randrange(1, ORDER))
        r = G1.add(pt, q)
        for name, v in zip(_ECADD_INPUTS, (*pt, *q)):
            assign.update({f"{name}{call}_{i}": limb for i, limb in enumerate(prm.decompose(v))})
        for name, v in zip(("rx", "ry"), r or (0, 0)):
            for i, limb in enumerate(prm.decompose(v)):
                assign[f"{name}{call}_{i}"] = limb
                pubs.append(limb)
        assign[f"rz{call}"] = int(r is None)
        pubs.append(int(r is None))
    return assign, pubs


def ecadd_tampered(assign, n_calls, seed, p):
    """The assignments phase 14 must see refused, by name: Q.y + 1 on a
    seeded call that adds (Q off the curve), a claimed R.x + 1 on call 0,
    and flag 0 on the annihilating call 2."""
    call = random.Random(seed).choice([0, *range(3, n_calls)])
    return {
        f"call {call}'s Q.y + 1": dict(assign, **{f"qy{call}_0": (assign[f"qy{call}_0"] + 1) % p}),
        "call 0's claimed R.x + 1": dict(assign, rx0_0=(assign["rx0_0"] + 1) % p),
        "flag 0 on the annihilating call 2": dict(assign, rz2=0),
    }


def phase_ecadd(torch, dev, pool, setup_only, off_path):
    """ECADD_CALLS EIP-196 ECADD calls over BN254 (``ecadd_circuit``):
    compile, its shape (constraints, wires, levels, mean width, hint-bearing
    levels), the 2^ECADD_LOG2 domain, a seeded setup on `dev`; a prove on the
    default branch, which must take the device solver, and one with
    accelerator="host" under the same rng, then the warm proves of
    ECADD_TURNS, every proof equal point for point, each with its phase
    times; the launches of the warm default-branch prove (counts zeroed
    just before it, read just after), every kernel of the prove path among
    them; the device solve alone (with the time of its hint syncs) against
    the host solve, every wire; each of ecadd_tampered's assignments refused
    by both solvers; peak memory. The circuit, keys and solver are freed
    before returning. Returns the launches and the pending verdicts: the
    true public inputs accepted, call 0's first output limb + 1 rejected."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.constraint.solver_torch import get_level_solver, prefer_device
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.fields.tfield import get_field

    cfg = get_curve("bn254")
    p, fr = cfg.host.R, get_field(cfg.fr_spec)
    times = {}
    t0 = time.perf_counter()
    cs = ecadd_circuit(ECADD_CALLS)
    times["compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_device = prefer_device(cs)
    levels = cs.compute_levels()
    times["levels"] = time.perf_counter() - t0
    n_inst, n_levels = cs._torch_level_shape
    hint_levels = sum(any(cs.instructions[i][0] == "hint" for i in lv) for lv in levels)
    del levels
    n = 1 << (len(cs.constraints) - 1).bit_length()
    say(
        f"[14 ecadd] {ECADD_CALLS} ECADD calls over bn254: {len(cs.constraints)} constraints, {cs.n_wires} wires "
        f"({cs.n_public} public), {n_levels} levels, a mean width of {n_inst / n_levels:.1f}, {hint_levels} "
        f"hint-bearing levels, domain 2^{n.bit_length() - 1}: solver branch {'device' if on_device else 'host'} | "
        + _times(times)
    )
    if n != 1 << ECADD_LOG2:
        fail(f"the ECADD batch has {len(cs.constraints)} constraints: a domain of {n}, not 2^{ECADD_LOG2}")
    if not on_device:
        fail("the shape rule keeps the ECADD batch on the host solver")
    t0 = time.perf_counter()
    assign, pubs = ecadd_inputs(ECADD_CALLS, SEED + 100)
    inputs_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = random.Random(SEED + 101)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, p), device=dev, timings=setup_t)
    setup_t["setup"] = time.perf_counter() - t0
    if pk.domain_n != n:
        fail(f"the ECADD batch's setup chose a domain of {pk.domain_n}")
    say(
        f"[14 ecadd] inputs {inputs_s:.4f} s; seeded setup: " + _times(setup_t)
        + f" | peak device memory {_peak(torch, dev):.3f} GB"
    )
    solvers = cs.__dict__.setdefault("_torch_level_solvers", {})
    proofs, warm_launches = [], None
    for i, branch in enumerate(("device", "host") + ECADD_TURNS):
        config = None if branch == "device" else ProverConfig().with_accelerator("host")
        prng = random.Random(SEED + 102)
        phases = {}
        built = len(solvers)
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proofs.append(prove(cs, pk, assign, rng=lambda: prng.randrange(p), config=config, timings=phases, device=dev))
        phases["prove"] = time.perf_counter() - t0
        if i == 0 and len(solvers) == built:
            fail("the ECADD batch's default-branch prove did not build the device solver")
        if i >= 2 and branch == "device" and warm_launches is None:
            warm_launches = dict(kernels.LAUNCHES)
        label = f"warm prove {i - 1}" if i >= 2 else "prove"
        say(f"[14 ecadd] {label}, {'default (device solver)' if branch == 'device' else 'host'} branch: " + _times(phases))
    if warm_launches is None:
        fail("ECADD_TURNS holds no default-branch prove")
    peak_prove = _peak(torch, dev)
    if any(_proof_image(pf) != _proof_image(proofs[0]) for pf in proofs[1:]):
        fail("the ECADD batch's proofs differ between the default and the host branch")
    check_prove_path(dev, "bn254", warm_launches, setup_only, off_path, "a warm ECADD prove")
    wrong = [(pubs[0] + 1) % p] + pubs[1:]
    pending = submit_verdicts(pool, "bn254", proofs[0], vk, pubs, wrong)
    del proofs, pk
    t0 = time.perf_counter()
    want = solve(cs, assign)
    host_s = time.perf_counter() - t0
    ls = get_level_solver(cs, cfg.fr_spec, dev)
    run_hints, sync = ls._run_hints, {"s": 0.0, "levels": 0}

    def timed_hints(*args):  # one level's host sync, timed alone
        _sync(torch, dev)
        t = time.perf_counter()
        run_hints(*args)
        _sync(torch, dev)
        sync["s"] += time.perf_counter() - t
        sync["levels"] += 1

    ls._run_hints = timed_hints
    t0 = time.perf_counter()
    W = ls.solve(assign)
    _sync(torch, dev)
    device_s = time.perf_counter() - t0
    ls._run_hints = run_hints
    got = fr.decode(W)
    del W
    n_bad = sum(a != b for a, b in zip(got, want))
    if n_bad or len(got) != len(want):
        fail(f"the ECADD batch: the device solver differs from the host solver on {n_bad} of {len(want)} wires")
    say(
        f"[14 ecadd] the device solver's witness equals the host solver's on all {len(want)} wires | host solve "
        f"{host_s:.4f} s, device solve {device_s:.4f} s, of which {sync['s']:.4f} s in the hint syncs of "
        f"{sync['levels']} levels | peak device memory after the proves {peak_prove:.3f} GB"
    )
    del got, want
    for what, bad in ecadd_tampered(assign, ECADD_CALLS, SEED + 103, p).items():
        for name, solve_bad in (("host", lambda: solve(cs, bad)), ("device", lambda: ls.solve(bad))):
            t0 = time.perf_counter()
            why = _refused(solve_bad, f"the ECADD batch with {what} on the {name} solver", hint_checks=True)
            say(f"[14 ecadd] the {name} solver refuses {what}: {why} ({time.perf_counter() - t0:.4f} s)")
    del ls, cs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say(f"[14 ecadd] a warm default-branch prove's launches: {_fmt({k: v for k, v in warm_launches.items() if v})}")
    return warm_launches, pending


# ---------------------------------------------------------------- phase 15
# PlonkFRI over BN254 (backend/plonkfri, poly/fri.py): bench.py's PLONK
# chain at a 2^PLONKFRI_LOG2 domain with default FriParams (blowup 8, 27
# queries, stop degree 8: an LDE domain of 2^17), and one at
# 2^PLONKFRI_CHECK_LOG2 proved on the card and on the CPU
PLONKFRI_LOG2 = 14
PLONKFRI_CHECK_LOG2 = 10
# NTT calls (each one launch of the pass kernel a pass of its plan) in one
# PlonkFRI prove, by size (n: the domain, "N": the LDE domain of blowup *
# n): over n the wire INTT (l, r, o batched), the NTT of the fixed s1, s2,
# s3, the z INTT and the PI INTT; over N the LDEs of l, r, o (batched), of
# z, of PI and of h1, h2, h3 (batched) and the quotient's coset INTT.
# Setup: one batched INTT over n and one batched LDE.
PLONKFRI_NTT_CALLS = {"prove": {"n": 4, "N": 5}, "setup": {"n": 1, "N": 1}}
# the instances a PlonkFRI prove launches over BN254 fr: B1, B2, add, sub
# and the NTT pass kernel (no MSM)
PLONKFRI_OPS = ("mul", "from_mont", "add", "sub", "ntt_stages")
# GKR inside Groth16 (gadgets/gkr_compile.py on protocols/gkr.py):
# tests/test_gkr_compile.py's DAG over GKR_INSTANCES batched instances,
# 91,886 constraints, a 2^17 domain
GKR_INSTANCES = 8
GKR_LOG2 = 17


def plonkfri_launches_expected(n: int, blowup: int, run: str) -> int:
    """The NTT pass kernel's launches in one PlonkFRI prove or setup over a
    domain of n, fixed by PLONKFRI_NTT_CALLS and the pass plans."""
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.fields.tfield import n_words
    from tpusnark_torch.poly.ntt import max_stages, pass_plan

    cap = max_stages(n_words(BN254_FR))
    size = {"n": n, "N": blowup * n}
    return sum(c * len(pass_plan(size[m].bit_length() - 1, cap)) for m, c in PLONKFRI_NTT_CALLS[run].items())


def fri_image(v):
    """A PlonkFRI proof (or any of its parts) as nested tuples of ints and
    bytes, keyed by field name: two proofs are equal field for field where
    their images are, and byte for byte where repr(image) is."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return (type(v).__name__,) + tuple((f.name, fri_image(getattr(v, f.name))) for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return tuple(sorted((k, fri_image(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(fri_image(x) for x in v)
    return v


def plonkfri_cpu_image(log2n: int):
    """(repr bytes of fri_image, seconds) of a PlonkFRI setup and prove of
    plonk_chain(log2n) on the CPU (the plain versions); top level, so that
    a worker process can run it beside the card's work."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import torch

    from tpusnark_torch.backend import plonkfri
    from tpusnark_torch.curves.ref import R

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    cs, assign = plonk_chain(log2n, R)
    pk, _ = plonkfri.setup(cs, device="cpu")
    proof = plonkfri.prove(cs, pk, assign, device="cpu")
    return repr(fri_image(proof)).encode(), time.perf_counter() - t0


def check_plonkfri_launches(launches: dict, n: int, blowup: int) -> None:
    """Every instance of the PlonkFRI prove path ran, the NTT pass kernel
    exactly as often as its transforms fix, no pointwise butterfly, no
    kernel of another curve."""
    from tpusnark_torch import kernels
    from tpusnark_torch.fields.spec import BN254_FR

    fr = BN254_FR.name
    idle = [f"{op}[{fr}]" for op in PLONKFRI_OPS if launches[f"{op}[{fr}]"] <= 0]
    if idle:
        fail(f"PlonkFRI prove: kernels of its path never launched: {idle}")
    stray = [k for k in (f"butterfly[{fr}]", f"butterfly4[{fr}]") if launches[k]]
    stray += [k for k, v in launches.items() if v and k not in kernels.instances("bn254")]
    if stray:
        fail(f"PlonkFRI prove: kernels off its path ran: {stray}")
    ntt, want = launches[f"ntt_stages[{fr}]"], plonkfri_launches_expected(n, blowup, "prove")
    if ntt != want:
        fail(f"PlonkFRI prove: {ntt} NTT pass launches, not {want}")


def phase_plonkfri(torch, dev, cpu_check):
    """PlonkFRI over BN254 (section (a) of phase 15): plonk_chain at
    2^PLONKFRI_LOG2 with default FriParams, setup and two proves on `dev`
    with phase times (the Merkle trees' leaf packing and hashing apart),
    equal field for field; the launches of the second prove counted from
    zero; the port's host verifier accepting the proof and rejecting y + 1,
    a tampered opening and a zeroed root; peak memory; at
    2^PLONKFRI_CHECK_LOG2 the card's proof equal byte for byte to the CPU's
    (the plain versions, `cpu_check`: plonkfri_cpu_image's pending result
    in a worker); then the SCS through constraint/serialize.py's dump and
    load, proved again from the loaded system: the proof equal. Returns the
    second prove's launches."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend import plonkfri
    from tpusnark_torch.constraint import serialize
    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.poly.fri import FriParams

    params = FriParams()
    t0 = time.perf_counter()
    cs, assign = plonk_chain(PLONKFRI_LOG2, R)
    compile_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = plonkfri.setup(cs, params, device=dev, timings=setup_t)
    setup_t["setup"] = time.perf_counter() - t0
    if vk.n != 1 << PLONKFRI_LOG2:
        fail(f"PlonkFRI setup chose a domain of {vk.n}, not 2^{PLONKFRI_LOG2}")
    say(
        f"[15 plonkfri] bn254: {cs.n_gates} gates, domain 2^{PLONKFRI_LOG2}, LDE domain "
        f"2^{(vk.n * vk.blowup).bit_length() - 1} (blowup {params.blowup}, {params.n_queries} queries, stop degree "
        f"{params.stop_degree}); compile {compile_s:.4f} s; setup: " + _times(setup_t)
    )
    proofs = []
    for i in range(2):
        phases = {}
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proofs.append(plonkfri.prove(cs, pk, assign, timings=phases, device=dev))
        phases["prove"] = time.perf_counter() - t0
        say(f"[15 plonkfri] prove {i + 1}: " + _times(phases))
    launches = dict(kernels.LAUNCHES)
    peak = _peak(torch, dev)
    proof = proofs[1]
    if fri_image(proofs[0]) != fri_image(proof):
        fail("the two PlonkFRI proves differ")
    if dev.type == "cuda":
        check_plonkfri_launches(launches, vk.n, vk.blowup)
    y = assign["y"]
    t0 = time.perf_counter()
    if not plonkfri.verify(proof, vk, [y]):
        fail("the port's PlonkFRI verifier rejected the card's proof")
    verify_s = time.perf_counter() - t0
    bad_opening = copy.deepcopy(proof)
    op = bad_opening.identity_queries[0].openings["l"]
    op.value = (op.value + 1) % R
    bad_root = copy.deepcopy(proof)
    bad_root.online_roots["z"] = bytes(32)
    for what, bad, pubs in (
        ("y + 1", proof, [(y + 1) % R]),
        ("a tampered opening", bad_opening, [y]),
        ("a zeroed root", bad_root, [y]),
    ):
        if plonkfri.verify(bad, vk, pubs):
            fail(f"the port's PlonkFRI verifier accepted {what}")
    say(
        f"[15 plonkfri] the two proves are equal field for field; verify accepts ({verify_s:.4f} s) and rejects y + 1, "
        f"a tampered opening and a zeroed root | peak device memory {peak:.3f} GB | the second prove's launches: "
        + _fmt({k: v for k, v in launches.items() if v})
    )
    # the card against the plain versions on the CPU (in a worker), at a
    # small size
    cs_s, assign_s = plonk_chain(PLONKFRI_CHECK_LOG2, R)
    t0 = time.perf_counter()
    pk_s, _ = plonkfri.setup(cs_s, params, device=dev)
    card_image = repr(fri_image(plonkfri.prove(cs_s, pk_s, assign_s, device=dev))).encode()
    card_s = time.perf_counter() - t0
    cpu_image, cpu_s = cpu_check.get()
    say(
        f"[15 plonkfri] 2^{PLONKFRI_CHECK_LOG2}: setup and prove on {dev.type} {card_s:.4f} s, on the CPU (in a "
        f"worker) {cpu_s:.4f} s"
    )
    if card_image != cpu_image:
        fail(f"the 2^{PLONKFRI_CHECK_LOG2} PlonkFRI proof from {dev.type} differs from the CPU's")
    # the serialized constraint system proves the same
    t0 = time.perf_counter()
    blob = serialize.dump(cs)
    loaded = serialize.load(blob)
    io_s = time.perf_counter() - t0
    again = plonkfri.prove(loaded, pk, assign, device=dev)
    if fri_image(again) != fri_image(proof):
        fail("the PlonkFRI proof from the loaded constraint system differs")
    say(
        f"[15 serialize] the 2^{PLONKFRI_CHECK_LOG2} proofs on {dev.type} and on the CPU are equal byte for byte "
        f"({len(card_image)} bytes of repr); the 2^{PLONKFRI_LOG2} SCS dumped to {len(blob)} bytes and loaded "
        f"({io_s:.4f} s) proves the same proof"
    )
    del pk, proofs, proof, again
    return launches


def gkr_circuit(n_inst: int, seed: int, builder=None, api=None):
    """tests/test_gkr_compile.py's DAG over `n_inst` batched instances: per
    instance, out = (a b + a) b and a + b, the inputs secret and seeded, the
    outputs bound to the public o<i> and s<i> through the in-circuit GKR
    verifier. `builder`, `api`: the Builder and GkrApi classes (the port's
    by default). Returns (cs, assignment, public inputs in order)."""
    if builder is None:
        from tpusnark_torch.frontend.builder import Builder as builder
    if api is None:
        from tpusnark_torch.gadgets.gkr_compile import GkrApi as api
    from tpusnark_torch.fields.spec import BN254_FR

    p = BN254_FR.modulus
    rng = random.Random(seed)
    a_vals = [rng.randrange(p) for _ in range(n_inst)]
    b_vals = [rng.randrange(p) for _ in range(n_inst)]
    b = builder(p)
    a_vars = [b.secret(f"a{i}") for i in range(n_inst)]
    b_vars = [b.secret(f"b{i}") for i in range(n_inst)]
    g = api()
    wa, wb = g.import_input(a_vars), g.import_input(b_vars)
    we = g.mul(g.add(g.mul(wa, wb), wa), wb)
    ws = g.add(wa, wb)
    g.output(we)
    g.output(ws)
    outs = g.finalize(b)
    assign, pubs = {}, []
    for i in range(n_inst):
        b.assert_is_equal(outs[we][i], b.public(f"o{i}"))
        b.assert_is_equal(outs[ws][i], b.public(f"s{i}"))
        assign.update({f"a{i}": a_vals[i], f"b{i}": b_vals[i]})
        assign[f"o{i}"] = (a_vals[i] * b_vals[i] + a_vals[i]) * b_vals[i] % p
        assign[f"s{i}"] = (a_vals[i] + b_vals[i]) % p
        pubs += [assign[f"o{i}"], assign[f"s{i}"]]
    return b.compile(), assign, pubs


def phase_gkr(torch, dev, pool, setup_only, off_path):
    """GKR inside Groth16 (section (b) of phase 15): gkr_circuit at
    GKR_INSTANCES instances, compile time, cs.stats() and the shape rule's
    branch; a seeded setup; a prove on the default branch and one with
    accelerator="host" under the same rng, equal point for point, each
    with its phase times, the launches of the second counted from zero
    (every kernel of the prove path among them); the solver refusing o0 +
    1; peak memory after setup and after the proves. Returns the launches
    and the pending verdicts: the true outputs accepted, o0 + 1 rejected."""
    from tpusnark_torch import kernels
    from tpusnark_torch.backend.config import ProverConfig
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.constraint.solver import solve
    from tpusnark_torch.curves.ref import R

    t0 = time.perf_counter()
    cs, assign, pubs = gkr_circuit(GKR_INSTANCES, SEED + 110)
    compile_s = time.perf_counter() - t0
    stats = cs.stats()
    branch = _branch(cs)
    n = 1 << (len(cs.constraints) - 1).bit_length()
    say(
        f"[15 gkr] {GKR_INSTANCES} instances over bn254: compile {compile_s:.4f} s, domain 2^{n.bit_length() - 1}, "
        f"shape rule: {branch} solver | " + _fmt(stats)
    )
    if n != 1 << GKR_LOG2:
        fail(f"the GKR circuit has {len(cs.constraints)} constraints: a domain of {n}, not 2^{GKR_LOG2}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_t = {}
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=_seeded(SEED + 111), device=dev, timings=setup_t)
    setup_t["setup"] = time.perf_counter() - t0
    say("[15 gkr] seeded setup: " + _times(setup_t) + f" | peak device memory {_peak(torch, dev):.3f} GB")
    proofs = []
    for label, config in (("default", None), ("host", ProverConfig().with_accelerator("host"))):
        phases = {}
        kernels.reset_launches()  # the main path: one prove
        t0 = time.perf_counter()
        proofs.append(prove(cs, pk, assign, rng=_seeded(SEED + 112, 0), config=config, timings=phases, device=dev))
        phases["prove"] = time.perf_counter() - t0
        say(f"[15 gkr] prove, {label} branch: " + _times(phases))
    launches = dict(kernels.LAUNCHES)
    peak = _peak(torch, dev)
    if _proof_image(proofs[0]) != _proof_image(proofs[1]):
        fail("the GKR circuit's proofs differ between the default and the host branch")
    check_prove_path(dev, "bn254", launches, setup_only, off_path, "the GKR prove")
    wrong = [(pubs[0] + 1) % R] + pubs[1:]
    pending = submit_verdicts(pool, "bn254", proofs[0], vk, pubs, wrong)
    t0 = time.perf_counter()
    why = _refused(lambda: solve(cs, dict(assign, o0=wrong[0])), "the GKR circuit with o0 + 1")
    say(
        f"[15 gkr] the two proofs are equal point for point; the solver refuses o0 + 1: {why} "
        f"({time.perf_counter() - t0:.4f} s) | peak device memory after the proves {peak:.3f} GB | launches of the "
        "host-branch prove: "
        + _fmt({k: v for k, v in launches.items() if v})
    )
    del pk, cs
    return launches, pending


def phase_contracts(chain, plonk_proved):
    """Section (c) of phase 15: phase 5's BN254 chain proof through the
    port's Groth16 Solidity contract and phase 9's PLONK proof through its
    PLONK contract, both run on testing/solidity_exec.py: each accepts and
    reverts on a wrong public input; a Witness of phase 5's assignment
    through to_bytes and from_bytes."""
    from tpusnark_torch.backend.groth16 import solidity as g16_sol
    from tpusnark_torch.backend.plonk import solidity as plonk_sol
    from tpusnark_torch.backend.witness import Witness
    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.testing.solidity_exec import Contract, ContractRevert

    for name, mod, proved in (("Groth16", g16_sol, chain), ("PLONK", plonk_sol, plonk_proved)):
        pubs = [proved.assign[k] % R for k in proved.cs.public_names if k != "1"]
        t0 = time.perf_counter()
        contract = Contract(mod.export_solidity(proved.vk))
        words = mod.proof_to_solidity_calldata(proved.proof)
        contract.call("verifyProof", words, pubs)  # reverts (raises) if it rejects
        ok_s = time.perf_counter() - t0
        try:
            contract.call("verifyProof", words, [(pubs[0] + 1) % R] + pubs[1:])
        except ContractRevert:
            pass
        else:
            fail(f"the {name} contract accepted a wrong public input")
        say(
            f"[15 solidity] the {name} contract accepts the card's proof ({len(words)} calldata words, "
            f"{ok_s:.4f} s with the export) and reverts on a wrong public input"
        )
    wit = Witness.from_assignment(chain.cs, chain.assign)
    blob = wit.to_bytes()
    back = Witness.from_bytes(blob)
    if back != wit or Witness.from_bytes(wit.public().to_bytes()) != wit.public():
        fail("phase 5's witness does not survive to_bytes and from_bytes")
    say(f"[15 witness] phase 5's witness ({wit.n_public} public, {wit.n_secret} secret) round-trips in {len(blob)} bytes")


# ---------------------------------------------------------------- main
def main() -> None:
    try:
        run()
    finally:
        stop_workers()  # also when a phase raised


def run() -> None:
    t_start = time.perf_counter()
    torch, card = phase_card()
    import numpy as np

    from tpusnark_torch import kernels
    from tpusnark_torch.constraint.solver_torch import prefer_device
    from tpusnark_torch.curves.config import get_curve

    pool = start_workers()
    phase_build()
    table, setup_only, off_path = kernel_table()
    dev = torch.device("cuda")
    np_rng = np.random.default_rng(SEED)
    checks, runs, pending = {}, {}, {}
    for curve in CURVES:
        t0 = time.perf_counter()
        cs, assign = mul_chain(LOG2_CONSTRAINTS, get_curve(curve).host.R)
        compile_s = time.perf_counter() - t0
        checks.update(phase_kernels(torch, curve, np_rng, cs.n_wires))
        phase_msm(torch, dev, curve)
        setup_launches, launches, pending[curve], proved = phase_groth16(
            torch, dev, curve, pool, cs, assign, compile_s
        )
        if curve == "bn254":
            chain = proved  # phase 11 proves it again, sharded
        elif curve == RECURSION_INNER:
            inner = inner_proofs(dev, proved)  # phase 13 (a) verifies them in a circuit
        del proved
        runs[curve] = (setup_launches, launches)
        check_launches(curve, setup_only, off_path, setup_launches, launches)
        if prefer_device(cs):  # decided (and cached on cs) by the prove
            fail(f"{curve}: the shape rule sends the chain to the device solver")
    missing = sorted(set(kernels.LAUNCHES) - set(checks))
    if missing:
        fail(f"kernels not checked: {missing}")
    # phase 10 (b) starts here: its init_phase2 and verifiers are minutes of
    # host work in the workers, beside phases 7-9 (and after phase 3's
    # kernel timings, which the host's load moves)
    ceremony = phase_ceremony_start(torch, dev, pool)
    ntt_checks = phase_ntt_large(torch, dev, np_rng, pool)
    wide_solve = {curve: phase_wide_solve(torch, dev, curve) for curve in CURVES}
    _, wide_prove_launches, pending["wide"], wide = phase_wide_prove(
        torch, dev, pool, setup_only, off_path
    )
    say(
        "[8 branch] the chain's proves took the host solver on every curve (phase 6: B1 and B2 over fr "
        f"{B1_PER_PROVE} and {B2_PER_PROVE} times), the wide circuit's default prove the device solver"
    )
    plonk_setup_launches, plonk_launches, pending["plonk"], (plonk_chain_proved, plonk_commit_vk) = phase_plonk(
        torch, dev, pool
    )
    ceremony_launches = phase_ceremony_full(torch, dev)
    shard_launches, shard_plonk_launches, pending["shard"] = phase_shard(
        torch, card, pool, np_rng, chain, wide, plonk_chain_proved, plonk_commit_vk
    )
    # phase 13 (a) before phase 12: its BW6-761 verdicts take minutes in the
    # workers, beside phases 12 and 13 (b)
    recursion_launches, pending["recursion"] = phase_recursion(torch, dev, pool, inner, setup_only, off_path)
    del inner
    # phase 10 (b)'s second half: by now its init_phase2 in a worker is done
    pending["ceremony"] = phase_ceremony_finish(torch, dev, pool, ceremony)
    pending["examples"] = phase_examples(torch, dev, pool)
    rollup_launches, pending["rollup"] = phase_rollup(torch, dev, pool, setup_only, off_path)
    rangecheck_launches, pending["rangecheck"] = phase_rangecheck(torch, dev, pool, setup_only, off_path)
    ecadd_launches, pending["ecadd"] = phase_ecadd(torch, dev, pool, setup_only, off_path)
    plonkfri_cpu = pool.apply_async(plonkfri_cpu_image, (PLONKFRI_CHECK_LOG2,))  # beside phase 15 (b)
    gkr_launches, pending["gkr"] = phase_gkr(torch, dev, pool, setup_only, off_path)
    plonkfri_launches = phase_plonkfri(torch, dev, plonkfri_cpu)
    phase_contracts(chain, plonk_chain_proved)
    collect_ntt_checks(ntt_checks)
    for curve in CURVES:
        collect_verdicts(curve, LOG2_CONSTRAINTS, pending[curve])
    collect_verdicts("bn254", f"{LOG2_CONSTRAINTS} wide and commit", pending["wide"])
    collect_verdicts("bn254", f"{PLONK_LOG2} PLONK and PLONK commit", pending["plonk"])
    collect_ceremony(ceremony, pending["ceremony"])
    collect_verdicts("bn254", f"{LOG2_CONSTRAINTS} sharded chain, wide and PLONK", pending["shard"])
    collect_verdicts("bn254", f"{SHA_LOG2} SHA-256 and the examples", pending["examples"])
    collect_verdicts("bn254", f"{ROLLUP_LOG2} rollup", pending["rollup"])
    collect_verdicts(RECURSION_OUTER, f"{RECURSION_LOG2} 2-chain", pending["recursion"])
    collect_verdicts("bn254", f"{RANGE_LOG2} range check", pending["rangecheck"])
    collect_verdicts("bn254", f"{ECADD_LOG2} ECADD batch", pending["ecadd"])
    collect_verdicts("bn254", f"{GKR_LOG2} GKR", pending["gkr"])
    stop_workers()
    for mod in ("jax", "tpusnark"):
        if mod in sys.modules:
            fail(f"{mod} was imported: the port and this script must run without it")
    rows = []
    for curve, (setup_launches, launches) in runs.items():
        for name in kernels.instances(curve):
            if name in off_path:
                continue
            source, replaces = table[name]
            run = "setup" if name in setup_only else "prove"
            c = checks[name]
            rows.append(
                dict(
                    name=name,
                    route="cuda",
                    source=source,
                    replaces=replaces,
                    launches=(setup_launches if run == "setup" else launches)[name],
                    run=run,
                    lanes=c["lanes"],
                    max_abs_err=c["max_abs_err"],
                    ms=c["ms"],
                    plain_ms=c["plain_ms"],
                    plain_device=c["plain_device"],
                    plain_lanes=c["plain_lanes"],
                    bound_ms=c["bound_ms"],
                    bound_by=c["bound_by"],
                    library_ms=None,  # no PyTorch call computes a multi-word modular product
                    launches_wide_solve=wide_solve[curve][name],
                    **(
                        {
                            "launches_wide_prove": wide_prove_launches[name],
                            "launches_plonk_prove": plonk_launches[name],
                            "launches_plonk_setup": plonk_setup_launches[name],
                            "launches_ceremony": ceremony_launches[name],
                            "launches_sharded_prove": shard_launches[name],
                            "launches_sharded_plonk": shard_plonk_launches[name],
                            "launches_rollup_prove": rollup_launches[name],
                            "launches_rangecheck_prove": rangecheck_launches[name],
                            "launches_ecadd_prove": ecadd_launches[name],
                            "launches_gkr_prove": gkr_launches[name],
                            "launches_plonkfri_prove": plonkfri_launches[name],
                        }
                        if curve == "bn254"
                        else {}
                    ),
                    **({"launches_recursion_prove": recursion_launches[name]} if curve == RECURSION_OUTER else {}),
                    **{k: c[k] for k in B1_B2_KEYS if k in c},
                    **({"absorbs": ABSORBS[op]} if (op := name.split("[")[0]) in ABSORBS else {}),
                )
            )
    say(f"[16 done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
