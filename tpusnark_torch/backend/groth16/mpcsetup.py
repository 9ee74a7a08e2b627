"""Groth16 MPC trusted setup (Powers-of-Tau ceremony), BN254, with each
contribution's rescale of the SRS on the device (the port's counterpart of
tpusnark/backend/groth16/mpcsetup.py).

Reproduces the behavior of the reference two-phase ceremony
(gnark/backend/groth16/bn254/mpcsetup/phase1.go:32-203, phase2.go:30-264,
setup.go:25-97, utils.go:31-170) from the BGM17 paper (eprint 2017/1050):

* Phase 1 ("powers of tau", circuit-independent): the SRS
  {[tau^i]1}_{i<2N-1}, {[alpha tau^i]1, [beta tau^i]1, [tau^i]2}_{i<N},
  [beta]2. Each participant multiplies the running parameters by powers of
  fresh random (tau, alpha, beta) and publishes a proof of knowledge
  (PublicKey) for each factor.
* Phase 2 (circuit-specific): Lagrange-ify the SRS (a point-IFFT), bind the
  circuit's QAP (per-wire A/B/C evaluations), then participants randomize
  delta.
* extract_keys: assemble the port's ProvingKey/VerifyingKey (gamma = 1, as
  in the reference's ExtractKeys where vk.G2.Gamma = g2).

Every contribution is verifiable against the previous transcript
(verify_phase1 / verify_phase2 pairing checks) and every object serializes,
so the ceremony is resumable from artifacts.

Everything but the rescale is tpusnark's host code, copied, in the same
order of rng draws (tau, alpha, beta, then each public key's s), so a
seeded ceremony gives tpusnark's bytes. The rescale, O(N) variable-base
scalar multiplications a contribution, keeps tpusnark's shape rule: host
``G1.mul``/``G2.mul`` below ``_DEVICE_THRESHOLD`` points, else one batched
double-and-add (:class:`~tpusnark_torch.curves.batch_mul.VarBaseMul`, a B6
and a B5 launch a scalar bit on the card) whose results come back through
setup's ``to_affine`` (one batched Fermat inversion) and ``to_host``.
``Phase1.contribute`` and ``Phase2.contribute`` compute on the card unless
the caller names the CPU (the plain versions, as the tests run them).
"""

from __future__ import annotations

import hashlib
import io
import secrets
import struct
import time
from dataclasses import dataclass, field

import torch

from ...constraint.system import ConstraintSystem
from ...curves import ref
from ...curves.batch_mul import VarBaseMul
from ...curves.config import get_curve
from ...curves.encoding import g1_to_device, g2_to_device
from ...curves.hash_to_g2 import hash_to_g2
from ...curves.marshal import g1_decode, g1_raw, g2_decode, g2_raw
from ...curves.ref import G1, G2, R
from ...curves.tcurve import curve_ops
from ...fields.tfield import compute_device, get_field
from ...poly.domain import Domain
from .keys import ProvingKey, VerifyingKey
from .setup import to_affine, to_host

_DEVICE_THRESHOLD = 1 << 9


def _rand(rng):
    return (rng or (lambda: secrets.randbelow(R - 1) + 1))()


# --------------------------------------------------------------------- PoK
@dataclass
class PublicKey:
    """Proof of knowledge of the toxic factor x (utils.go:31-58):
    (sG, sxG, x*R) with R = hash_to_g2(sG || sxG || challenge, dst)."""

    sg: tuple
    sxg: tuple
    xr: tuple

    def to_bytes(self) -> bytes:
        return g1_raw(self.sg) + g1_raw(self.sxg) + g2_raw(self.xr)

    @staticmethod
    def from_bytes(data: bytes) -> "PublicKey":
        sg, _ = g1_decode(data[0:64], check=True)
        sxg, _ = g1_decode(data[64:128], check=True)
        xr, _ = g2_decode(data[128:256], check=True)
        return PublicKey(sg, sxg, xr)


def gen_r(sg, sxg, challenge: bytes, dst: int):
    """The PoK base point R in G2 (utils.go:159-170)."""
    return hash_to_g2(g1_raw(sg) + g1_raw(sxg) + challenge, bytes([dst]))


def new_public_key(x: int, challenge: bytes, dst: int, rng=None) -> PublicKey:
    s = _rand(rng)
    sg = G1.mul(G1.generator(), s)
    sxg = G1.mul(sg, x)
    r_pt = gen_r(sg, sxg, challenge, dst)
    return PublicKey(sg, sxg, G2.mul(r_pt, x))


def same_ratio(a1, b1, a2, b2) -> bool:
    """e(a1, a2) == e(b1, b2), with subgroup checks (utils.go:105-118)."""
    for pt in (a1, b1):
        if not G1.on_curve(pt):
            raise ValueError("G1 point not on curve")
    for pt in (a2, b2):
        if not G2.in_subgroup(pt):
            raise ValueError("G2 point not in subgroup")
    return ref.pairing_check([(a1, G2.neg(a2)), (b1, b2)])


def _powers(a: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * a % R
    return out


# ----------------------------------------------------- batched point scaling
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scale(group: str, points: list, scalars: list[int], device, timings):
    """[s_i * P_i] on `device` through VarBaseMul, back as host points.
    timings (optional dict) accumulates the seconds of `encode`, `ladder`,
    `affine` (to_affine) and `decode` (to_host)."""
    cfg = get_curve("bn254")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    ops = curve_ops("bn254")[0 if group == "g1" else 1]
    steps = {}
    t0 = time.perf_counter()
    pts = (g1_to_device if group == "g1" else g2_to_device)(points, fp, device)
    sc = fr.encode(scalars, mont=False, device=device)
    _sync(device)
    steps["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = VarBaseMul(ops, fr)(pts, sc)
    _sync(device)
    steps["ladder"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    aff = to_affine(ops, out)
    _sync(device)
    steps["affine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = to_host(ops, aff, ref)
    steps["decode"] = time.perf_counter() - t0
    if timings is not None:
        for k, v in steps.items():
            timings[k] = timings.get(k, 0.0) + v
    return res


def _scale_g1(points: list, scalars: list[int], device="cuda", timings=None) -> list:
    """[s_i * P_i]; device batch for large N (VarBaseMul), host loop small."""
    if len(points) < _DEVICE_THRESHOLD:
        return [G1.mul(pt, s) for pt, s in zip(points, scalars)]
    return _scale("g1", points, scalars, compute_device(device), timings)


def _scale_g2(points: list, scalars: list[int], device="cuda", timings=None) -> list:
    if len(points) < _DEVICE_THRESHOLD:
        return [G2.mul(pt, s) for pt, s in zip(points, scalars)]
    return _scale("g2", points, scalars, compute_device(device), timings)


def _rand_lincomb_g1(pts_a: list, pts_b: list) -> tuple:
    """(sum r_i A_i, sum r_i B_i) with fresh verifier randomness
    (utils.go:121-130); collapses list equality-of-ratios to one pairing."""
    rs = [secrets.randbelow(R - 1) + 1 for _ in pts_a]
    return G1.msm(pts_a, rs), G1.msm(pts_b, rs)


def _shifted_lincomb_g1(pts: list) -> tuple:
    """(sum r_i P_i, sum r_i P_{i+1}) (utils.go:133-143)."""
    rs = [secrets.randbelow(R - 1) + 1 for _ in pts[:-1]]
    return G1.msm(pts[:-1], rs), G1.msm(pts[1:], rs)


def _shifted_lincomb_g2(pts: list) -> tuple:
    rs = [secrets.randbelow(R - 1) + 1 for _ in pts[:-1]]

    def msm2(ps):
        acc = None
        for pt, s in zip(ps, rs):
            acc = G2.add(acc, G2.mul(pt, s))
        return acc

    return msm2(pts[:-1]), msm2(pts[1:])


# ------------------------------------------------------------------ Phase 1
@dataclass
class Phase1:
    """Powers-of-tau transcript state (phase1.go:32-48)."""

    tau_g1: list  # [tau^i]1, i < 2N-1
    alpha_tau_g1: list  # [alpha tau^i]1, i < N
    beta_tau_g1: list  # [beta tau^i]1, i < N
    tau_g2: list  # [tau^i]2, i < N
    beta_g2: tuple
    pk_tau: PublicKey = None
    pk_alpha: PublicKey = None
    pk_beta: PublicKey = None
    hash: bytes = b""

    @property
    def n(self) -> int:
        return len(self.tau_g2)

    # -- serialization (resumable ceremony artifacts) --
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack(">I", self.n))
        for pt in self.tau_g1:
            buf.write(g1_raw(pt))
        for pt in self.alpha_tau_g1:
            buf.write(g1_raw(pt))
        for pt in self.beta_tau_g1:
            buf.write(g1_raw(pt))
        for pt in self.tau_g2:
            buf.write(g2_raw(pt))
        buf.write(g2_raw(self.beta_g2))
        for pk in (self.pk_tau, self.pk_alpha, self.pk_beta):
            buf.write(pk.to_bytes())
        buf.write(self.hash)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "Phase1":
        (n,) = struct.unpack(">I", data[:4])
        o = 4

        def rd_g1():
            nonlocal o
            pt, _ = g1_decode(data[o : o + 64], check=True)
            o += 64
            return pt

        def rd_g2():
            nonlocal o
            pt, _ = g2_decode(data[o : o + 128], check=True)
            o += 128
            return pt

        tau_g1 = [rd_g1() for _ in range(2 * n - 1)]
        alpha = [rd_g1() for _ in range(n)]
        beta = [rd_g1() for _ in range(n)]
        tau_g2 = [rd_g2() for _ in range(n)]
        beta_g2 = rd_g2()
        pks = []
        for _ in range(3):
            pks.append(PublicKey.from_bytes(data[o : o + 256]))
            o += 256
        h = data[o : o + 32]
        return Phase1(tau_g1, alpha, beta, tau_g2, beta_g2, *pks, hash=h)

    def compute_hash(self) -> bytes:
        """sha256 over the serialized parameters + public keys (phase1.go:199)."""
        h = hashlib.sha256()
        buf = io.BytesIO()
        buf.write(struct.pack(">I", self.n))
        for pt in self.tau_g1 + self.alpha_tau_g1 + self.beta_tau_g1:
            buf.write(g1_raw(pt))
        for pt in self.tau_g2:
            buf.write(g2_raw(pt))
        buf.write(g2_raw(self.beta_g2))
        for pk in (self.pk_tau, self.pk_alpha, self.pk_beta):
            buf.write(pk.to_bytes())
        h.update(buf.getvalue())
        return h.digest()

    def contribute(self, rng=None, device="cuda", timings: dict | None = None) -> None:
        """Multiply in fresh (tau, alpha, beta); publish PoKs (phase1.go:89).
        The rescale runs on `device` (the card unless the caller names the
        CPU) from _DEVICE_THRESHOLD points; timings (optional dict) gets
        the seconds of its steps (_scale) and of `hash`."""
        device = compute_device(device)
        n = self.n
        tau, alpha, beta = _rand(rng), _rand(rng), _rand(rng)
        self.pk_tau = new_public_key(tau, self.hash, 1, rng)
        self.pk_alpha = new_public_key(alpha, self.hash, 2, rng)
        self.pk_beta = new_public_key(beta, self.hash, 3, rng)

        taus = _powers(tau, 2 * n - 1)
        alpha_taus = [alpha * t % R for t in taus[:n]]
        beta_taus = [beta * t % R for t in taus[:n]]
        self.tau_g1 = _scale_g1(self.tau_g1, taus, device, timings)
        self.alpha_tau_g1 = _scale_g1(self.alpha_tau_g1, alpha_taus, device, timings)
        self.beta_tau_g1 = _scale_g1(self.beta_tau_g1, beta_taus, device, timings)
        self.tau_g2 = _scale_g2(self.tau_g2, taus[:n], device, timings)
        self.beta_g2 = G2.mul(self.beta_g2, beta)
        t0 = time.perf_counter()
        self.hash = self.compute_hash()
        if timings is not None:
            timings["hash"] = time.perf_counter() - t0


def init_phase1(power: int) -> Phase1:
    """Coordinator's initial (identity-scaled) transcript (phase1.go:52-86)."""
    n = 1 << power
    g1 = G1.generator()
    g2 = G2.generator()
    ph = Phase1(
        tau_g1=[g1] * (2 * n - 1),
        alpha_tau_g1=[g1] * n,
        beta_tau_g1=[g1] * n,
        tau_g2=[g2] * n,
        beta_g2=g2,
        pk_tau=new_public_key(1, b"", 1),
        pk_alpha=new_public_key(1, b"", 2),
        pk_beta=new_public_key(1, b"", 3),
    )
    ph.hash = ph.compute_hash()
    return ph


def _verify_phase1_step(prev: Phase1, cur: Phase1) -> None:
    """One contribution against its predecessor (phase1.go:135-197)."""
    tau_r = gen_r(cur.pk_tau.sg, cur.pk_tau.sxg, prev.hash, 1)
    alpha_r = gen_r(cur.pk_alpha.sg, cur.pk_alpha.sxg, prev.hash, 2)
    beta_r = gen_r(cur.pk_beta.sg, cur.pk_beta.sxg, prev.hash, 3)

    # knowledge of each toxic factor
    if not same_ratio(cur.pk_tau.sg, cur.pk_tau.sxg, cur.pk_tau.xr, tau_r):
        raise ValueError("cannot verify public key of tau")
    if not same_ratio(cur.pk_alpha.sg, cur.pk_alpha.sxg, cur.pk_alpha.xr, alpha_r):
        raise ValueError("cannot verify public key of alpha")
    if not same_ratio(cur.pk_beta.sg, cur.pk_beta.sxg, cur.pk_beta.xr, beta_r):
        raise ValueError("cannot verify public key of beta")

    # updates chain from the previous parameters
    if not same_ratio(cur.tau_g1[1], prev.tau_g1[1], tau_r, cur.pk_tau.xr):
        raise ValueError("[tau]1 not based on previous contribution")
    if not same_ratio(
        cur.alpha_tau_g1[0], prev.alpha_tau_g1[0], alpha_r, cur.pk_alpha.xr
    ):
        raise ValueError("[alpha]1 not based on previous contribution")
    if not same_ratio(cur.beta_tau_g1[0], prev.beta_tau_g1[0], beta_r, cur.pk_beta.xr):
        raise ValueError("[beta]1 not based on previous contribution")
    if not same_ratio(cur.pk_tau.sg, cur.pk_tau.sxg, cur.tau_g2[1], prev.tau_g2[1]):
        raise ValueError("[tau]2 not based on previous contribution")
    if not same_ratio(cur.pk_beta.sg, cur.pk_beta.sxg, cur.beta_g2, prev.beta_g2):
        raise ValueError("[beta]2 not based on previous contribution")

    # internal consistency: each list is geometric in tau
    g1 = G1.generator()
    g2 = G2.generator()
    l1, l2 = _shifted_lincomb_g1(cur.tau_g1)
    if not same_ratio(l1, l2, cur.tau_g2[1], g2):
        raise ValueError("invalid powers of tau in G1")
    l1, l2 = _shifted_lincomb_g1(cur.alpha_tau_g1)
    if not same_ratio(l1, l2, cur.tau_g2[1], g2):
        raise ValueError("invalid powers of alpha*tau in G1")
    l1, l2 = _shifted_lincomb_g1(cur.beta_tau_g1)
    if not same_ratio(l1, l2, cur.tau_g2[1], g2):
        raise ValueError("invalid powers of beta*tau in G1")
    m1, m2 = _shifted_lincomb_g2(cur.tau_g2)
    if not same_ratio(cur.tau_g1[1], g1, m1, m2):
        raise ValueError("invalid powers of tau in G2")

    if cur.compute_hash() != cur.hash:
        raise ValueError("cannot verify hash of contribution")


def verify_phase1(*contribs: Phase1) -> None:
    """Chain-verify >=2 transcript states (phase1.go:124-132). Raises on
    the first invalid link."""
    for prev, cur in zip(contribs, contribs[1:]):
        _verify_phase1_step(prev, cur)


# --------------------------------------------------- Lagrange-ify the SRS
def _point_ifft(pts: list, dom: Domain, g_add, g_mul):
    """coeffs_j = (1/n) sum_i w^{-ij} P_i — the inverse DFT over GROUP
    elements (reference lagrangeCoeffsG1/G2, lagrange.go:32-73, which runs a
    DIF FFT with point butterflies and twiddle scalar-muls). Recursive
    Cooley-Tukey: n/2 log n scalar muls + n log n point adds."""
    p = R
    n_inv = pow(len(pts), -1, p)

    def rec(a, w):
        m = len(a)
        if m == 1:
            return a
        even = rec(a[0::2], w * w % p)
        odd = rec(a[1::2], w * w % p)
        half = m // 2
        out = [None] * m
        wk = 1
        for k in range(half):
            t = g_mul(odd[k], wk)
            out[k] = g_add(even[k], t)
            out[k + half] = g_add(even[k], _neg_pt(t, g_add))
            wk = wk * w % p
        return out

    coeffs = rec(list(pts), dom.generator_inv)
    return [g_mul(pt, n_inv) for pt in coeffs]


def _neg_pt(pt, g_add):
    if pt is None:
        return None
    if g_add is G1.add:
        return G1.neg(pt)
    return G2.neg(pt)


def lagrange_coeffs_g1(powers_pts: list, size: int) -> list:
    dom = Domain(_fr_spec(), size)
    return _point_ifft(powers_pts[:size], dom, G1.add, G1.mul)


def lagrange_coeffs_g2(powers_pts: list, size: int) -> list:
    dom = Domain(_fr_spec(), size)
    return _point_ifft(powers_pts[:size], dom, G2.add, G2.mul)


def _fr_spec():
    from ...fields.spec import BN254_FR

    return BN254_FR


# ------------------------------------------------------------------ Phase 2
@dataclass
class Phase2Evals:
    """Circuit-bound wire evaluations carried outside the transcript
    (phase2.go:30-37): per-wire [A_w(tau)]1, [B_w(tau)]1, [B_w(tau)]2 and
    the public-wire K points."""

    a_g1: list
    b_g1: list
    b_g2: list
    vkk: list


@dataclass
class Phase2:
    delta_g1: tuple
    delta_g2: tuple
    l_g1: list  # per-private-wire (beta A + alpha B + C) / delta
    z_g1: list  # tau^i (tau^n - 1) / delta, i < n-1, natural order
    public_key: PublicKey = None
    hash: bytes = b""

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack(">II", len(self.l_g1), len(self.z_g1)))
        buf.write(g1_raw(self.delta_g1))
        buf.write(g2_raw(self.delta_g2))
        for pt in self.l_g1 + self.z_g1:
            buf.write(g1_raw(pt))
        buf.write(self.public_key.to_bytes())
        buf.write(self.hash)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "Phase2":
        nl, nz = struct.unpack(">II", data[:8])
        o = 8
        delta_g1, _ = g1_decode(data[o : o + 64], check=True)
        o += 64
        delta_g2, _ = g2_decode(data[o : o + 128], check=True)
        o += 128
        pts = []
        for _ in range(nl + nz):
            pt, _ = g1_decode(data[o : o + 64], check=True)
            o += 64
            pts.append(pt)
        pk = PublicKey.from_bytes(data[o : o + 256])
        o += 256
        return Phase2(
            delta_g1, delta_g2, pts[:nl], pts[nl:], pk, data[o : o + 32]
        )

    def _hash_body(self) -> bytes:
        h, save = None, self.hash
        self.hash = b""
        try:
            h = hashlib.sha256(self.to_bytes()).digest()
        finally:
            self.hash = save
        return h

    def contribute(self, rng=None, device="cuda", timings: dict | None = None) -> None:
        """Randomize delta; scale Z and L by its inverse (phase2.go:181-210),
        on `device` from _DEVICE_THRESHOLD points, as Phase1.contribute."""
        device = compute_device(device)
        delta = _rand(rng)
        delta_inv = pow(delta, -1, R)
        self.public_key = new_public_key(delta, self.hash, 1, rng)
        self.delta_g1 = G1.mul(self.delta_g1, delta)
        self.delta_g2 = G2.mul(self.delta_g2, delta)
        self.z_g1 = _scale_g1(self.z_g1, [delta_inv] * len(self.z_g1), device, timings)
        self.l_g1 = _scale_g1(self.l_g1, [delta_inv] * len(self.l_g1), device, timings)
        t0 = time.perf_counter()
        self.hash = self._hash_body()
        if timings is not None:
            timings["hash"] = time.perf_counter() - t0


def init_phase2(cs: ConstraintSystem, phase1: Phase1) -> tuple[Phase2, Phase2Evals]:
    """Bind the ceremony to a circuit (phase2.go:53-179): Lagrange-ify the
    SRS, accumulate per-wire QAP evaluations at tau, build Z and L."""
    n = phase1.n
    if n < len(cs.constraints):
        raise ValueError("phase1 SRS smaller than the circuit")
    if cs.commitments:
        raise NotImplementedError(
            "MPC setup does not support BSB22 commitments (neither does the "
            "reference mpcsetup)"
        )
    p = cs.modulus

    coeff_tau1 = lagrange_coeffs_g1(phase1.tau_g1, n)
    coeff_tau2 = lagrange_coeffs_g2(phase1.tau_g2, n)
    coeff_alpha_tau1 = lagrange_coeffs_g1(phase1.alpha_tau_g1, n)
    coeff_beta_tau1 = lagrange_coeffs_g1(phase1.beta_tau_g1, n)

    nw = cs.n_wires
    coeffs = cs.coeffs
    a_g1 = [None] * nw
    b_g1 = [None] * nw
    b_g2 = [None] * nw
    bA = [None] * nw
    aB = [None] * nw
    C = [None] * nw

    def acc_g1(store, w, cid, base):
        c = coeffs[cid] % p
        if c == 0:
            return
        store[w] = G1.add(store[w], G1.mul(base, c))

    def acc_g2(store, w, cid, base):
        c = coeffs[cid] % p
        if c == 0:
            return
        store[w] = G2.add(store[w], G2.mul(base, c))

    for i, con in enumerate(cs.constraints):
        for cid, vid in con.L:
            acc_g1(a_g1, vid, cid, coeff_tau1[i])
            acc_g1(bA, vid, cid, coeff_beta_tau1[i])
        for cid, vid in con.R:
            acc_g1(b_g1, vid, cid, coeff_tau1[i])
            acc_g2(b_g2, vid, cid, coeff_tau2[i])
            acc_g1(aB, vid, cid, coeff_alpha_tau1[i])
        for cid, vid in con.O:
            acc_g1(C, vid, cid, coeff_tau1[i])

    # Z_i = [tau^{i+n} - tau^i]1 for i < n-1 (natural order; our prover's
    # pk.z convention — the reference's bitReverse dance is an fft-layout
    # internal, phase2.go:146-154)
    z_g1 = [
        G1.add(phase1.tau_g1[i + n], G1.neg(phase1.tau_g1[i])) for i in range(n - 1)
    ]

    npub = cs.n_public
    l_g1 = []
    vkk = []
    for w in range(nw):
        pt = G1.add(G1.add(bA[w], aB[w]), C[w])
        if w < npub:
            vkk.append(pt)
        else:
            l_g1.append(pt)

    ph2 = Phase2(
        delta_g1=G1.generator(),
        delta_g2=G2.generator(),
        l_g1=l_g1,
        z_g1=z_g1,
        public_key=new_public_key(1, b"", 1),
    )
    ph2.hash = ph2._hash_body()
    return ph2, Phase2Evals(a_g1, b_g1, b_g2, vkk)


def _verify_phase2_step(prev: Phase2, cur: Phase2) -> None:
    """phase2.go:222-258."""
    delta_r = gen_r(cur.public_key.sg, cur.public_key.sxg, prev.hash, 1)
    if not same_ratio(cur.public_key.sg, cur.public_key.sxg, cur.public_key.xr, delta_r):
        raise ValueError("cannot verify knowledge of delta")
    if not same_ratio(cur.delta_g1, prev.delta_g1, delta_r, cur.public_key.xr):
        raise ValueError("[delta]1 not based on previous contribution")
    if not same_ratio(
        cur.public_key.sg, cur.public_key.sxg, cur.delta_g2, prev.delta_g2
    ):
        raise ValueError("[delta]2 not based on previous contribution")
    l_cur, l_prev = _rand_lincomb_g1(cur.l_g1, prev.l_g1)
    if not same_ratio(l_cur, l_prev, cur.delta_g2, prev.delta_g2):
        raise ValueError("invalid update of L by delta inverse")
    z_cur, z_prev = _rand_lincomb_g1(cur.z_g1, prev.z_g1)
    if not same_ratio(z_cur, z_prev, cur.delta_g2, prev.delta_g2):
        raise ValueError("invalid update of Z by delta inverse")
    if cur._hash_body() != cur.hash:
        raise ValueError("cannot verify hash of contribution")


def verify_phase2(*contribs: Phase2) -> None:
    for prev, cur in zip(contribs, contribs[1:]):
        _verify_phase2_step(prev, cur)


# -------------------------------------------------------------- extraction
def extract_keys(
    cs: ConstraintSystem, phase1: Phase1, phase2: Phase2, evals: Phase2Evals
) -> tuple[ProvingKey, VerifyingKey]:
    """Assemble the port's keys from the finished ceremony (setup.go:25-97).
    gamma = 1 ([gamma]2 = g2), exactly as the reference."""
    n = phase1.n
    npub = cs.n_public
    pk = ProvingKey(
        alpha_g1=phase1.alpha_tau_g1[0],
        beta_g1=phase1.beta_tau_g1[0],
        delta_g1=phase2.delta_g1,
        beta_g2=phase1.beta_g2,
        delta_g2=phase2.delta_g2,
        a=evals.a_g1,
        b1=evals.b_g1,
        b2=evals.b_g2,
        k=phase2.l_g1,
        z=phase2.z_g1,
        domain_n=n,
        k_wires=list(range(npub, cs.n_wires)),
        curve="bn254",
    )
    vk = VerifyingKey(
        alpha_g1=phase1.alpha_tau_g1[0],
        beta_g2=phase1.beta_g2,
        gamma_g2=G2.generator(),
        delta_g2=phase2.delta_g2,
        k=evals.vkk,
        beta_g1=phase1.beta_tau_g1[0],
        delta_g1=phase2.delta_g1,
    )
    return pk, vk
