"""PlonkFRI setup / prove / verify on torch tensors (counterpart of
tpusnark/backend/plonkfri/scheme.py).

Reference shape: gnark/backend/plonkfri/bn254/setup.go:101 (Setup:
selector + permutation polynomials, FRI-committed), prove.go:70 (Prove:
solve -> commit L,R,O -> gamma,beta -> Z -> alpha -> quotient -> openings),
verify.go:31 (Verify: replay challenges, pointwise identity at the opened
positions, batch FRI proximity).

Identity checked at each queried LDE position x (all positions lie on the
coset g<Omega>, disjoint from the evaluation domain H, so the check is a
Schwartz-Zippel test of the full polynomial identity):

    ql l + qr r + qm l r + qo o + qc + PI(x)
  + alpha [ z (l+bx+g)(r+b k1 x+g)(o+b k2 x+g)
            - z(wx) (l+b s1+g)(r+b s2+g)(o+b s3+g) ]
  + alpha^2 L1(x) (z - 1)
  == (x^n - 1) (h1 + x^n h2 + x^{2n} h3)

Low-degreeness of every committed column is established by ONE batched FRI
proximity proof over a random linear combination (correlated agreement).

The key and proof containers and ``verify`` are tpusnark's host code.
``setup`` and ``prove`` run every domain-sized step on a device (the card
unless the caller names the CPU), as (words, ..., n) Montgomery words:

- setup: the selector and permutation columns gathered on the device as in
  the port's PLONK setup, one batched INTT of the eight, one batched LDE
  (``FriScheme.commit_many``);
- prove: the wire columns gathered from the encoded witness, one batched
  INTT and LDE of l, r, o; z as the port's PLONK z stage builds it (two
  prefix products and one batched Fermat inversion), the small-domain
  s-evaluations an NTT of the fixed coefficients; the quotient over all N
  LDE points: x from ``NTT.powers``, x^n (so Z_H(x)) repeating with period
  ``blowup`` in the index (``blowup`` host inversions, gathered by index
  mod blowup), (x - 1)^-1 one batched inversion, z(omega x) a roll by
  ``blowup``, the PI column an INTT and an LDE; the quotient's coefficients
  by ``intt_coset``, its degree checked on the device; the
  lambda-combination of the 15 codewords on the device, then
  ``FriScheme.prove_proximity``; the openings read the trees' leaf bytes at
  the queried indices.

No ZK blinding and a MiMC Fiat-Shamir transcript, as in tpusnark; the same
circuit gives tpusnark's proof, field for field.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ...constraint.scs import SparseConstraintSystem, solve_scs
from ...fields.spec import BN254_FR
from ...fields.tfield import compute_device, get_field
from ...poly.domain import Domain
from ...poly.fri import FriParams, FriProof, FriScheme, MerkleTree
from ...poly.kzg import scalar
from ...poly.ntt import get_ntt
from ...poly.scan import prefix_mul
from ...protocols.sumcheck import Transcript
from ..plonk.keys import identity_columns
from ..plonk.prove import _lin, _prod3, _sparse_column, _wire_ids
from ..plonk.setup import _next_pow2, build_permutation, pick_cosets, selector_columns

_fr = get_field(BN254_FR)

# committed-column order: fixed (setup) then online (prover) then quotient
FIXED_COLS = ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3")
ONLINE_COLS = ("l", "r", "o", "z")
H_COLS = ("h1", "h2", "h3")
ALL_COLS = FIXED_COLS + ONLINE_COLS + H_COLS

N_IDENTITY_QUERIES = 20


@dataclass
class PlonkFriVerifyingKey:
    n: int
    generator: int
    k1: int
    k2: int
    n_public: int
    blowup: int
    fri_params: FriParams
    fixed_roots: dict  # name -> Merkle root (bytes)


@dataclass
class PlonkFriProvingKey:
    vk: PlonkFriVerifyingKey
    fixed_coeffs: dict   # name -> (words, n) Montgomery coefficients
    fixed_codewords: dict  # name -> (codeword (words, N), CodewordTree)
    omega_pows: object = None  # (words, n): omega^i, the identity columns' base


@dataclass
class ColumnOpening:
    value: int
    path: list[bytes]


@dataclass
class IdentityQuery:
    index: int
    openings: dict            # col name -> ColumnOpening
    z_shift: ColumnOpening    # z at index + blowup (mod N)


@dataclass
class PlonkFriProof:
    online_roots: dict        # name -> root for l, r, o, z, h1, h2, h3
    identity_queries: list[IdentityQuery] = field(default_factory=list)
    fri_proof: FriProof | None = None
    fri_queries: list[dict] = field(default_factory=list)  # per FRI query:
    # col name -> ColumnOpening at the FRI top-layer index (links the batch
    # codeword G to the individual column commitments)


def _scheme(vk: PlonkFriVerifyingKey, device="cuda") -> FriScheme:
    return FriScheme(BN254_FR, vk.n, vk.fri_params, device=device)


def _opening(tree, i: int) -> ColumnOpening:
    return ColumnOpening(tree.value(i), tree.path(i))


def _timer(device, timings):
    """mark(name, t0): add the seconds since t0 to timings[name] (the device
    synchronised first) and return the time; a no-op without timings."""

    def mark(name, t0):
        if timings is None:
            return 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + (t - t0)
        return t

    return mark


# ---------------------------------------------------------------------- setup
def setup(cs: SparseConstraintSystem, fri_params: FriParams | None = None, device="cuda", timings=None):
    """(pk, vk) with the fixed columns interpolated, extended and committed on
    `device`: the card, unless the caller names the CPU. `timings`: optional
    dict of seconds (columns, lde, merkle: the trees' leaf packing and
    hashing, counted inside lde too)."""
    device = compute_device(device)
    mark = _timer(device, timings)
    p = cs.modulus
    assert p == BN254_FR.modulus, "PlonkFRI is BN254-only"
    if cs.commitments:
        raise NotImplementedError("PlonkFRI does not support BSB22 commitments")
    t0 = time.perf_counter()
    f = _fr
    n = _next_pow2(max(8, cs.n_gates))
    params = fri_params or FriParams()
    k1, k2 = pick_cosets(n, p)
    dom = Domain(BN254_FR, n)
    ntt_n = get_ntt(BN254_FR, n, device)

    # selector columns gathered by coefficient id, permutation columns
    # gathered from the identity columns by sigma (as the port's PLONK setup)
    q = selector_columns(cs, n, device)
    sigma = torch.tensor(build_permutation(cs, n), dtype=torch.int64, device=device)
    omega_pows = ntt_n.powers(dom.generator, n)
    ids = identity_columns(f, omega_pows, k1, k2).view(f.n, 3 * n)
    s_lag = ids.index_select(1, sigma).view(f.n, 3, n)
    evals = torch.cat([torch.stack([q[k] for k in ("qL", "qR", "qM", "qO", "qC")], dim=1), s_lag], dim=1)
    coeffs = ntt_n.intt(evals)  # (words, 8, n), FIXED_COLS order
    t0 = mark("columns", t0)

    vk = PlonkFriVerifyingKey(
        n=n, generator=dom.generator, k1=k1, k2=k2, n_public=cs.n_public,
        blowup=params.blowup, fri_params=params, fixed_roots={},
    )
    scheme = _scheme(vk, device)
    fixed_coeffs = {}
    fixed_codewords = {}
    for i, (name, (root, handle)) in enumerate(zip(FIXED_COLS, scheme.commit_many(coeffs))):
        fixed_coeffs[name] = coeffs[:, i]
        vk.fixed_roots[name] = root
        fixed_codewords[name] = handle
    mark("lde", t0)
    if timings is not None:
        timings["merkle"] = scheme.merkle_s
    pk = PlonkFriProvingKey(vk, fixed_coeffs, fixed_codewords, omega_pows)
    return pk, vk


# ---------------------------------------------------------------------- prove
def prove(cs: SparseConstraintSystem, pk: PlonkFriProvingKey, assignment: dict, timings=None, device="cuda"):
    """PlonkFRI proof of `assignment`, computed on `device`: the card, unless
    the caller names the CPU (the key's tensors are moved there if they lie
    elsewhere). `timings`: optional dict of seconds per phase (solve, lro, z,
    quotient, fri, open) and merkle, the trees' leaf packing and hashing,
    counted inside the phases too; timing synchronises the device between
    phases, so pass it only to measure."""
    device = compute_device(device)
    mark = _timer(device, timings)
    f = _fr
    p = cs.modulus
    vk = pk.vk
    n = vk.n
    ntt_n = get_ntt(BN254_FR, n, device)
    scheme = _scheme(vk, device)
    ntt_N = scheme.ntt
    N = scheme.N
    blowup = vk.blowup

    # ---- 1. solve + wire columns (W encoded once, gathered by wire id)
    t0 = time.perf_counter()
    W = solve_scs(cs, assignment)
    pubs = [int(x) % p for x in W[: cs.n_public]]
    t0 = mark("solve", t0)
    w_dev = f.encode(W + [0], device=device)
    lro = w_dev.index_select(1, _wire_ids(cs, n).reshape(-1).to(device)).view(f.n, 3, n)

    tr = Transcript(p)
    for name in FIXED_COLS:
        tr.absorb(int.from_bytes(vk.fixed_roots[name], "big") % p)
    for x in pubs:
        tr.absorb(x)

    roots = {}
    handles = {name: (cw.to(device), tree) for name, (cw, tree) in pk.fixed_codewords.items()}
    for name, (root, handle) in zip(("l", "r", "o"), scheme.commit_many(ntt_n.intt(lro))):
        roots[name] = root
        handles[name] = handle
        tr.absorb(int.from_bytes(root, "big") % p)
    gamma = tr.challenge()
    beta = tr.challenge()
    t0 = mark("lro", t0)

    # ---- 2. grand product Z over the small domain: z_0 = 1, z_(j+1) = z_j
    # num_j / den_j, as prefix products and one batched inversion
    gamma_m, beta_m = scalar(gamma, device), scalar(beta, device)
    s_small = ntt_n.ntt(torch.stack([pk.fixed_coeffs[k].to(device) for k in ("s1", "s2", "s3")], dim=1))
    ids = identity_columns(f, pk.omega_pows.to(device), vk.k1, vk.k2)
    pnum = prefix_mul(f, _prod3(_lin(lro, ids, beta_m, gamma_m)))
    pden = prefix_mul(f, _prod3(_lin(lro, s_small, beta_m, gamma_m)))
    zfull = f.mul(pnum, f.inv(pden))
    z_e = torch.cat([f.broadcast_const(f.one(device), zfull[:, :1]), zfull[:, : n - 1]], dim=1)
    root, handle = scheme.commit(ntt_n.intt(z_e))
    roots["z"] = root
    handles["z"] = handle
    tr.absorb(int.from_bytes(root, "big") % p)
    alpha = tr.challenge()
    t0 = mark("z", t0)

    # ---- 3. quotient on the LDE coset
    lde = {name: handles[name][0] for name in FIXED_COLS + ("l", "r", "o", "z")}
    # PI polynomial evaluations on the coset: interpolate pubs over H
    pi_lde = scheme.lde(ntt_n.intt(_sparse_column(dict(enumerate(pubs)), n, device)))
    x = ntt_N.powers(scheme.omega, N)
    x = f.mul(x, f.broadcast_const(scalar(scheme.offset, device), x))
    # x^n = offset^n omega^(n i) repeats with period blowup in i
    zh_host = [(pow(scheme.offset * pow(scheme.omega, i, p), n, p) - 1) % p for i in range(blowup)]
    period = torch.arange(N, device=device) % blowup
    zh = f.encode(zh_host, device=device).index_select(1, period)
    zh_inv = f.encode([pow(v, p - 2, p) for v in zh_host], device=device).index_select(1, period)
    one = f.broadcast_const(f.one(device), x)
    # L1 on the coset: (x^n - 1) / (n (x - 1))
    l1 = f.mul(f.mul(zh, f.inv(f.sub(x, one))), f.broadcast_const(scalar(pow(n, p - 2, p), device), x))
    l_, r_, o_, z_ = lde["l"], lde["r"], lde["o"], lde["z"]
    zs = torch.roll(z_, -blowup, dims=1)  # z(omega^blowup x): index i + blowup (mod N)
    lro_N = torch.stack([l_, r_, o_], dim=1)
    gate = f.add(
        f.add(f.mul(lde["ql"], l_), f.mul(lde["qr"], r_)),
        f.add(f.mul(lde["qm"], f.mul(l_, r_)), f.add(f.mul(lde["qo"], o_), f.add(lde["qc"], pi_lde))),
    )
    xs = torch.stack([x, f.mul(x, f.broadcast_const(scalar(vk.k1, device), x)),
                      f.mul(x, f.broadcast_const(scalar(vk.k2, device), x))], dim=1)
    s_N = torch.stack([lde["s1"], lde["s2"], lde["s3"]], dim=1)
    perm = f.sub(
        f.mul(z_, _prod3(_lin(lro_N, xs, beta_m, gamma_m))),
        f.mul(zs, _prod3(_lin(lro_N, s_N, beta_m, gamma_m))),
    )
    a1 = f.broadcast_const(scalar(alpha, device), x)
    a2 = f.broadcast_const(scalar(alpha * alpha, device), x)
    num = f.add(gate, f.add(f.mul(a1, perm), f.mul(a2, f.mul(l1, f.sub(z_, one)))))
    h_num = f.mul(num, zh_inv)

    # H coefficients: inverse LDE (un-coset + INTT), degree must be < 3n
    h_coeffs = ntt_N.intt_coset(h_num)
    assert bool(f.is_zero(h_coeffs[:, 3 * n :]).all()), "quotient degree overflow"
    for name, (root, handle) in zip(H_COLS, scheme.commit_many(h_coeffs[:, : 3 * n].reshape(f.n, 3, n))):
        roots[name] = root
        handles[name] = handle
        tr.absorb(int.from_bytes(root, "big") % p)
    t0 = mark("quotient", t0)

    # ---- 4. batched FRI proximity over lambda-combination of ALL columns
    lam = tr.challenge()
    G = None
    lpow = 1
    for name in ALL_COLS:
        cw = handles[name][0]
        term = f.mul(cw, f.broadcast_const(scalar(lpow, device), cw))
        G = term if G is None else f.add(G, term)
        lpow = lpow * lam % p
    fri_proof = scheme.prove_proximity(G, tr)
    t0 = mark("fri", t0)
    # component openings at the FRI top-layer query indices (both halves are
    # touched by the fold, so open idx and idx + N/2)
    fri_queries = []
    for q in fri_proof.queries:
        fri_queries.append({
            name: (_opening(handles[name][1], q.index), _opening(handles[name][1], q.index + N // 2))
            for name in ALL_COLS
        })

    # ---- 5. identity spot checks
    queries = []
    for _ in range(N_IDENTITY_QUERIES):
        idx = tr.challenge() % N
        ops = {name: _opening(handles[name][1], idx) for name in ALL_COLS}
        queries.append(IdentityQuery(idx, ops, _opening(handles["z"][1], (idx + blowup) % N)))
    mark("open", t0)
    if timings is not None:
        timings["merkle"] = timings.get("merkle", 0.0) + scheme.merkle_s

    return PlonkFriProof(roots, queries, fri_proof, fri_queries)


# --------------------------------------------------------------------- verify
def verify(proof: PlonkFriProof, vk: PlonkFriVerifyingKey, public_inputs: list[int]) -> bool:
    p = BN254_FR.modulus
    n = vk.n
    scheme = _scheme(vk)
    N = scheme.N
    pubs = [int(x) % p for x in public_inputs]
    if len(pubs) != vk.n_public:
        return False
    for name in ONLINE_COLS + H_COLS:
        if name not in proof.online_roots:
            return False

    tr = Transcript(p)
    for name in FIXED_COLS:
        tr.absorb(int.from_bytes(vk.fixed_roots[name], "big") % p)
    for x in pubs:
        tr.absorb(x)
    for name in ("l", "r", "o"):
        tr.absorb(int.from_bytes(proof.online_roots[name], "big") % p)
    gamma = tr.challenge()
    beta = tr.challenge()
    tr.absorb(int.from_bytes(proof.online_roots["z"], "big") % p)
    alpha = tr.challenge()
    for name in H_COLS:
        tr.absorb(int.from_bytes(proof.online_roots[name], "big") % p)
    lam = tr.challenge()

    def root_of(name):
        return vk.fixed_roots[name] if name in vk.fixed_roots else proof.online_roots[name]

    # ---- batched FRI proximity + linkage of G to the column commitments
    if proof.fri_proof is None:
        return False
    # the FRI proof's own top layer root must equal the lambda-combination
    # commitment; we don't have a separate G root — the proximity proof's
    # first layer root IS the commitment to G.  Verify proximity first
    # (replays the transcript), then check linkage at each query.
    g_top_root = proof.fri_proof.layer_roots[0] if proof.fri_proof.layer_roots else None
    if g_top_root is None:
        return False
    if not scheme.verify_proximity(g_top_root, proof.fri_proof, tr):
        return False
    if len(proof.fri_queries) != len(proof.fri_proof.queries):
        return False
    for q, ops in zip(proof.fri_proof.queries, proof.fri_queries):
        for half, (pos_get, fri_val) in enumerate(
            ((q.index, q.layers[0].value), (q.index + N // 2, q.layers[0].sibling))
        ):
            acc = 0
            lpow = 1
            for name in ALL_COLS:
                op = ops[name][half]
                if not MerkleTree.verify_path(root_of(name), pos_get, op.value, op.path):
                    return False
                acc = (acc + lpow * op.value) % p
                lpow = lpow * lam % p
            if acc != fri_val:
                return False

    # ---- identity spot checks
    n_inv = pow(n, p - 2, p)
    w = vk.generator
    for q in proof.identity_queries:
        idx = tr.challenge() % N
        if q.index != idx:
            return False
        vals = {}
        for name in ALL_COLS:
            op = q.openings[name]
            if not MerkleTree.verify_path(root_of(name), idx, op.value, op.path):
                return False
            vals[name] = op.value
        zi = (idx + vk.blowup) % N
        if not MerkleTree.verify_path(proof.online_roots["z"], zi,
                                      q.z_shift.value, q.z_shift.path):
            return False
        zs = q.z_shift.value

        x = scheme.offset * pow(scheme.omega, idx, p) % p
        xn = pow(x, n, p)
        zh = (xn - 1) % p
        # PI(x) by the Lagrange formula over H
        pi = 0
        wi = 1
        for pub in pubs:
            li = wi * zh % p * n_inv % p * pow((x - wi) % p, p - 2, p) % p
            pi = (pi + pub * li) % p
            wi = wi * w % p
        l1 = zh * n_inv % p * pow((x - 1) % p, p - 2, p) % p

        l_, r_, o_, z_ = vals["l"], vals["r"], vals["o"], vals["z"]
        gate = (
            vals["ql"] * l_ + vals["qr"] * r_ + vals["qm"] * l_ % p * r_
            + vals["qo"] * o_ + vals["qc"] + pi
        ) % p
        perm = (
            z_ * ((l_ + beta * x + gamma) % p) % p
            * ((r_ + beta * vk.k1 % p * x + gamma) % p) % p
            * ((o_ + beta * vk.k2 % p * x + gamma) % p)
            - zs * ((l_ + beta * vals["s1"] + gamma) % p) % p
            * ((r_ + beta * vals["s2"] + gamma) % p) % p
            * ((o_ + beta * vals["s3"] + gamma) % p)
        ) % p
        lhs = (gate + alpha * perm + alpha * alpha % p * l1 % p * ((z_ - 1) % p)) % p
        h = (vals["h1"] + xn * vals["h2"] + xn * xn % p * vals["h3"]) % p
        if lhs != zh * h % p:
            return False
    return True
