"""Sumcheck protocol: host prover + host verifier + in-circuit verifier.

The std/sumcheck analog (gnark/std/sumcheck/sumcheck.go): prove that
a sum over the boolean hypercube equals a claim, for polynomials given as a
SUM OF PRODUCTS of multilinears (the shape GKR layer relations take). Per
round the prover sends the round univariate g_j evaluated at 0..deg; the
verifier checks g_j(0)+g_j(1) equals the running claim, derives the challenge
by Fiat-Shamir, and finishes with one oracle evaluation at the random point.

Fiat-Shamir runs over MiMC so the identical transcript is playable in-circuit
by the verifier gadget (gnark's std/fiat-shamir + std/hash/mimc pairing).

The port's copy of tpusnark/protocols/sumcheck.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hashes.mimc import MiMC, MiMCGadget
from .multilinear import MultiLin, interpolate_univariate


@dataclass
class SumcheckProof:
    # rounds[j] = evaluations of g_j at x = 0, 1, ..., deg
    rounds: list[list[int]]
    # evaluations of each factor of each term at the final random point (the
    # "oracle" claims the caller must separately verify)
    final_evals: list[list[int]]


class Transcript:
    """MiMC-based challenge derivation, identical host-side and in-circuit."""

    def __init__(self, p: int, api=None):
        self.h = MiMC(p) if api is None else MiMCGadget(api)

    def absorb(self, *vals):
        self.h.write(*vals)

    def challenge(self):
        c = self.h.sum()
        self.h.write(c)  # chain: next challenge binds this one
        return c

    def challenges(self, k: int):
        return [self.challenge() for _ in range(k)]


def _round_degree(terms) -> int:
    return max(len(t) for t in terms)


def prove_terms(
    terms: list[list[MultiLin]], claim: int, p: int, tr: Transcript | None = None
):
    """Prove sum_x  Σ_t Π_j terms[t][j](x) == claim. All factors must share
    the variable count. Returns (rounds, point, final_evals)."""
    n_vars = terms[0][0].n_vars
    deg = _round_degree(terms)
    cur = [[MultiLin(f.e, p) for f in t] for t in terms]
    if tr is None:
        tr = Transcript(p)
        tr.absorb(claim)

    rounds = []
    point = []
    for _ in range(n_vars):
        half = len(cur[0][0]) // 2
        evals = [0] * (deg + 1)
        for i in range(half):
            for term in cur:
                los = [f.e[2 * i] for f in term]
                his = [f.e[2 * i + 1] for f in term]
                for t in range(deg + 1):
                    prod = 1
                    for lo, hi in zip(los, his):
                        prod = prod * ((lo + t * (hi - lo)) % p) % p
                    evals[t] = (evals[t] + prod) % p
        rounds.append(evals)
        tr.absorb(*evals)
        r = tr.challenge()
        point.append(r)
        cur = [[f.fix_first(r) for f in term] for term in cur]

    final_evals = [[f.e[0] for f in term] for term in cur]
    return rounds, point, final_evals


def verify_rounds(
    claim: int, rounds: list[list[int]], deg: int, p: int,
    tr: Transcript | None = None,
):
    """Host verifier core: replay the rounds, return (point, expected_final)
    where expected_final is what the summed polynomial must evaluate to at
    point. The caller performs the oracle check."""
    if tr is None:
        tr = Transcript(p)
        tr.absorb(claim)
    running = claim % p
    point = []
    for evals in rounds:
        if len(evals) != deg + 1:
            raise ValueError("bad round arity")
        if (evals[0] + evals[1]) % p != running:
            raise ValueError("sumcheck round inconsistent with claim")
        tr.absorb(*evals)
        r = tr.challenge()
        point.append(r)
        running = interpolate_univariate(
            [(t, e) for t, e in enumerate(evals)], r, p
        )
    return point, running


# ------------------------------------------------------- simple-product API
def prove(factors: list[MultiLin], claim: int, p: int) -> SumcheckProof:
    rounds, _, final = prove_terms([factors], claim, p)
    return SumcheckProof(rounds, final)


def verify(claim: int, proof: SumcheckProof, n_vars: int, p: int):
    """Verify a single-product sumcheck; checks the oracle claim against the
    prover-supplied factor evaluations and returns the random point (the
    caller must still validate those factor evaluations externally)."""
    deg = len(proof.final_evals[0])
    point, running = verify_rounds(claim, proof.rounds, deg, p)
    prod = 1
    for e in proof.final_evals[0]:
        prod = prod * e % p
    if prod != running:
        raise ValueError("sumcheck final evaluation mismatch")
    if len(point) != n_vars:
        raise ValueError("wrong number of rounds")
    return point


# ----------------------------------------------------------- in-circuit side
def verify_rounds_in_circuit(api, claim, rounds, deg: int, tr=None):
    """In-circuit analog of verify_rounds: same transcript and checks over
    circuit variables. Returns (point, expected_final)."""
    p = api.p
    if tr is None:
        tr = Transcript(p, api=api)
        tr.absorb(claim)
    running = claim
    point = []
    # Lagrange interpolation at fixed nodes 0..deg: denominators constant.
    denoms = []
    for i in range(deg + 1):
        d = 1
        for j in range(deg + 1):
            if i != j:
                d = d * ((i - j) % p) % p
        denoms.append(pow(d, p - 2, p))
    for evals in rounds:
        assert len(evals) == deg + 1
        api.assert_is_equal(api.add(evals[0], evals[1]), running)
        tr.absorb(*evals)
        r = tr.challenge()
        point.append(r)
        diffs = [api.sub(r, t) for t in range(deg + 1)]
        pre = [1]
        for d in diffs:
            pre.append(api.mul(pre[-1], d))
        suf = [1]
        for d in reversed(diffs):
            suf.append(api.mul(suf[-1], d))
        suf = suf[::-1]
        acc = 0
        for i in range(deg + 1):
            basis = api.mul(pre[i], suf[i + 1])
            acc = api.add(acc, api.mul(api.mul(evals[i], denoms[i]), basis))
        running = acc
    return point, running


def verify_in_circuit(api, claim, rounds, final_evals, n_vars: int):
    """In-circuit single-product verifier: constrains the prover-supplied
    factor evaluations against the replayed rounds; returns the point."""
    deg = len(final_evals)
    point, running = verify_rounds_in_circuit(api, claim, rounds, deg)
    prod = 1
    for e in final_evals:
        prod = api.mul(prod, e)
    api.assert_is_equal(prod, running)
    assert len(point) == n_vars
    return point
