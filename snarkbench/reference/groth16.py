"""Groth16 over BN254 checked with the toxic waste: the benchmark's plain
judge of a proof.

The benchmark draws the setup's toxic waste from the seed and hands the draws
to the program's setup. It passes the same draws here, with the public
columns of the reference's own compile of the circuit (``frontend/r1cs.py``).
That is enough to check a proof without the program's verifying key: with
x the public values (x_0 = 1) and u_i, v_i, w_i the QAP's columns,

    e(A, B) = e(alpha, beta) e(IC, gamma) e(C, delta),
    IC = sum_i x_i (beta u_i(tau) + alpha v_i(tau) + w_i(tau)) / gamma G1,

so with the trapdoor known e(A, B) = e((alpha beta + K) G1 + delta C, G2),
K = sum_i x_i (beta u_i(tau) + alpha v_i(tau) + w_i(tau)): one product of
two Miller loops and one final exponentiation.

The draws are read in the order the port's setup documents, which is
gnark's and tpusnark's: alpha, beta, gamma, delta, then tau (drawn again
while tau^n = 1). The domain is the power of two at or above the number of
constraints, with gnark-crypto's root of unity of BN254's r (multiplicative
generator 5).
"""

from __future__ import annotations

from .bn254 import G1, G1_GEN, G2, R, Fp2, g1_mul_jacobian, pairing_check

MULT_GEN = 5


def domain_size(n_constraints: int) -> int:
    return 1 << max(0, (max(1, n_constraints) - 1).bit_length())


def lagrange_at(t: int, n: int, m: int) -> list[int]:
    """L_j(t) for j < m over the size-n subgroup of BN254's r:
    L_j(t) = w^j (t^n - 1) / (n (t - w^j)), by one batched inversion."""
    w = pow(MULT_GEN, (R - 1) // n, R)
    base = (pow(t, n, R) - 1) * pow(n, -1, R) % R
    powers, wj = [], 1
    for _ in range(m):
        powers.append(wj)
        wj = wj * w % R
    prefix, acc = [], 1
    for wj in powers:
        prefix.append(acc)
        acc = acc * (t - wj) % R
    inv = pow(acc, -1, R)
    out = [0] * m
    for j in range(m - 1, -1, -1):
        out[j] = base * powers[j] % R * (inv * prefix[j] % R) % R
        inv = inv * (t - powers[j]) % R
    return out


def toxic_waste(draws: list[int], n: int) -> tuple[int, int, int, int, int]:
    """(alpha, beta, gamma, delta, tau) from the setup's draws."""
    alpha, beta, gamma, delta = draws[:4]
    for t in draws[4:]:
        if pow(t, n, R) != 1:
            return alpha, beta, gamma, delta, t
    raise ValueError("the setup's draws hold no tau off the domain")


class TrapdoorVerifier:
    """Checks proofs of one circuit under the keys made from `draws`.
    columns: per public wire, its (constraint, coefficient) terms in A, B
    and C (``R1CS.public_columns``)."""

    def __init__(self, columns, n_constraints: int, draws: list[int]):
        n = domain_size(n_constraints)
        alpha, beta, _gamma, self.delta, tau = toxic_waste(draws, n)
        lag = lagrange_at(tau, n, n_constraints)

        def at_tau(terms):
            return sum(c * lag[j] for j, c in terms) % R

        self.k = [(beta * at_tau(a) + alpha * at_tau(b) + at_tau(c)) % R for a, b, c in columns]
        self.alpha_beta = alpha * beta % R

    def check(self, proof, publics: list[int]) -> str | None:
        """None if `proof` = (A, B, C) proves `publics` (the public inputs
        without the constant one), else why not. A and C are (x, y) ints, B
        ((x0, x1), (y0, y1)) over Fp2 = Fp[u]/(u^2 + 1)."""
        if len(publics) + 1 != len(self.k):
            return f"{len(publics)} public inputs, the circuit has {len(self.k) - 1}"
        a, b, c = proof
        if a is None or c is None or not G1.on_curve(a) or not G1.on_curve(c):
            return "A or C is not a point of G1"
        b = None if b is None else (Fp2(*b[0]), Fp2(*b[1]))
        if b is None or not G2.in_subgroup(b):
            return "B is not a point of G2"
        k = (self.alpha_beta + self.k[0] + sum(x * ki for x, ki in zip(publics, self.k[1:]))) % R
        rhs = G1.add(g1_mul_jacobian(G1_GEN, k), g1_mul_jacobian(c, self.delta))
        if not pairing_check([(a, b), (G1.neg(rhs), G2.generator())]):
            return "the pairing equation fails"
        return None
