"""FFT domain: roots of unity, twiddle tables, coset tables (the port's copy
of tpusnark/poly/domain.py).

The analog of gnark-crypto's ``fft.Domain`` (used by the reference at
gnark/backend/groth16/bn254/prove.go:369-393 and
gnark/backend/plonk/bn254/prove.go:284-288). The host side precomputes
Python-int tables once; ``poly/ntt.py`` encodes them for the device.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields.spec import FieldSpec


class Domain:
    """Radix-2 multiplicative subgroup domain of size n = 2^k over spec's field.

    Coset = multiplicative-generator coset, like gnark's
    ``domain.CosetTable`` (OnCoset FFTs in the quotient computation).
    """

    def __init__(self, spec: FieldSpec, n: int, mult_gen: int | None = None):
        assert n & (n - 1) == 0 and n >= 1
        self.spec = spec
        self.n = n
        self.k = n.bit_length() - 1
        p = spec.modulus
        # two-adicity of the field
        s = 0
        t = p - 1
        while t % 2 == 0:
            t //= 2
            s += 1
        assert self.k <= s, f"domain size 2^{self.k} exceeds field two-adicity {s}"
        self.two_adicity = s

        # multiplicative generator: 5 for bn254-fr (matches gnark-crypto's
        # FrMultiplicativeGen); verified to generate the full 2-Sylow subgroup.
        g = mult_gen if mult_gen is not None else self._find_mult_gen(p, s)
        self.mult_gen = g
        root_2adic = pow(g, (p - 1) >> s, p)
        assert pow(root_2adic, 1 << (s - 1), p) != 1, "mult_gen does not generate 2-Sylow"
        self.generator = pow(root_2adic, 1 << (s - self.k), p) if n > 1 else 1
        self.generator_inv = pow(self.generator, -1, p)
        self.n_inv = pow(n, -1, p)
        self.coset_shift = g
        self.coset_shift_inv = pow(g, -1, p)

    @staticmethod
    def _find_mult_gen(p: int, s: int) -> int:
        for g in range(2, 100):
            if pow(g, (p - 1) // 2, p) != 1:
                return g
        raise ValueError("no small multiplicative generator found")

    # --- host tables (python ints) ------------------------------------------
    @functools.cached_property
    def powers(self) -> list[int]:
        """omega^i for i in 0..n-1."""
        p, w = self.spec.modulus, self.generator
        out = [1] * self.n
        for i in range(1, self.n):
            out[i] = out[i - 1] * w % p
        return out

    @functools.cached_property
    def powers_inv(self) -> list[int]:
        p = self.spec.modulus
        return [pow(x, -1, p) for x in self.powers]

    def coset_powers(self, inv: bool = False) -> list[int]:
        """shift^i (or shift^-i) for i in 0..n-1."""
        p = self.spec.modulus
        s = self.coset_shift_inv if inv else self.coset_shift
        out = [1] * self.n
        for i in range(1, self.n):
            out[i] = out[i - 1] * s % p
        return out

    # --- reference NTT over python ints (oracle) ----------------------------
    def ntt_ref(self, coeffs: list[int]) -> list[int]:
        """Evaluate polynomial (coeff form, degree < n) on the domain:
        out[i] = sum_j coeffs[j] * omega^(i*j). O(n log n) recursion."""
        p = self.spec.modulus
        n = self.n
        assert len(coeffs) == n

        def rec(c, w):
            m = len(c)
            if m == 1:
                return c[:]
            ev = rec(c[0::2], w * w % p)
            od = rec(c[1::2], w * w % p)
            out = [0] * m
            wj = 1
            for j in range(m // 2):
                t = wj * od[j] % p
                out[j] = (ev[j] + t) % p
                out[j + m // 2] = (ev[j] - t) % p
                wj = wj * w % p
            return out

        return rec([c % p for c in coeffs], self.generator)

    def intt_ref(self, evals: list[int]) -> list[int]:
        p = self.spec.modulus
        n = self.n

        def rec(c, w):
            m = len(c)
            if m == 1:
                return c[:]
            ev = rec(c[0::2], w * w % p)
            od = rec(c[1::2], w * w % p)
            out = [0] * m
            wj = 1
            for j in range(m // 2):
                t = wj * od[j] % p
                out[j] = (ev[j] + t) % p
                out[j + m // 2] = (ev[j] - t) % p
                wj = wj * w % p
            return out

        out = rec([c % p for c in evals], self.generator_inv)
        ninv = self.n_inv
        return [x * ninv % p for x in out]


def bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev
