"""FRI (Fast Reed-Solomon IOP of proximity) commitment scheme on torch
tensors (counterpart of tpusnark/poly/fri.py).

The gnark-crypto `fri` analog backing the PlonkFRI backend
(gnark/backend/plonkfri/bn254/{setup,prove,verify}.go): transparent
polynomial commitments — Merkle roots over Reed-Solomon codewords on a
multiplicative coset, radix-2 folding for the proximity proof, spot-check
queries with authentication paths.

``MerkleTree``, ``FriParams``, ``FriLayerOpening``, ``FriQuery``,
``FriProof``, ``FriScheme.verify_proximity`` and ``_interpolate_final`` are
tpusnark's host code. The rest keeps its codewords on a device, as
(words, *batch, N) Montgomery words of the port's field:

- ``lde`` is the port's NTT of size N = blowup * n, ``ntt_coset`` of the
  zero-padded coefficients (the NTT's coset shift is the FRI offset,
  ``Domain(spec, N).mult_gen``);
- a codeword's Merkle tree (``CodewordTree``) is built from its canonical
  values: B2, then ``Field.canon`` (B2 gives p for zero, and a leaf is the
  32-byte big-endian value), copied to the host once and packed into leaf
  bytes with numpy; the sha256 hashing stays on the host, one call a leaf
  and a node, and the tree keeps the leaf bytes, from which the openings
  read their values;
- ``prove_proximity`` folds on the device, nxt = (a + b + c (a - b) x_i^-1)
  / 2 over each half, with x_i^-1 = offset^-1 omega^-i a table of powers
  (``NTT.powers``) on the top layer, each layer's the square of the first
  half of the one above, no inverse per element; the transcript, the final
  layer's interpolation and the queries stay on the host.

On CPU tensors every field op takes its plain version, on CUDA tensors its
kernel; the proofs are equal value for value.
"""

from __future__ import annotations

import functools
import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..fields.tfield import get_field
from .domain import Domain
from .ntt import get_ntt


def _h(*parts: bytes) -> bytes:
    s = hashlib.sha256()
    for x in parts:
        s.update(x)
    return s.digest()


def _fe(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


class MerkleTree:
    """sha256 binary Merkle tree over field-element leaves."""

    def __init__(self, leaves: list[int]):
        n = len(leaves)
        assert n & (n - 1) == 0
        self.n = n
        lv = [_h(_fe(v)) for v in leaves]
        levels = [lv]
        while len(lv) > 1:
            lv = [_h(lv[2 * i], lv[2 * i + 1]) for i in range(len(lv) // 2)]
            levels.append(lv)
        self.levels = levels

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def path(self, i: int) -> list[bytes]:
        out = []
        for lv in self.levels[:-1]:
            out.append(lv[i ^ 1])
            i >>= 1
        return out

    @staticmethod
    def verify_path(root: bytes, i: int, value: int, path: list[bytes]) -> bool:
        node = _h(_fe(value))
        for sib in path:
            node = _h(node, sib) if i & 1 == 0 else _h(sib, node)
            i >>= 1
        return node == root


def leaf_bytes(f, words) -> np.ndarray:
    """(words, *batch, N) Montgomery words -> (*batch, N, 32) uint8: each
    value's canonical 32-byte big-endian encoding (MerkleTree's _fe). B2 and
    canon on the words' device, one copy to the host, then numpy: the word
    order reversed and each word byte-swapped."""
    if f.modulus >> 256:
        raise ValueError(f"{f.spec.name}: a leaf holds 32 bytes")
    c = f.canon(f.from_mont(words))[:8]
    w = c.cpu().numpy().view(np.uint32)
    be = np.ascontiguousarray(np.moveaxis(w[::-1], 0, -1), dtype=">u4")
    return be.view(np.uint8).reshape(be.shape[:-1] + (32,))


class CodewordTree(MerkleTree):
    """MerkleTree over a codeword's leaf bytes (N, 32) (``leaf_bytes``),
    hashed as MerkleTree hashes its int leaves; it keeps the bytes, so that
    ``value(i)`` reads leaf i without the device."""

    def __init__(self, leaves: np.ndarray):
        n = leaves.shape[0]
        assert n & (n - 1) == 0 and leaves.shape[1:] == (32,)
        self.n = n
        self.leaves = leaves
        sha = hashlib.sha256
        buf = leaves.tobytes()
        lv = [sha(buf[i : i + 32]).digest() for i in range(0, len(buf), 32)]
        levels = [lv]
        while len(lv) > 1:
            buf = b"".join(lv)
            lv = [sha(buf[i : i + 64]).digest() for i in range(0, len(buf), 64)]
            levels.append(lv)
        self.levels = levels

    def value(self, i: int) -> int:
        return int.from_bytes(self.leaves[i].tobytes(), "big")


@dataclass
class FriParams:
    blowup: int = 8       # inverse rate
    n_queries: int = 27   # ~ 80-bit proximity soundness at rate 1/8
    stop_degree: int = 8  # final layer sent in the clear


@dataclass
class FriLayerOpening:
    value: int          # v[i]
    sibling: int        # v[i + half]
    path: list[bytes]
    path_sib: list[bytes]


@dataclass
class FriQuery:
    index: int
    layers: list[FriLayerOpening]


@dataclass
class FriProof:
    layer_roots: list[bytes]
    final_poly: list[int]   # coefficients, degree < stop_degree
    queries: list[FriQuery] = field(default_factory=list)


class FriScheme:
    """Commit/open machinery over one evaluation coset of size N = blowup*n,
    its codewords on `device` (the card unless the caller names the CPU; the
    device is first needed by ``lde``, so a verifier needs none).
    ``merkle_s`` sums the seconds spent building trees (leaf packing and
    hashing)."""

    def __init__(self, spec: FieldSpec, max_degree_n: int, params: FriParams | None = None, device="cuda"):
        self.spec = spec
        self.p = spec.modulus
        self.params = params or FriParams()
        self.n = max_degree_n              # committed polys have degree < n
        self.N = self.n * self.params.blowup
        self.dom = Domain(spec, self.N)
        self.offset = self.dom.mult_gen    # evaluation coset gH
        self.omega = self.dom.generator
        self.device = device
        self.f = get_field(spec)
        self.merkle_s = 0.0

    @functools.cached_property
    def ntt(self):
        """The size-N NTT on the scheme's device; its coset is the FRI's."""
        ntt = get_ntt(self.spec, self.N, self.device)
        assert (ntt.domain.coset_shift, ntt.domain.generator) == (self.offset, self.omega)
        return ntt

    def _scalar(self, x: int, like):
        """A per-proof Montgomery scalar broadcast against `like` (uncached:
        Field.const keeps every constant it makes)."""
        return self.f.broadcast_const(self.f.encode([x % self.p], device=like.device)[:, 0], like)

    def tree(self, codeword) -> CodewordTree:
        """The Merkle tree of one (words, N) codeword."""
        return self.trees(codeword[:, None])[0]

    def trees(self, codewords) -> list[CodewordTree]:
        """The Merkle trees of a (words, k, N) stack of codewords: one
        decode and one copy to the host for all k."""
        t0 = time.perf_counter()
        leaves = leaf_bytes(self.f, codewords)
        out = [CodewordTree(lv) for lv in leaves]
        self.merkle_s += time.perf_counter() - t0
        return out

    # --------------------------------------------------------------- commit
    def lde(self, coeffs):
        """Evaluations on the coset offset*<omega> of coefficient forms
        (words, *batch, <= n), Montgomery: (words, *batch, N)."""
        assert coeffs.shape[-1] <= self.n
        pad = coeffs.new_zeros(coeffs.shape[:-1] + (self.N - coeffs.shape[-1],))
        return self.ntt.ntt_coset(torch.cat([coeffs, pad], dim=-1))

    def commit(self, coeffs):
        """-> (root, (codeword, tree)) of one (words, <= n) coefficient form;
        keep the handle for opening."""
        return self.commit_many(coeffs[:, None])[0]

    def commit_many(self, coeffs):
        """commit of each row of a (words, k, <= n) stack: one batched LDE."""
        cws = self.lde(coeffs)
        return [(t.root, (cws[:, i], t)) for i, t in enumerate(self.trees(cws))]

    # ---------------------------------------------------- proximity (prove)
    def prove_proximity(self, codeword, transcript) -> FriProof:
        """Radix-2 FRI on a (words, N) codeword claimed to be degree < n.
        Transcript supplies fold challenges + query indices (Fiat-Shamir)."""
        p, f = self.p, self.f
        trees = []
        roots = []
        offset = self.offset
        omega = self.omega
        cur = codeword
        inv2 = f.encode([pow(2, -1, p)], device=cur.device)[:, 0]
        # x_i^-1 = offset^-1 omega^-i over the top layer's first half; a
        # layer's x_i is the square of the layer above's, so its table is
        # the square of the first half of that one
        x_inv = self.ntt.powers(pow(omega, -1, p), cur.shape[1] // 2)
        x_inv = f.mul(x_inv, self._scalar(pow(offset, -1, p), x_inv))
        while cur.shape[1] > self.params.stop_degree * self.params.blowup:
            t = self.tree(cur)
            trees.append(t)
            roots.append(t.root)
            transcript.absorb(int.from_bytes(t.root, "big") % p)
            c = transcript.challenge()
            half = cur.shape[1] // 2
            if x_inv.shape[1] > half:
                x_inv = f.square(x_inv[:, :half])
            # f_next(x^2) = (f(x)+f(-x))/2 + c*(f(x)-f(-x))/(2x)
            a, b = cur[:, :half], cur[:, half:]
            d = f.mul(f.sub(a, b), x_inv)
            cur = f.mul(f.add(f.add(a, b), f.mul(self._scalar(c, d), d)), f.broadcast_const(inv2, d))
            offset = offset * offset % p
            omega = omega * omega % p

        # final layer: interpolate to coefficients and send in the clear
        final_coeffs = self._interpolate_final(f.decode(cur), offset, omega)
        for v in final_coeffs:
            transcript.absorb(v)

        # queries: the values come from the trees' leaf bytes
        n_top = codeword.shape[1]
        queries = []
        for _ in range(self.params.n_queries):
            idx = transcript.challenge() % (n_top // 2)
            q = FriQuery(idx, [])
            i = idx
            for t in trees:
                half = t.n // 2
                i %= half
                q.layers.append(FriLayerOpening(t.value(i), t.value(i + half), t.path(i), t.path(i + half)))
            queries.append(q)
        return FriProof(roots, final_coeffs, queries)

    def _interpolate_final(self, evals: list[int], offset: int, omega: int):
        """Coefficients of the final small layer (size = stop*blowup)."""
        p = self.p
        m = len(evals)
        # m is tiny: direct inverse DFT with the layer's actual omega/offset
        inv_m = pow(m, p - 2, p)
        coeffs = []
        w_inv = pow(omega, p - 2, p)
        for j in range(m):
            acc = 0
            wji = 1
            wj = pow(w_inv, j, p)
            for i in range(m):
                acc = (acc + evals[i] * wji) % p
                wji = wji * wj % p
            coeffs.append(acc * inv_m % p)
        off_inv = pow(offset, p - 2, p)
        o = 1
        for j in range(m):
            coeffs[j] = coeffs[j] * o % p
            o = o * off_inv % p
        # degree bound: everything above stop_degree must vanish
        assert all(c == 0 for c in coeffs[self.params.stop_degree:]), \
            "final layer exceeds degree bound"
        return coeffs[: self.params.stop_degree]

    # --------------------------------------------------- proximity (verify)
    def verify_proximity(self, top_root: bytes, proof: FriProof, transcript) -> bool:
        p = self.p
        # replay fold challenges
        challenges = []
        n_layers = len(proof.layer_roots)
        for root in proof.layer_roots:
            transcript.absorb(int.from_bytes(root, "big") % p)
            challenges.append(transcript.challenge())
        for v in proof.final_poly:
            transcript.absorb(v)
        if proof.layer_roots and proof.layer_roots[0] != top_root:
            return False

        inv2 = pow(2, p - 2, p)
        n_top = self.N
        for q in proof.queries:
            idx = transcript.challenge() % (n_top // 2)
            if q.index != idx:
                return False
            i_full = idx
            size = n_top
            offset, omega = self.offset, self.omega
            prev_val = None
            for li, (op, c) in enumerate(zip(q.layers, challenges)):
                half = size // 2
                i = i_full % half
                root = proof.layer_roots[li]
                if not MerkleTree.verify_path(root, i, op.value, op.path):
                    return False
                if not MerkleTree.verify_path(root, i + half, op.sibling, op.path_sib):
                    return False
                # the previous fold's output must reappear in this layer at
                # the carried index (low half -> value, high half -> sibling)
                here = op.value if i_full < half else op.sibling
                if prev_val is not None and here != prev_val:
                    return False
                xi = offset * pow(omega, i, p) % p
                s = (op.value + op.sibling) % p
                d = (op.value - op.sibling) * pow(xi, p - 2, p) % p
                prev_val = (s + c * d) % p * inv2 % p
                i_full = i
                size = half
                offset = offset * offset % p
                omega = omega * omega % p
            # check against the final polynomial
            x = offset * pow(omega, i_full, p) % p
            # note: after the last fold, the evaluation point of prev_val is
            # x_i on the folded domain of `size` elements
            acc = 0
            for c in reversed(proof.final_poly):
                acc = (acc * x + c) % p
            if prev_val != acc:
                return False
        return True
