"""gnark-crypto byte-exact Fiat-Shamir transcript (the port's copy of
tpusnark/utils/transcript.py: same code).

Re-implements gnark-crypto's ``fiatshamir.Transcript`` byte discipline, as
used by the reference PLONK prover/verifier
(gnark/backend/plonk/bn254/prove.go:243 registers the challenges
"gamma","beta","alpha","zeta"; binding order in
backend/plonk/bn254/verify.go:296-365) with the default SHA-256 challenge
hash (gnark/backend/backend.go:71-75):

  challenge_value = H( challengeID_bytes
                       || previous_challenge_value   (if not the first)
                       || bindings_concatenated )

* bindings are raw concatenated bytes in Bind() order, no length framing
* each challenge hashes the PREVIOUS challenge's 32-byte value (chaining)
* the challenge name is written FIRST as a domain separator
* challenges must be computed in registration order; a computed challenge
  is immutable and rebinding it is an error
* fr mapping is big-endian bytes reduced mod r (gnark fr.Element.SetBytes)

Point bindings use gnark-crypto's ``Marshal()`` == ``RawBytes()``:
uncompressed big-endian X||Y (64 bytes for G1), flag bits 0b00, the point at
infinity all-zero — see curves/marshal.py (g1_raw/g2_raw).

The KZG batch-opening fold challenge is NOT part of the main transcript:
gnark-crypto's ``kzg.BatchOpenSinglePoint`` derives it from a FRESH
one-challenge transcript named "gamma" over the KZGFoldingHash (default
SHA-256), binding point || digests || claimed values || extra data — see
:func:`kzg_fold_challenge` (reference call site:
gnark/backend/plonk/bn254/prove.go:823-833).
"""

from __future__ import annotations

import hashlib


class Transcript:
    def __init__(self, challenge_names: list[str], hash_factory=None):
        # hash_factory: () -> hashlib-like object (gnark
        # WithProverChallengeHashFunction, backend.go:74); default SHA-256
        self._hash = hash_factory or hashlib.sha256
        self._names = list(challenge_names)
        self._order = {n: i for i, n in enumerate(challenge_names)}
        self._bindings: dict[str, list[bytes]] = {n: [] for n in challenge_names}
        self._values: dict[str, bytes] = {}

    def bind(self, challenge: str, data: bytes):
        assert challenge in self._order, f"unknown challenge {challenge}"
        assert challenge not in self._values, f"challenge {challenge} already computed"
        self._bindings[challenge].append(bytes(data))

    def compute(self, challenge: str) -> bytes:
        """SHA256(name || prev_challenge_value || bindings...)."""
        if challenge in self._values:
            return self._values[challenge]
        idx = self._order[challenge]
        h = self._hash()
        h.update(challenge.encode())
        if idx > 0:
            prev = self._names[idx - 1]
            h.update(self.compute(prev))
        for b in self._bindings[challenge]:
            h.update(b)
        out = h.digest()
        self._values[challenge] = out
        return out

    def challenge_int(self, challenge: str, modulus: int) -> int:
        return int.from_bytes(self.compute(challenge), "big") % modulus


def fr_bytes(x: int) -> bytes:
    """fr.Element.Marshal(): canonical 32-byte big-endian."""
    return int(x).to_bytes(32, "big")


def g1_bytes(pt) -> bytes:
    """G1Affine.Marshal() == RawBytes(): X||Y big-endian, infinity = zeros
    (gnark-crypto v0.12 bn254 layout; single source: curves/marshal.g1_raw)."""
    from ..curves.marshal import g1_raw

    return g1_raw(pt)


def kzg_fold_challenge(
    point: int,
    digests: list,
    claimed_values: list[int],
    extra: list[bytes],
    r: int,
    hash_factory=None,
) -> int:
    """gnark-crypto kzg.deriveGamma: a fresh single-challenge transcript
    "gamma" binding point.Marshal() || each digest.Marshal() || each claimed
    value.Marshal() || extra transcript data, hashed with the KZGFoldingHash
    (default SHA-256). Used by BatchOpenSinglePoint / FoldProof on both
    sides, so prover and verifier MUST call this with identical arguments."""
    tr = Transcript(["gamma"], hash_factory=hash_factory)
    tr.bind("gamma", fr_bytes(point))
    for d in digests:
        tr.bind("gamma", g1_bytes(d))
    for v in claimed_values:
        tr.bind("gamma", fr_bytes(v))
    for e in extra:
        tr.bind("gamma", e)
    return tr.challenge_int("gamma", r)
