"""Witness container with gnark's exact binary protocol.

Reference: gnark/backend/witness/witness.go:17-36 —
  Witness -> [uint32(nbPublic) | uint32(nbSecret) | fr.Vector]
  fr.Vector -> [uint32(len) | 32-byte big-endian elements...]
ordering: public variables first, then secret, in declaration order.
Byte-for-byte compatible with gnark witnesses (cross-checking mandated by
SURVEY.md §7 step 4).

The port's copy of tpusnark/backend/witness.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..fields.spec import BN254_FR


@dataclass
class Witness:
    n_public: int
    n_secret: int
    values: list[int]  # publics then secrets
    modulus: int = BN254_FR.modulus

    @property
    def element_size(self) -> int:
        return (self.modulus.bit_length() + 7) // 8

    def public(self) -> "Witness":
        return Witness(self.n_public, 0, self.values[: self.n_public], self.modulus)

    def to_bytes(self) -> bytes:
        es = self.element_size
        out = struct.pack(">III", self.n_public, self.n_secret, len(self.values))
        for v in self.values:
            out += (int(v) % self.modulus).to_bytes(es, "big")
        return out

    @classmethod
    def from_bytes(cls, data: bytes, modulus: int = BN254_FR.modulus) -> "Witness":
        npub, nsec, ln = struct.unpack_from(">III", data, 0)
        es = (modulus.bit_length() + 7) // 8
        off = 12
        vals = []
        for _ in range(ln):
            vals.append(int.from_bytes(data[off : off + es], "big") % modulus)
            off += es
        if ln != npub + nsec:
            raise ValueError("invalid witness: length mismatch")
        return cls(npub, nsec, vals, modulus)

    @classmethod
    def from_assignment(cls, cs, assignment: dict) -> "Witness":
        """cs: ConstraintSystem or SparseConstraintSystem (finalized)."""
        pub_names = list(cs.public_names)
        if pub_names and pub_names[0] == "1":  # R1CS constant wire is implicit
            pub_names = pub_names[1:]
        vals = [int(assignment[n]) % cs.modulus for n in pub_names]
        vals += [int(assignment[n]) % cs.modulus for n in cs.secret_names]
        return cls(len(pub_names), len(cs.secret_names), vals, cs.modulus)

    def to_assignment(self, cs) -> dict:
        pub_names = list(cs.public_names)
        if pub_names and pub_names[0] == "1":
            pub_names = pub_names[1:]
        names = pub_names + list(cs.secret_names)
        assert len(names) == len(self.values)
        return dict(zip(names, self.values))
