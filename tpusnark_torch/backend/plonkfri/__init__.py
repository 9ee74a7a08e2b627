"""PlonkFRI: PLONK arithmetization with transparent FRI commitments (the
port's counterpart of tpusnark/backend/plonkfri).

The gnark/backend/plonkfri analog (bn254/{setup,prove,verify}.go):
same trace/permutation/quotient structure as the KZG PLONK backend but
commitments are Merkle roots over Reed-Solomon codewords and openings are
FRI proximity + spot checks — no trusted setup, hash-based security.

Like the reference's, this backend is the experimental/transparent tier: no
serialization or Solidity export, and (divergence, documented) no ZK blinding
and a MiMC-based Fiat-Shamir transcript rather than the reference's
fiat-shamir/SHA transcript. ``setup`` and ``prove`` take a device (the card
unless the caller names the CPU); ``verify`` runs on the host.
"""

from .scheme import (  # noqa: F401
    PlonkFriProof,
    PlonkFriProvingKey,
    PlonkFriVerifyingKey,
    prove,
    setup,
    verify,
)
