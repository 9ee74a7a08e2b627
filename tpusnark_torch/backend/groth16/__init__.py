"""Groth16 on torch tensors over BN254, BLS12-381, BLS12-377 and BW6-761:
setup, prove and the host verifier ``verify(proof, vk, public_inputs,
curve=...)`` (for BLS12-381 also ``bls381.verify``, checked against
bellman's fixtures)."""

from .keys import Proof, ProvingKey, VerifyingKey
from .prove import compute_h_dev, prove
from .setup import setup
from .verify import InvalidProofError, verify

__all__ = [
    "InvalidProofError",
    "Proof",
    "ProvingKey",
    "VerifyingKey",
    "compute_h_dev",
    "prove",
    "setup",
    "verify",
]
