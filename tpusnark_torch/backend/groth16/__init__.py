"""Groth16 on torch tensors over the seven curves of the reference:
setup, prove and the host verifier ``verify(proof, vk, public_inputs,
curve=...)`` (for BLS12-381 also ``bls381.verify``, checked against
bellman's fixtures); over BN254 the MPC ceremony (``mpcsetup``), gnark's
byte layout of proofs and keys (``marshal``) and the Solidity verifier
(``export_solidity``, ``proof_to_solidity_calldata``)."""

from . import mpcsetup
from .keys import Proof, ProvingKey, VerifyingKey
from .prove import compute_h_dev, prove
from .setup import setup
from .solidity import export_solidity, proof_to_solidity_calldata
from .verify import InvalidProofError, verify

__all__ = [
    "InvalidProofError",
    "Proof",
    "ProvingKey",
    "VerifyingKey",
    "compute_h_dev",
    "export_solidity",
    "mpcsetup",
    "proof_to_solidity_calldata",
    "prove",
    "setup",
    "verify",
]
