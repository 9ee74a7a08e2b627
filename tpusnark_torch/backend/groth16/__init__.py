"""Groth16 on torch tensors over BN254 and BLS12-381: setup and prove.
Verification is tpusnark's host verifier
(``tpusnark_torch._host.verify.verify(..., curve=...)``; for BLS12-381 also
``tpusnark_torch._host.bls381.verify``)."""

from .keys import Proof, ProvingKey, VerifyingKey
from .prove import compute_h_dev, prove
from .setup import setup

__all__ = ["Proof", "ProvingKey", "VerifyingKey", "compute_h_dev", "prove", "setup"]
