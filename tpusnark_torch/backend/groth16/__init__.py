"""Groth16 over BN254 on torch tensors: setup and prove. Verification is
tpusnark's host verifier (``tpusnark_torch._host.verify.verify``)."""

from .keys import Proof, ProvingKey, VerifyingKey
from .prove import compute_h_dev, prove
from .setup import setup

__all__ = ["Proof", "ProvingKey", "VerifyingKey", "compute_h_dev", "prove", "setup"]
