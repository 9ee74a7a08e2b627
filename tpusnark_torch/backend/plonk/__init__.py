"""PLONK(+KZG) backend over BN254 on torch tensors (counterpart of
tpusnark/backend/plonk): setup and prove on the card unless the caller
names the CPU, the verifier on the host.

Reference: gnark/backend/plonk/ (dispatcher plonk.go, per-curve
setup.go/prove.go/verify.go). See keys.py for the proof format.
"""

from .keys import PlonkProof, PlonkProvingKey, PlonkVerifyingKey
from .prove import prove
from .setup import setup
from .verify import verify

__all__ = [
    "PlonkProof",
    "PlonkProvingKey",
    "PlonkVerifyingKey",
    "prove",
    "setup",
    "verify",
]
