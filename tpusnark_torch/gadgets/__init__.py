"""Standard gadget library: circuit-level building blocks written against
the builder API (works with both the R1CS Builder and the PlonkBuilder).

The TPU framework's analog of gnark's std/ (SURVEY.md §2.8). In scope for
the rollup config: MiMC (hashes/), twisted Edwards + EdDSA, Merkle proofs.

The port's copy of tpusnark/gadgets/__init__.py: same code.
"""
