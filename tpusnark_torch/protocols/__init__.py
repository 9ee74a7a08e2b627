"""Interactive-proof protocol building blocks: multilinear extensions,
sumcheck, and GKR (the std/sumcheck + std/gkr + constraint/gkr.go analogs).

The port's copy of tpusnark/protocols/__init__.py: same code, imports inside tpusnark_torch.
"""
