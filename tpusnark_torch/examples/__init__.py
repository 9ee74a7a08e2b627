"""The port's counterparts of the repo's top-level ``examples/``: gnark's
examples (cubic, exponentiate, MiMC, PLONK) and the toy zk-rollup, proved
on the card through ``tpusnark_torch``'s Groth16 or PLONK unless the caller
names the CPU. Run one with ``python3 -m tpusnark_torch.examples.<name>``."""
