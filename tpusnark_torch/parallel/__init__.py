"""Sharding of the prover's hot paths over a list of devices (counterpart of
tpusnark/parallel)."""
