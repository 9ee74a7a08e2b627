"""Test helpers of the port (copies of tpusnark/testing modules)."""
