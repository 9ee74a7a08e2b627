"""Host utilities of the port (copies of tpusnark/utils modules)."""
