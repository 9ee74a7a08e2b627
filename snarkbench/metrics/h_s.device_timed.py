"""h_s.device_timed: ``h_s`` (``h_s.py``) in the cells whose
end-to-end time is the card's, ``prove_device_s``."""

from pathlib import Path

from snarkbench.harness import load_file

read = load_file(Path(__file__).with_name("h_s.py"), "metric").read
