"""launches_per_proof.device_timed: ``launches_per_proof`` (``launches_per_proof.py``) in the cells whose
end-to-end time is the card's, ``prove_device_s``."""

from pathlib import Path

from snarkbench.harness import load_file

read = load_file(Path(__file__).with_name("launches_per_proof.py"), "metric").read
