"""msm_s.device_timed: ``msm_s`` (``msm_s.py``) in the cells whose
end-to-end time is the card's, ``prove_device_s``."""

from pathlib import Path

from snarkbench.harness import load_file

read = load_file(Path(__file__).with_name("msm_s.py"), "metric").read
