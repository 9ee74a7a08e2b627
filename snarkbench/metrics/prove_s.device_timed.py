"""prove_s.device_timed: ``prove_s`` (``prove_s.py``) in the cells whose
end-to-end time is the card's, ``prove_device_s``. Read in the traced run, whose
window synchronises the card between a prove's phases."""

from pathlib import Path

from snarkbench.harness import load_file

read = load_file(Path(__file__).with_name("prove_s.py"), "metric").read
