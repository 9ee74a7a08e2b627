"""keygen_s: seconds of the seeded keygen (``backend/groth16/setup.py``) in
set-up, the card synchronised at its end. Host clock."""


def read(run):
    return run["setup"]["keygen_s"]
