"""assemble_s: seconds per proof of the proof's decode and host assembly (`backend/groth16/prove.py`): the prove's own
phase time ``assemble`` (``prove(timings=)``, which synchronises the card
between phases) summed over the traced run's window, over its proofs."""


def read(run):
    w = run["window"]
    if not w["phases"] or "assemble" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["assemble"] / len(w["latencies"])
