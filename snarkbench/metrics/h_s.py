"""h_s: seconds per proof of the quotient H: the NTTs of `poly/ntt.py` (`compute_h_dev`): the prove's own
phase time ``h`` (``prove(timings=)``, which synchronises the card
between phases) summed over the traced run's window, over its proofs."""


def read(run):
    w = run["window"]
    if not w["phases"] or "h" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["h"] / len(w["latencies"])
