"""msm_s: seconds per proof of the five MSMs (`msm/pippenger.py`): the prove's own
phase time ``msm`` (``prove(timings=)``, which synchronises the card
between phases) summed over the traced run's window, over its proofs."""


def read(run):
    w = run["window"]
    if not w["phases"] or "msm" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["msm"] / len(w["latencies"])
