"""encode_s: seconds per proof of the A/B/C evaluation and the witness's conversion (`constraint/eval_torch.py`): the prove's own
phase time ``encode`` (``prove(timings=)``, which synchronises the card
between phases) summed over the traced run's window, over its proofs."""


def read(run):
    w = run["window"]
    if not w["phases"] or "encode" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["encode"] / len(w["latencies"])
