"""solve_s: seconds per proof of the witness solve (`constraint/solver_torch.py` or the host solver, by `solve_any`): the prove's own
phase time ``solve`` (``prove(timings=)``, which synchronises the card
between phases) summed over the traced run's window, over its proofs."""


def read(run):
    w = run["window"]
    if not w["phases"] or "solve" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["solve"] / len(w["latencies"])
