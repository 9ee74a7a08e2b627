"""solve_levels_s: seconds per proof of the device solver's level launches
(`constraint/solver_torch.py`, its ``_run_level`` calls): the key
``solve_levels`` that the device solver adds to ``prove(timings=)``, host
seconds with no synchronise of their own, summed over the traced run's
window, over its proofs. None where the program writes no such key (the
host solver's branch, or a program without it)."""


def read(run):
    w = run["window"]
    if not w["phases"] or "solve_levels" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["solve_levels"] / len(w["latencies"])
