"""solve_hints_s: seconds per proof of the device solver's hint round trips
(`constraint/solver_torch.py`, its ``_run_hints`` calls: the inputs'
launches, the wait, the decode, the hints run on the host and the encode):
the key ``solve_hints`` that the device solver adds to ``prove(timings=)``,
summed over the traced run's window, over its proofs. None where the
program writes no such key (the host solver's branch, or a program without
it)."""


def read(run):
    w = run["window"]
    if not w["phases"] or "solve_hints" not in w["phases"] or not w["latencies"]:
        return None
    return w["phases"]["solve_hints"] / len(w["latencies"])
