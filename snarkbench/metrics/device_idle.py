"""device_idle: the share, in %, of the profiled proofs' wall time in which no
operation ran on the card: 100 (1 - busy / wall), busy the union of the
trace's kernel, copy and set intervals."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
