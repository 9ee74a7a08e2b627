"""prove_p90_s: the 90th percentile of the latencies of every proof completed
in the window, each from the request's hand-off to the proof's return
(``statistics.quantiles(n=10)``, exclusive method). Host clock."""

import statistics


def read(run):
    lat = run["window"]["latencies"]
    return statistics.quantiles(lat, n=10)[8] if len(lat) >= 2 else None
