"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and hands the program its requests.

It serves a closed loop with one request outstanding (``"loop":
"closed"``, the only parameter; the prove entry is called from one
thread): the next request is made and handed over when the last proof has
come back, and its latency runs from that hand-off. Each request carries
the configuration's next input, so no input repeats in a window.
"""

from __future__ import annotations

import time


class Traffic:
    def __init__(self, params: dict):
        if params.get("loop") != "closed" or set(params) - {"loop", "why"}:
            raise ValueError(f"this generator serves a closed loop with one request outstanding, not {params!r}")

    def run(self, serve, requests, seconds: float, clock=time.perf_counter):
        """Serve requests for `seconds`: serve(input) -> result, each input
        the next of the iterator `requests`. Returns (records, window
        seconds): records (input, latency seconds, result or the exception
        raised), for every request handed over before the window closed;
        the window ends when the last of them has come back."""
        records = []
        t0 = clock()
        while not records or clock() - t0 < seconds:
            x = next(requests)
            start = clock()
            try:
                out = serve(x)
            except Exception as e:  # a failed request is recorded, and the run goes on
                out = e
            records.append((x, clock() - start, out))
        return records, clock() - t0
