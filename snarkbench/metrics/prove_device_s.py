"""prove_device_s: seconds per proof in which an operation ran on the card:
the union of the device trace's kernel, copy and set intervals over the
whole window (profiled, the card's activity alone), over the proofs
completed in it. The card time a proof holds; unlike ``prove_s`` it does
not move with the speed of the shared host."""


def read(run):
    w = run["window"]
    busy = w.get("busy_s")
    return busy / len(w["latencies"]) if busy and w["latencies"] else None
