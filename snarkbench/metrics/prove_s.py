"""prove_s: seconds per proof: the window's seconds (to the return of its
last proof) over the proofs completed in it. Host clock."""


def read(run):
    w = run["window"]
    return w["seconds"] / len(w["latencies"]) if w["latencies"] else None
