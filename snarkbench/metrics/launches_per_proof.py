"""launches_per_proof: the port's kernel launches a proof
(``kernels.LAUNCHES``, counted at the kernel wrappers) over the traced run's
window, over its proofs."""


def read(run):
    w = run["window"]
    if w["launches"] is None or not w["latencies"]:
        return None
    return w["launches"] / len(w["latencies"])
