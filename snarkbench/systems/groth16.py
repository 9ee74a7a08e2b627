"""The Groth16 prover of the port as the system under test: set-up, one
request, and the reference's judge of its answers.

The entry the window drives is ``tpusnark_torch.backend.groth16.prove(cs,
pk, assignment, rng=...)`` on the card; ``pk`` comes from
``tpusnark_torch.backend.groth16.setup(cs, rng=...)`` with the benchmark's
seeded draws. A proof is judged by ``reference/groth16.py`` with the same
draws and the reference's own compile of the circuit, and the program's
compile by its digest against the reference's.
"""

from __future__ import annotations

import hashlib

from snarkbench.reference.groth16 import TrapdoorVerifier

# the program's functions that traced runs wrap in spans (module, attribute,
# span): the spans only label what the host did while the card idled
SPANS = (
    ("tpusnark_torch.backend.groth16.prove", "solve_any", "solve"),
    ("tpusnark_torch.constraint.solver_torch", "LevelSolver._run_hints", "solve.hint_sync"),
    ("tpusnark_torch.backend.groth16.prove", "abc_evaluator", "encode"),
    ("tpusnark_torch.backend.groth16.prove", "compute_h_dev", "h"),
    ("tpusnark_torch.backend.groth16.prove", "g1_from_device_proj", "assemble.decode"),
    ("tpusnark_torch.backend.groth16.prove", "g2_from_device_proj", "assemble.decode"),
)


def keygen(cs, cfg, draw, device):
    """The proving key, made on `device` from the draws of `draw`."""
    from tpusnark_torch.backend.groth16 import setup

    pk, _vk = setup(cs, rng=draw, device=device, curve=cfg["curve"])
    return pk


def prove(cs, pk, assignment: dict, draw, device, timings=None):
    from tpusnark_torch.backend.groth16 import prove as prove_

    return prove_(cs, pk, assignment, rng=draw, timings=timings, device=device)


def answer(proof):
    """The proof as plain ints: (A, B, C), B's coordinates over Fp2 as
    (c0, c1) pairs."""
    bs = None if proof.bs is None else tuple((v.c0, v.c1) for v in proof.bs)
    return (proof.ar, bs, proof.krs)


def r1cs_digest(cs, side: str) -> str:
    """A digest that two compiles of one statement share: the public and
    secret names, the number of wires, and each constraint's three sides as
    sorted (coefficient, wire) terms, the wires in the finalized order (the
    constant one, publics, secrets, internals). `side` is "program" (the
    port's compile, finalized) or "reference" (``reference/frontend``'s)."""
    h = hashlib.sha256(repr((list(cs.public_names), list(cs.secret_names), cs.n_wires)).encode())
    coeff = [c.to_bytes(32, "little") for c in cs.coeffs]
    if side == "program":
        rows, wire = ((k.L, k.R, k.O) for k in cs.constraints), range(cs.n_wires)
    else:
        order = {"pub": 0, "sec": 1, "int": 2}
        wire = [0] * cs.n_wires
        for new, old in enumerate(sorted(range(cs.n_wires), key=lambda w: (order[cs.kinds[w]], w))):
            wire[old] = new
        rows = cs.constraints
    for row in rows:
        for side_terms in row:
            terms = sorted([coeff[c] + wire[v].to_bytes(4, "little") for c, v in side_terms])
            h.update(len(terms).to_bytes(4, "little"))
            h.update(b"".join(terms))
    return h.hexdigest()


class Judge:
    """Checks answers of one circuit under the keys of `draws`: `rcs` the
    reference's compile of it."""

    def __init__(self, rcs, draws):
        self.public_names = rcs.public_names[1:]
        self.verifier = TrapdoorVerifier(rcs.public_columns(), len(rcs.constraints), draws)
        self.digest = r1cs_digest(rcs, "reference")

    def check(self, answer_, statement: dict) -> str | None:
        return self.verifier.check(answer_, [statement[name] for name in self.public_names])
