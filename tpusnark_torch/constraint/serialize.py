"""Constraint-system serialization.

gnark serializes compiled systems with CBOR
(gnark/constraint/bn254/system.go:149-160 WriteTo/ReadFrom) so the
compile -> setup -> prove pipeline can restart from artifacts (SURVEY.md §5
checkpoint/resume). Here: a versioned JSON-able dict + a compact binary
container. Hints serialize by registry name (constraint/hints.py) — the
loader re-binds them, like gnark's solver.GetRegisteredHint.

The port's copy of tpusnark/constraint/serialize.py: same code, imports
inside tpusnark_torch, but for the hint names. A hint's registry name is its
module path, which differs between the two packages, so the serialized form
names a hint as the reference package does ("tpusnark.constraint.hints.
inv_hint" for the port's ``tpusnark_torch.constraint.hints.inv_hint``):
``register_hint`` and ``get_hint`` below map the port's names to that form
and back, so that either package loads the other's bytes and a system
dumps to the same bytes from both.
"""

from __future__ import annotations

import json
import zlib

from . import hints
from .scs import Gate, SparseConstraintSystem
from .system import ConstraintSystem, Hint, R1C

MAGIC = b"TPUSNARK-CS1"

_PORT, _FORMAT = __name__.split(".")[0] + ".", "tpusnark."


def register_hint(fn) -> str:
    """hints.register_hint, with the name in the serialized form."""
    key = hints.register_hint(fn)
    return _FORMAT + key[len(_PORT) :] if key.startswith(_PORT) else key


def get_hint(name: str):
    """hints.get_hint of a name in the serialized form."""
    return hints.get_hint(_PORT + name[len(_FORMAT) :] if name.startswith(_FORMAT) else name)


def r1cs_to_dict(cs: ConstraintSystem) -> dict:
    insts = []
    for inst in cs.instructions:
        if inst[0] == "r1c":
            insts.append(["r1c", inst[1], inst[2]])
        else:
            h = inst[1]
            insts.append(
                ["hint", register_hint(h.fn), [list(map(list, e)) for e in h.inputs], h.outputs]
            )
    return {
        "kind": "r1cs",
        "modulus": str(cs.modulus),
        "coeffs": [str(c) for c in cs.coeffs],
        "wire_kind": cs._wire_kind,
        "public_names": cs.public_names,
        "secret_names": cs.secret_names,
        "constraints": [[c.L, c.R, c.O] for c in cs.constraints],
        "instructions": insts,
        "finalized": cs._finalized,
        "commitments": [
            [
                cm.public_and_commitment_committed,
                cm.nb_public_committed,
                cm.private_committed,
                cm.commitment_index,
            ]
            for cm in cs.commitments
        ],
    }


def r1cs_from_dict(d: dict) -> ConstraintSystem:
    assert d["kind"] == "r1cs"
    cs = ConstraintSystem(int(d["modulus"]))
    cs.coeffs = [int(c) for c in d["coeffs"]]
    cs._coeff_ids = {c: i for i, c in enumerate(cs.coeffs)}
    cs._wire_kind = list(d["wire_kind"])
    cs.public_names = list(d["public_names"])
    cs.secret_names = list(d["secret_names"])
    cs.constraints = [
        R1C([tuple(t) for t in L], [tuple(t) for t in R], [tuple(t) for t in O])
        for L, R, O in d["constraints"]
    ]
    cs.instructions = []
    cs.wire_def = {}
    for i, inst in enumerate(d["instructions"]):
        if inst[0] == "r1c":
            cs.instructions.append(("r1c", inst[1], inst[2]))
            if inst[2] is not None:
                cs.wire_def[inst[2]] = i
        else:
            _, name, inputs, outputs = inst
            h = Hint(get_hint(name), [[tuple(t) for t in e] for e in inputs], list(outputs))
            cs.instructions.append(("hint", h, None))
            for w in outputs:
                cs.wire_def[w] = i
    cs.debug_info = [None] * len(cs.instructions)
    from .system import Groth16Commitment

    cs.commitments = [
        Groth16Commitment(
            public_and_commitment_committed=list(pc),
            nb_public_committed=int(nbp),
            private_committed=list(pv),
            commitment_index=int(ci),
        )
        for pc, nbp, pv, ci in d.get("commitments", [])
    ]
    cs._finalized = bool(d["finalized"])
    return cs


def scs_to_dict(cs: SparseConstraintSystem) -> dict:
    insts = []
    for inst in cs.instructions:
        if inst[0] == "gate":
            insts.append(["gate", inst[1], inst[2]])
        else:
            h = inst[1]
            insts.append(["hint", register_hint(h.fn), [list(t) for t in h.inputs], h.outputs])
    return {
        "kind": "scs",
        "modulus": str(cs.modulus),
        "coeffs": [str(c) for c in cs.coeffs],
        "wire_kind": cs._wire_kind,
        "public_names": cs.public_names,
        "secret_names": cs.secret_names,
        "gates": [[g.xa, g.xb, g.xc, g.qL, g.qR, g.qO, g.qM, g.qC] for g in cs.gates],
        "instructions": insts,
        "finalized": cs._finalized,
    }


def scs_from_dict(d: dict) -> SparseConstraintSystem:
    assert d["kind"] == "scs"
    cs = SparseConstraintSystem(int(d["modulus"]))
    cs.coeffs = [int(c) for c in d["coeffs"]]
    cs._coeff_ids = {c: i for i, c in enumerate(cs.coeffs)}
    cs._wire_kind = list(d["wire_kind"])
    cs.public_names = list(d["public_names"])
    cs.secret_names = list(d["secret_names"])
    cs.gates = [Gate(*g) for g in d["gates"]]
    cs.instructions = []
    for inst in d["instructions"]:
        if inst[0] == "gate":
            cs.instructions.append(("gate", inst[1], inst[2]))
        else:
            _, name, inputs, outputs = inst
            h = Hint(get_hint(name), [tuple(t) for t in inputs], list(outputs))
            cs.instructions.append(("hint", h, None))
    cs.debug_info = [None] * len(cs.instructions)
    cs._finalized = bool(d["finalized"])
    return cs


def dump(cs) -> bytes:
    d = r1cs_to_dict(cs) if isinstance(cs, ConstraintSystem) else scs_to_dict(cs)
    return MAGIC + zlib.compress(json.dumps(d).encode(), level=6)


def load(data: bytes):
    if not data.startswith(MAGIC):
        raise ValueError("not a tpusnark constraint system")
    d = json.loads(zlib.decompress(data[len(MAGIC) :]))
    return r1cs_from_dict(d) if d["kind"] == "r1cs" else scs_from_dict(d)
