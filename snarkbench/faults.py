"""Faults planted under the timed path, for the tests and the control: each
wraps the harness's `serve` (one request to the program), or edits the
program's compiled circuit before its keys are made, so that the run's
answers come out wrong in one way, and the check has to say so.

- ``stale``: a step that returns its state unchanged: every request after
  the first gets the proof of the request before it;
- ``half``: half of the batch left out: every MSM sees only the first half
  of its scalars (the rest zero);
- ``altered``: an answer altered where it is produced: each proof's A moved
  by the generator of G1;
- ``truncate`` (the control): the cheap step a prover is tempted by, most of
  whose scalars are small: every MSM keeps only the low 128 bits of each
  scalar;
- ``weakened``: a compile that proves less: the last assertion that touches
  no public input (the constant one aside) becomes 0 * 0 = 0, so the proofs still verify for the same
  public values.
"""

from __future__ import annotations

import dataclasses
import functools

from snarkbench.trace import wrapped

_MSM = (
    ("tpusnark_torch.msm.pippenger", "MSM.__call__", None),
    ("tpusnark_torch.msm.pippenger", "MSM.many", None),
)


def _msm_scalars(change):
    def wrap(fn, _label):
        @functools.wraps(fn)
        def inner(engine, points, scalars):
            return fn(engine, points, change(scalars))

        return inner

    def wrap_serve(serve):
        def inner(*args, **kwargs):
            with wrapped(_MSM, wrap):
                return serve(*args, **kwargs)

        return inner

    return wrap_serve


def _half(scalars):
    out = scalars.clone()
    out[..., out.shape[-1] // 2 :] = 0
    return out


def _truncate(scalars):
    out = scalars.clone()
    out[4:] = 0
    return out


def _stale(serve):
    last = []

    def inner(*args, **kwargs):
        out = serve(*args, **kwargs)
        prev = last[0] if last else out
        last[:] = [out]
        return prev

    return inner


def _altered(serve):
    from snarkbench.reference.bn254 import G1, G1_GEN

    def inner(*args, **kwargs):
        out = serve(*args, **kwargs)
        return dataclasses.replace(out, ar=G1.add(out.ar, G1_GEN))

    return inner


def _weakened(cs):
    for kind, idx, solved in reversed(cs.instructions):
        k = cs.constraints[idx] if kind == "r1c" and solved is None else None
        if k is not None and all(v == 0 or v >= cs.n_public for side in (k.L, k.R, k.O) for _, v in side):
            k.L, k.R, k.O = [], [], []
            return
    raise ValueError("the circuit has no assertion on private wires alone")


def _unchanged(x):
    return x


class Fault:
    def __init__(self, name: str):
        if name not in FAULTS:
            raise KeyError(f"unknown fault {name!r}: one of {sorted(FAULTS)}")
        self.name = name
        self.wrap_serve, self.edit_cs = FAULTS[name]


# name: (wrapper of serve, edit of the compiled circuit)
FAULTS = {
    "stale": (_stale, None),
    "half": (_msm_scalars(_half), None),
    "altered": (_altered, None),
    "truncate": (_msm_scalars(_truncate), None),
    "weakened": (_unchanged, _weakened),
}
