"""Evaluation of every constraint's linear expressions on the device
(counterpart of tpusnark/constraint/eval_jax.py:ABCEvaluator).

A_i = L_i(W), B_i = R_i(W), C_i = O_i(W) for all constraints i: a gather of
coefficient words, a gather of wire words, one batched Montgomery product (B1)
and one modular segment sum per vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tfield import Field, compute_device


class ABCEvaluator:
    """Bound to one ConstraintSystem, field and device (the card unless the
    caller names the CPU).

    __call__(w_mont) -> (A, B, C), each (words, n_constraints) Montgomery,
    for w_mont (words, n_wires) Montgomery words on the same device. The
    segment sums hold at any word count: a column sums at most 2^16 words
    < 2^32 (Field.segment_sum)."""

    def __init__(self, cs, field: Field, device="cuda"):
        self.field = field
        self.n_constraints = len(cs.constraints)
        self.device = compute_device(device)
        self.coeffs = field.encode(cs.coeffs, mont=True, device=self.device)
        self.parts = {}
        for name, (rows, cids, vids) in cs.term_arrays().items():
            max_seg = int(np.bincount(rows, minlength=1).max()) if rows.size else 1
            self.parts[name] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(self.device) for a in (rows, cids, vids)
            ) + (max_seg,)

    def _one(self, w, rows, cids, vids, max_seg):
        f = self.field
        if rows.shape[0] == 0:
            return f.zeros((self.n_constraints,), device=w.device)
        prod = f.mul(self.coeffs[:, cids], w[:, vids])
        return f.segment_sum(prod, rows, self.n_constraints, max_segment=max_seg)

    def __call__(self, w_mont):
        return tuple(self._one(w_mont, *self.parts[name]) for name in ("L", "R", "O"))


def abc_evaluator(cs, field: Field, device="cuda") -> ABCEvaluator:
    """Evaluator cached on the constraint system, per field and device (the
    card unless the caller names the CPU)."""
    cache = cs.__dict__.setdefault("_torch_abc_cache", {})
    key = (field.spec.name, str(compute_device(device)))
    ev = cache.get(key)
    if ev is None:
        ev = cache[key] = ABCEvaluator(cs, field, device)
    return ev
