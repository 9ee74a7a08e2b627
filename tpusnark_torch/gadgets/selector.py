"""Selector gadgets: mux / map / partition over circuit values.

Mirrors gnark/std/selector/ (Mux :doc, Map, stepMask): Mux(sel,
in...) returns in[sel], proven with a one-hot indicator vector derived from
is_zero comparisons.

The port's copy of tpusnark/gadgets/selector.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations


def mux(api, sel, *inputs):
    """inputs[sel]; sel out of range is unsatisfiable."""
    out = 0
    total = 0
    for i, v in enumerate(inputs):
        ind = api.is_zero(api.sub(sel, i))  # 1 iff sel == i
        total = api.add(total, ind)
        out = api.add(out, api.mul(ind, v))
    api.assert_is_equal(total, 1)  # sel in range
    return out


def map_lookup(api, query_key, keys, values):
    """Map: value whose key equals query_key (keys must contain it).
    reference: std/selector Map."""
    out = 0
    total = 0
    for k, v in zip(keys, values):
        ind = api.is_zero(api.sub(query_key, k))
        total = api.add(total, ind)
        out = api.add(out, api.mul(ind, v))
    api.assert_is_equal(total, 1)
    return out


def is_in_slice(api, needle, haystack):
    """1 iff needle appears in haystack (boolean output)."""
    found = 0
    for v in haystack:
        ind = api.is_zero(api.sub(needle, v))
        # found OR ind without double counting: found + ind - found*ind
        found = api.sub(api.add(found, ind), api.mul(found, ind))
    return found
