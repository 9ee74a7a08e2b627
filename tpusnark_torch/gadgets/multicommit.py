"""Commitment expansion: the std/multicommit analog.

Reference: gnark/std/multicommit/nativecommit.go — builders only
support ONE api.commit() per circuit, which breaks composition when several
gadgets each need in-circuit randomness (log-derivative lookups, GKR
initial challenges, ...). The fix, as in the reference: collect every
(variables, callback) registration, emit a single commitment over ALL
collected variables in a deferred pass, and hand each callback a UNIQUE
derived commitment (here MiMC(commitment, callback_index); the reference
squares/multiplies the master commitment per callback — any domain
separation works since it only needs uniqueness under the random oracle).

The port's copy of tpusnark/gadgets/multicommit.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from ..hashes.mimc import MiMCGadget

_STATE_ATTR = "_tpusnark_multicommit"


class _State:
    def __init__(self):
        self.vars: list = []
        self.cbs: list = []
        self.closed = False


def with_commitment(api, callback, *variables):
    """Register `callback(api, commitment)` to be invoked at compile time
    with a commitment unique to this call, derived from one api.commit()
    over every registered variable (gnark multicommit.WithCommitment)."""
    st = getattr(api, _STATE_ATTR, None)
    if st is None:
        st = _State()
        setattr(api, _STATE_ATTR, st)

        def finalize(a):
            assert not st.closed
            st.closed = True
            master = a.commit(*st.vars)
            for i, cb in enumerate(st.cbs):
                h = MiMCGadget(a)
                h.write(master, i)
                cb(a, h.sum())

        api.defer_(finalize)
    assert not st.closed, "multicommit already finalized (compile started)"
    assert variables, "commitment needs at least one variable"
    st.vars.extend(variables)
    st.cbs.append(callback)
