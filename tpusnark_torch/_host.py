"""tpusnark's JAX-free host modules that sit under tpusnark.backend.groth16.

``keys.py``, ``setup.py`` (its host helpers), ``verify.py`` and
``bls381.py`` (the BLS12-381 verifier checked against bellman's fixtures)
import no JAX, but importing them through their package runs
``tpusnark/backend/groth16/__init__.py``, which imports the JAX prover (and,
where JAX finds a GPU, starts a JAX client on it). So unless that package is
already loaded, a bare package module with the right ``__path__`` stands in
for it while the submodules load, and is removed again. The submodules
stay registered under their full names: a later ``import
tpusnark.backend.groth16`` runs the real ``__init__``, which reuses them, so
both packages share one ``ProvingKey`` class.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

_PKG = "tpusnark.backend.groth16"
_NAMES = ("keys", "setup", "verify", "bls381")


def _load():
    if _PKG in sys.modules:
        return [importlib.import_module(f"{_PKG}.{n}") for n in _NAMES]
    import tpusnark.backend as backend

    bare = types.ModuleType(_PKG)
    bare.__path__ = [os.path.join(os.path.dirname(backend.__file__), "groth16")]
    bare.__package__ = _PKG
    sys.modules[_PKG] = bare
    try:
        return [importlib.import_module(f"{_PKG}.{n}") for n in _NAMES]
    finally:
        if sys.modules.get(_PKG) is bare:
            del sys.modules[_PKG]


keys, setup, verify, bls381 = _load()
