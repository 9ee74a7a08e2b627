"""Device residency of Groth16 proving-key tables (counterpart of
tpusnark/backend/groth16/keys.py:ProvingKey.device).

The key containers are tpusnark's own (``Proof``, ``ProvingKey``,
``VerifyingKey``). The port keeps its tensors in a cache of its own on the
key object, per device, beside (not in) tpusnark's ``_dev`` cache.
"""

from __future__ import annotations

from tpusnark.curves.config import get_curve

from ... import _host, kernels
from ...curves.encoding import g1_to_device, g2_to_device
from ...fields.tfield import canonical_device, get_field

Proof = _host.keys.Proof
ProvingKey = _host.keys.ProvingKey
VerifyingKey = _host.keys.VerifyingKey

_ATTR = "_torch_tables"


def ported_curve(name: str):
    """tpusnark's CurveConfig of `name`, if the port has its kernels."""
    if name not in kernels.CURVES:
        raise NotImplementedError(
            f"curve {name}: its kernels are not ported (ported: {', '.join(kernels.CURVES)})"
        )
    return get_curve(name)


def _cache(pk) -> dict:
    return pk.__dict__.setdefault(_ATTR, {})


def set_device_tables(pk, device, tables: dict) -> None:
    """Install tables (a, b1, b2, k, z as affine (X, Y, inf)) for `device`."""
    _cache(pk)[str(canonical_device(device))] = tables


def device_tables(pk, device) -> dict:
    """Point tables of pk on `device`, encoded from the host points once
    over the base field of pk's curve."""
    cfg = ported_curve(pk.curve)
    key = str(canonical_device(device))
    cache = _cache(pk)
    if key not in cache:
        fp = get_field(cfg.fp_spec)
        cache[key] = {
            "a": g1_to_device(pk.a, fp, device),
            "b1": g1_to_device(pk.b1, fp, device),
            "b2": g2_to_device(pk.b2, fp, device),
            "k": g1_to_device(pk.k, fp, device),
            "z": g1_to_device(pk.z, fp, device),
        }
    return cache[key]
