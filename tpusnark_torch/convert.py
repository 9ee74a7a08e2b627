"""State carried between tpusnark's layout and the port's.

tpusnark stores an element of a field with n 16-bit limbs as a ``uint32``
array ``(n, *batch)`` in Montgomery form with R = 2^(16 n); the port as
ceil(n / 2) 32-bit words in an ``int32`` tensor ``(words, *batch)`` with
R = 2^(32 words). Where n is even (BN254: 16 limbs, BLS12-381 fp: 24) the
two R agree, so the same bits mean the same value and a word is two limbs:
word k = limb 2k | limb 2k+1 << 16. Where n is odd (BLS12-381 fr: 17 limbs,
R = 2^272 against the port's 2^288) the value is re-encoded: x R_t mod p
becomes x R_port mod p = (x R_t) * 2^16 mod p, and back. These helpers take
numpy arrays (or anything ``np.asarray`` accepts, such as JAX arrays) on the
tpusnark side, so that both packages can compute on the same state in the
tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.spec import FieldSpec, ints_to_limbs, limbs_to_ints
from .fields.tfield import ints_to_words, n_words


def limbs_to_words(limbs, spec: FieldSpec) -> np.ndarray:
    """(n_limbs, *b) tpusnark Montgomery limbs -> (words, *b) int32 words."""
    a = np.asarray(limbs).astype(np.uint32)
    if spec.n_limbs % 2 == 0:
        words = a[0::2] | (a[1::2] << np.uint32(16))
        return np.ascontiguousarray(words).view(np.int32)
    p = spec.modulus
    vals = limbs_to_ints(np.moveaxis(a, 0, -1))  # x * 2^(16 n) mod p, lazy
    shift = 1 << (32 * n_words(spec) - 16 * spec.n_limbs)
    words = ints_to_words(spec, [v * shift % p for v in vals], mont=False)
    return words.reshape((words.shape[0],) + a.shape[1:])


def words_to_limbs(words, spec: FieldSpec) -> np.ndarray:
    """(words, *b) words (tensor or array) -> (n_limbs, *b) uint32 limbs."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.asarray(words).view(np.uint32)
    if spec.n_limbs % 2 == 0:
        out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
        out[0::2] = w & np.uint32(0xFFFF)
        out[1::2] = w >> np.uint32(16)
        return out
    p = spec.modulus
    b = np.ascontiguousarray(np.moveaxis(w, 0, -1).astype("<u4")).tobytes()
    step = 4 * w.shape[0]
    unshift = pow(1 << (32 * n_words(spec) - 16 * spec.n_limbs), -1, p)
    vals = [int.from_bytes(b[i : i + step], "little") * unshift % p for i in range(0, len(b), step)]
    limbs = ints_to_limbs(vals, spec.n_limbs)  # (N, n_limbs)
    return np.ascontiguousarray(np.moveaxis(limbs.reshape(w.shape[1:] + (spec.n_limbs,)), -1, 0))


def to_torch(tree, spec: FieldSpec, device="cpu"):
    """tpusnark pytree over `spec` (tuples of limb arrays; bool arrays are
    masks) -> the port's tensors on `device`."""
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(t, spec, device) for t in tree)
    a = np.asarray(tree)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(limbs_to_words(a, spec)).to(device)


def from_torch(tree, spec: FieldSpec):
    """The port's tensors over `spec` -> tpusnark numpy pytree (limbs, bool
    masks)."""
    if isinstance(tree, (tuple, list)):
        return tuple(from_torch(t, spec) for t in tree)
    if tree.dtype == torch.bool:
        return tree.detach().cpu().numpy()
    return words_to_limbs(tree, spec)


def pk_tables(dev: dict, fp_spec: FieldSpec, device="cpu") -> dict:
    """tpusnark's ``ProvingKey.device()`` dict (points over the base field
    `fp_spec`) -> the port's table dict."""
    return {name: to_torch(pts, fp_spec, device) for name, pts in dev.items()}
