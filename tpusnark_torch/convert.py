"""State carried between tpusnark's layout and the port's.

tpusnark stores a field element as sixteen 16-bit limbs in a ``uint32``
array ``(16, *batch)``; the port as eight 32-bit words in an ``int32`` tensor
``(8, *batch)``. R = 2^256 in both, so the same bits mean the same value:
word k = limb 2k | limb 2k+1 << 16. These helpers take numpy arrays (or
anything ``np.asarray`` accepts, such as JAX arrays) on the tpusnark side, so
that both packages can compute on the same state in the tests.
"""

from __future__ import annotations

import numpy as np
import torch


def limbs_to_words(limbs) -> np.ndarray:
    """(16, *b) 16-bit limbs -> (8, *b) int32 words."""
    a = np.asarray(limbs).astype(np.uint32)
    words = a[0::2] | (a[1::2] << np.uint32(16))
    return np.ascontiguousarray(words).view(np.int32)


def words_to_limbs(words) -> np.ndarray:
    """(8, *b) words (tensor or array) -> (16, *b) uint32 16-bit limbs."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.asarray(words).view(np.uint32)
    out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


def to_torch(tree, device="cpu"):
    """tpusnark pytree (tuples of limb arrays; bool arrays are masks) -> the
    port's tensors on `device`."""
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(t, device) for t in tree)
    a = np.asarray(tree)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(limbs_to_words(a)).to(device)


def from_torch(tree):
    """The port's tensors -> tpusnark numpy pytree (limbs, bool masks)."""
    if isinstance(tree, (tuple, list)):
        return tuple(from_torch(t) for t in tree)
    if tree.dtype == torch.bool:
        return tree.detach().cpu().numpy()
    return words_to_limbs(tree)


def pk_tables(dev: dict, device="cpu") -> dict:
    """tpusnark's ``ProvingKey.device()`` dict -> the port's table dict."""
    return {name: to_torch(pts, device) for name, pts in dev.items()}
