"""Carry parameters across from the JAX package.

``from_numpy_tree`` takes the reference's GPT parameter tree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the caller's
side) and returns the port's tree.  The layouts are the same leaf for leaf
(stacked ``[L, ...]`` block leaves, ``qkv`` as ``(L, 3, h, h)``), so the
conversion is one copy per leaf and both packages compute the same function.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from metis_tpu_torch.core.device import resolve_device


def from_numpy_tree(tree: Mapping, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """Nested mapping of numpy arrays -> nested dict of tensors on ``device``
    (``dtype`` casts every leaf; None keeps each leaf's own)."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = from_numpy_tree(leaf, device, dtype)
        else:
            t = torch.from_numpy(np.array(leaf, copy=True))
            out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out
