"""Carry parameters across from the JAX package.

``from_numpy_tree`` takes the reference's parameter tree of any family (GPT,
LLaMA, MoE) with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)`` on the caller's side) and returns the port's tree.  The layouts are
the same leaf for leaf (stacked ``[L, ...]`` block leaves, ``qkv`` as ``(L,
3, h, h)``, ``wkv`` as ``(L, 2, h, kvh * hd)``, experts as ``(L, E, ...)``), so
the conversion is one copy per leaf and both packages compute the same
function.  Given a spec tree (``execution.train.param_specs_for``) and this
rank's coordinates it returns the rank's slices instead, so a sharded run
starts from the same weights as the JAX package's.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.sharding import slice_leaf


def from_numpy_tree(tree: Mapping, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None,
                    specs: Mapping | None = None,
                    slots: Mapping[str, tuple[int, int]] | None = None) -> dict:
    """Nested mapping of numpy arrays -> nested dict of tensors on ``device``
    (``dtype`` casts every leaf; None keeps each leaf's own).  With ``specs``
    (``execution.train.param_specs_for``) and ``slots`` (``{axis: (index,
    size)}``, ``ProcessMesh.slots()``) each leaf is this rank's block."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        spec = specs[name] if specs is not None else None
        if isinstance(leaf, Mapping):
            out[name] = from_numpy_tree(leaf, device, dtype, spec, slots)
            continue
        if spec is not None:
            leaf = slice_leaf(np.asarray(leaf), spec, slots or {})
        t = torch.from_numpy(np.array(leaf, copy=True))
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out
