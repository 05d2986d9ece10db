"""Partition specs and the block of an array one rank holds.

A spec is the port's stand-in for the reference's ``PartitionSpec``: a
tuple with one entry per dimension, the mesh axis that dimension is split
over or None (``()`` = replicated).  ``execution/mesh.py`` builds the spec
trees; the model and the weight conversion only cut leaves with them.
"""
from __future__ import annotations

Spec = tuple  # axis name (or None) per dimension; () = replicated


def slice_leaf(x, spec: Spec, slots: dict[str, tuple[int, int]]):
    """This rank's block of ``x`` (a tensor or numpy array): each dimension
    whose spec names an axis of ``slots`` (``{axis: (index, size)}``) is cut
    into ``size`` equal blocks, of which block ``index`` is kept."""
    for dim, axis in enumerate(spec):
        if axis is None or axis not in slots:
            continue
        index, size = slots[axis]
        if x.shape[dim] % size:
            raise ValueError(
                f"dimension {dim} of {tuple(x.shape)} does not split over "
                f"{axis} = {size}")
        step = x.shape[dim] // size
        x = x[(slice(None),) * dim + (slice(index * step, (index + 1) * step),)]
    return x
