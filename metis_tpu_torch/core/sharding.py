"""Partition specs and the block of an array one rank holds.

A spec is the port's stand-in for the reference's ``PartitionSpec``: a
tuple with one entry per dimension, the mesh axis that dimension is split
over or None (``()`` = replicated).  ``execution/mesh.py`` builds the spec
trees; the model and the weight conversion only cut leaves with them.
"""
from __future__ import annotations

Spec = tuple  # axis name, tuple of names or None per dimension; () = replicated


def slice_leaf(x, spec: Spec, slots: dict[str, tuple[int, int]]):
    """This rank's block of ``x`` (a tensor or numpy array): each dimension
    whose spec names an axis of ``slots`` (``{axis: (index, size)}``) is cut
    into ``size`` equal blocks, of which block ``index`` is kept.  A tuple
    of axes splits the dimension over their product, the first axis
    major."""
    for dim, axis in enumerate(spec):
        index, size = _slot(axis, slots)
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(
                f"dimension {dim} of {tuple(x.shape)} does not split over "
                f"{axis} = {size}")
        step = x.shape[dim] // size
        x = x[(slice(None),) * dim + (slice(index * step, (index + 1) * step),)]
    return x


def _slot(axis, slots: dict[str, tuple[int, int]]) -> tuple[int, int]:
    """(index, size) of this rank along ``axis`` (a name, a tuple of names,
    or None); axes absent from ``slots`` have size 1."""
    if axis is None:
        return 0, 1
    index, size = 0, 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        i, n = slots.get(a, (0, 1))
        index, size = index * n + i, size * n
    return index, size


def leaf_box(shape, spec: Spec, slots: dict[str, tuple[int, int]]) -> list:
    """The ``[start, stop)`` per dimension of the block of a ``shape``-shaped
    array that ``slice_leaf(x, spec, slots)`` keeps, in the array's
    coordinates."""
    box = [[0, int(n)] for n in shape]
    for dim, axis in enumerate(spec):
        index, size = _slot(axis, slots)
        if size == 1:
            continue
        if shape[dim] % size:
            raise ValueError(
                f"dimension {dim} of {tuple(shape)} does not split over "
                f"{axis} = {size}")
        step = shape[dim] // size
        box[dim] = [index * step, (index + 1) * step]
    return box
