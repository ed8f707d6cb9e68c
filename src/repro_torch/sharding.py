"""Partition specs and the slicing of global trees to a rank's shards: the
port's stand-in for ``jax.sharding.PartitionSpec`` and for what
``shard_map`` does to its inputs.

A :class:`PartitionSpec` (``P``) names, per dim of a leaf, the mesh axis
(or tuple of axes) the dim is split over, or ``None`` for a dim every rank
holds whole; dims past its length are whole.  It is a tuple and compares
equal entry for entry, so ``tuple(spec)`` of a JAX spec and of a port spec
can be held against each other.

:func:`shard_tree` cuts a global tree into one rank's local slices (a dim
that carries an axis of size S splits into S contiguous pieces, the rank's
index along the axis picking its piece); :func:`gather_tree` puts the
pieces of every index along one axis back together.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch import tree


class PartitionSpec(tuple):
    """``P("model", None)``: a tuple of per-dim entries (an axis name, a
    tuple of axis names, or ``None``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


def mentions(entry, axis: str) -> bool:
    """Does one spec entry carry ``axis`` (entries may be tuples)?"""
    if entry == axis:
        return True
    return isinstance(entry, (tuple, list)) and axis in entry


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _piece(entry, where: Dict[str, Tuple[int, int]]) -> Tuple[int, int]:
    """(index, count) of a rank's piece of a dim with spec ``entry``: the
    axes of the entry that ``where`` names, row-major."""
    index, count = 0, 1
    for axis in _entry_axes(entry):
        if axis in where:
            i, n = where[axis]
            index, count = index * n + i, count * n
    return index, count


def shard(x: torch.Tensor, spec, where: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """One rank's contiguous slice of the global tensor ``x`` (a view).
    ``where`` maps an axis name to the rank's ``(index, size)`` along it;
    axes it does not name leave their dims whole."""
    for dim, entry in enumerate(tuple(spec)):
        index, count = _piece(entry, where)
        if count == 1:
            continue
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {count} pieces ({spec})")
        size = x.shape[dim] // count
        x = x.narrow(dim, index * size, size)
    return x


def _where(mesh_or_coord) -> Dict[str, Tuple[int, int]]:
    if isinstance(mesh_or_coord, dict):
        return dict(mesh_or_coord)
    return mesh_or_coord.coords


def shard_tree(global_tree, pspecs, mesh_or_coord, *, copy: bool = True):
    """Every leaf of ``global_tree`` cut to one rank's slice under its spec
    in ``pspecs`` (a tree of :class:`PartitionSpec` aligned with it;
    ``None`` leaves stay ``None``).  ``mesh_or_coord`` is a
    :class:`~repro_torch.launch.mesh.Mesh` (this rank's place on it) or a
    dict ``{axis: (index, size)}``.  ``copy=True`` gives each slice storage
    of its own (contiguous), so the rank may update it in place; a leaf the
    rank holds whole comes back as it is."""
    where = _where(mesh_or_coord)

    def leaf(x, spec):
        if x is None:
            return None
        out = shard(x, spec, where)
        return out.clone(memory_format=torch.contiguous_format) if (
            copy and out is not x) else out
    return tree.map(leaf, global_tree, pspecs)


def gather_tree(pieces: Sequence[Any], pspecs, axis: str = "model"):
    """The inverse of :func:`shard_tree` along one axis: ``pieces`` are the
    local trees of indices 0, 1, … along ``axis`` (every other axis at one
    index), concatenated on the dims whose spec carries ``axis``.  A leaf
    whose spec does not carry it is taken from index 0."""
    def leaf(spec, *xs):
        if xs[0] is None:
            return None
        dims = [d for d, e in enumerate(tuple(spec)) if mentions(e, axis)]
        if not dims:
            return xs[0]
        if len(dims) > 1:
            raise ValueError(f"{spec} carries {axis!r} on more than one dim")
        return torch.cat(list(xs), dim=dims[0])
    return tree.map(leaf, pspecs, *pieces)
