"""Carry state between the JAX package and the port as numpy arrays.

JAX's random draws cannot be reproduced with ``torch.Generator``, so a
comparison of the two packages starts both from the same arrays: the JAX
side's parameters and warm-start Q factors, converted to numpy
(``jax.tree_util.tree_map(np.asarray, tree)``), enter the port through
:func:`to_torch`.  The layouts are the same in both packages (weights
``(d_in, d_out)``, blocks stacked on a leading period dim, Q factors
``batch_shape + (m, r)``), so the conversion is a copy, bit for bit.
Under a model axis, :func:`to_torch_local` cuts the JAX side's global
arrays to a rank's shards.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


def to_torch(t, device="cpu"):
    """Nested dict of numpy arrays (``None`` leaves allowed) → the same tree
    of torch tensors, copied onto ``device``."""
    return tree.map(lambda x: None if x is None
                    else torch.tensor(np.asarray(x), device=device), t)


def to_numpy(t):
    """Nested dict of tensors (``None`` leaves allowed) → numpy arrays."""
    return tree.map(lambda x: None if x is None
                    else x.detach().cpu().numpy(), t)


def to_torch_local(t, pspecs, mesh_or_coord, device="cpu"):
    """A global tree of numpy arrays (the JAX package's parameters or
    state) → one rank's local slices under ``pspecs``
    (:func:`repro_torch.sharding.shard_tree`; ``mesh_or_coord`` a
    :class:`~repro_torch.launch.mesh.Mesh` or ``{axis: (index, size)}``),
    each a tensor of its own on ``device``."""
    from repro_torch.sharding import shard_tree

    return shard_tree(to_torch(t, device), pspecs, mesh_or_coord)
