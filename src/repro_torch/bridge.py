"""Carry state between the JAX package and the port as numpy arrays.

JAX's random draws cannot be reproduced with ``torch.Generator``, so a
comparison of the two packages starts both from the same arrays: the JAX
side's parameters and warm-start Q factors, converted to numpy
(``jax.tree_util.tree_map(np.asarray, tree)``), enter the port through
:func:`to_torch`.  The layouts are the same in both packages (weights
``(d_in, d_out)``, blocks stacked on a leading period dim, Q factors
``batch_shape + (m, r)``), so the conversion is a copy, bit for bit.
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
