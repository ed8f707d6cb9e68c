"""Public entry points of the kernels, dispatched by device, plus the
tree-level EF apply.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.
ref`); a CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.lowrank`, :mod:`repro_torch.kernels.quant`),
which raises on what it does not take.  There is no fallback from a CUDA
tensor to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels import lowrank, quant, ref


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def lowrank_project(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M Q (batched over leading dims)."""
    if _on_cpu(m, q):
        return ref.lowrank_project(m, q)
    return lowrank.lowrank_project(m, q)


def lowrank_backproject(m: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """Q = Mᵀ P̂ (batched over leading dims)."""
    if _on_cpu(m, p_hat):
        return ref.lowrank_backproject(m, p_hat)
    return lowrank.lowrank_backproject(m, p_hat)


def nibble_pack(q: torch.Tensor) -> torch.Tensor:
    """int4 codes (int8, last dim n) → (..., ceil(n/2)) uint8, two per byte."""
    if _on_cpu(q):
        return ref.nibble_pack(q)
    return quant.nibble_pack(q)


def nibble_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`nibble_pack`: (..., b) uint8 → (..., n) int8."""
    if _on_cpu(packed):
        return ref.nibble_unpack(packed, n)
    return quant.nibble_unpack(packed, n)


def ef_apply_tree(params, agg, momentum_state, *, lr, momentum):
    """Momentum + parameter update from the dense aggregate, in place:
    ``m ← λ m + Δ'``, ``x ← x − lr (Δ' + m)``.  Returns (params, momentum),
    the same tensors, updated."""
    with torch.no_grad():
        for m, d in zip(tree.leaves(momentum_state), tree.leaves(agg)):
            m.mul_(momentum).add_(d)
        for x, d, m in zip(tree.leaves(params), tree.leaves(agg),
                           tree.leaves(momentum_state)):
            x.sub_(lr * (d + m))
    return params, momentum_state
