"""Plain PyTorch versions of the low-rank kernels (the allclose reference).

Batched over arbitrary leading dims via einsum ellipsis, the same contract
as the kernels, so a ``(B, n, m)`` bucket slab checks against the batched
kernel in one call.  Port of ``repro.kernels.ref`` (the three functions the
training step uses).
"""

from __future__ import annotations

import torch


def lowrank_project(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M Q.   m: (..., n, k), q: (..., k, r) → (..., n, r)."""
    return torch.einsum("...nk,...kr->...nr", m, q)


def lowrank_backproject(m: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """Q = Mᵀ P̂.  m: (..., n, k), p_hat: (..., n, r) → (..., k, r)."""
    return torch.einsum("...nk,...nr->...kr", m, p_hat)


def decompress(p_hat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Δ' = P̂ Qᵀ.  p_hat: (..., n, r), q: (..., m, r) → (..., n, m)."""
    return torch.einsum("...nr,...mr->...nm", p_hat, q)
