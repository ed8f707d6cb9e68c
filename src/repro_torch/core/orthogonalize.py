"""Orthogonalization of the tall-skinny P factor (port of
``repro.core.orthogonalize``: the paper's Gram-Schmidt).

``gram_schmidt`` works on ``(..., n, r)`` and is batched over leading dims,
so the ``(B, n, r)`` slabs of the bucketed engine go through in one call.
Zero-padded rows are exact no-ops.  ``cholesky_qr`` and ``gs_cholqr`` are
not ported yet (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import torch


def gram_schmidt(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the last axis' columns.  Shape (..., n, r).

    Scale-invariant: each column is prescaled by its max-abs entry, so a
    nonzero column enters the loop with norm in [1, √n].  A residual column
    whose squared norm falls below the post-projection rounding floor
    ``n·(32·ulp)²`` is numerically rank-deficient and becomes an exact zero
    column instead of normalized noise (no NaN for all-zero columns).
    """
    n, r = p.shape[-2], p.shape[-1]
    ulp = torch.finfo(p.dtype).eps
    floor = n * (32.0 * ulp) ** 2

    scale = p.abs().amax(dim=-2, keepdim=True)                    # (..., 1, r)
    m = p / torch.where(scale > 0, scale, torch.ones_like(scale))
    col_ids = torch.arange(r, device=p.device)
    for i in range(r):
        col = m[..., i:i + 1]                                       # (..., n, 1)
        nrm2 = torch.sum(col * col, dim=-2, keepdim=True)
        inv = torch.where(nrm2 > floor,
                          torch.rsqrt(torch.clamp(nrm2, min=floor)),
                          torch.zeros_like(nrm2))
        col = col * inv
        # remove the projection of the later columns on `col`; column i
        # itself becomes the normalised col
        proj = torch.sum(col * m, dim=-2, keepdim=True)             # (..., 1, r)
        later = (col_ids > i).to(m.dtype)
        m = m - col * (proj * later)
        m = torch.cat([m[..., :i], col, m[..., i + 1:]], dim=-1)
    return m


ORTHOGONALIZERS = {"gram_schmidt": gram_schmidt}
NOT_PORTED = ("cholesky_qr", "gs_cholqr")


def get_orthogonalizer(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"orthogonalizer {name!r} is not ported yet (ROADMAP queue A, "
            f"item 8)")
    try:
        return ORTHOGONALIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown orthogonalizer {name!r}; available: "
            f"{sorted(ORTHOGONALIZERS)}") from None
