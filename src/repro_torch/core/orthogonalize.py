"""Orthogonalization of the tall-skinny P factor (port of
``repro.core.orthogonalize``).

Three implementations, each on ``(..., n, r)`` and batched over leading
dims, so the ``(B, n, r)`` slabs of the bucketed engine go through in one
call.  Zero-padded rows are exact no-ops: they add nothing to any column
inner product.

* ``gram_schmidt`` — the paper's choice, scale-invariant and ULP-guarded
  (numerically rank-deficient columns become exact zero columns).
* ``cholesky_qr`` — CholeskyQR2: ``L = chol(PᵀP + jitter·I)``,
  ``P̂ = P L⁻ᵀ``, done twice.  Two tall-skinny products and batched r×r
  factorizations instead of a column loop.
* ``gs_cholqr`` — ``gram_schmidt`` with a per-matrix CholeskyQR2 fallback
  where the Gram-Schmidt output is not a projector to within a dtype-ULP
  budget.

A factorization that fails (a Gram matrix that is not positive definite,
or a non-finite one) gives that element a NaN factor, as the JAX package's
``jnp.linalg.cholesky`` does, and never raises: ``cholesky_ex`` reports it
per element on the device, with no host sync.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


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


def cholesky_or_nan(gram: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each ``(..., r, r)`` matrix; where the
    factorization fails, NaN on and below the diagonal, as
    ``jnp.linalg.cholesky`` gives (``cholesky_ex`` leaves a partial factor
    there).  Never raises and never syncs with the host."""
    r = gram.shape[-1]
    chol, info = torch.linalg.cholesky_ex(gram)
    nan_lower = torch.full((r, r), float("nan"), dtype=gram.dtype,
                           device=gram.device).tril()
    return torch.where((info != 0)[..., None, None], nan_lower, chol)


def _cholesky_qr_once(p: torch.Tensor, eps: float) -> torch.Tensor:
    r = p.shape[-1]
    gram = torch.einsum("...nr,...ns->...rs", p, p)
    # scale-aware jitter: it must dominate the rounding noise of the Gram
    # entries, O(ulp·‖G‖), or near-rank-deficient P fails to factor
    scale = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)[..., None, None] / r
    ulp = torch.finfo(p.dtype).eps
    gram = gram + (eps + 64.0 * ulp * scale) * torch.eye(
        r, dtype=p.dtype, device=p.device)
    chol = cholesky_or_nan(gram)
    # solve P̂ Lᵀ = P  ⇒  P̂ = P L⁻ᵀ
    return torch.linalg.solve_triangular(chol.mT, p, upper=True, left=False)


def cholesky_qr(p: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """CholeskyQR2.  One pass loses orthogonality as κ²(P)·ε; a second pass
    on its own output squares the residual away (Yamamoto et al. 2015).
    The solve returns P̂ column-major; the low-rank kernels read it
    row-major, so the result is made contiguous."""
    return _cholesky_qr_once(_cholesky_qr_once(p, eps), eps).contiguous()


def gs_cholqr(p: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """``gram_schmidt`` with a per-matrix CholeskyQR2 stability fallback.

    Keeps the Gram-Schmidt result where its Gram matrix ``G = QᵀQ`` is a
    projector (``max|G² − G| ≤ 1024·ulp``, which accepts the exact-zero
    columns of rank-deficient input); elsewhere that batch element takes
    the CholeskyQR2 result.  Both candidates are computed for every
    element and selected on the device, so this costs one extra
    orthogonalization pass.
    """
    q = gram_schmidt(p)
    keep = projector_error(q) <= 1024.0 * torch.finfo(p.dtype).eps
    return torch.where(keep[..., None, None], q, cholesky_qr(p, eps))


def projector_error(q: torch.Tensor) -> torch.Tensor:
    """``max|G² − G|`` over each matrix's ``G = QᵀQ``, shape ``q.shape[:-2]``:
    the test ``gs_cholqr`` puts to the Gram-Schmidt result."""
    gram = torch.einsum("...nr,...ns->...rs", q, q)
    return (gram @ gram - gram).abs().amax(dim=(-2, -1))


ORTHOGONALIZERS = {
    "gram_schmidt": gram_schmidt,
    "cholesky_qr": cholesky_qr,
    "gs_cholqr": gs_cholqr,
}


def get_orthogonalizer(name: str):
    try:
        return ORTHOGONALIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown orthogonalizer {name!r}; available: "
            f"{sorted(ORTHOGONALIZERS)}") from None
