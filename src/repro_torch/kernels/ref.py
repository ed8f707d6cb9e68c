"""Plain PyTorch versions of the kernels (the reference they are held to).

Batched over arbitrary leading dims, the same contract as the kernels, so a
``(B, n, m)`` bucket slab or a ``(W, bytes)`` gathered payload checks
against its kernel in one call.  Port of ``repro.kernels.ref``: the
low-rank products the PowerSGD step uses and the int4 wire format the
quantized gather uses.
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


# ---------------------------------------------------------------------------
# quantized wire formats: symmetric scale + int4 nibble packing
# ---------------------------------------------------------------------------

def quant_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric quantization scale max|x| / qmax over the last dim:
    (..., n) → (...,) float32.  An all-zero row gets scale 1.0, so
    quantize/dequantize stay finite."""
    absmax = x.float().abs().amax(dim=-1)
    return torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))


def quantize(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Round-to-nearest-even symmetric quantization → int8 codes in
    [-qmax, qmax]; ``scale`` broadcasts against ``x``."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: codes × scale."""
    return (q.float() * scale).to(dtype)


def nibble_pack(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8, last dim n) two per byte: even indices to the
    low nibble, odd to the high nibble, an odd tail padded with a zero
    code.  (..., n) int8 → (..., ceil(n/2)) uint8.  Only the low nibble of
    each code is kept (two's complement), whatever its range."""
    n = q.shape[-1]
    qp = torch.nn.functional.pad(q, (0, n % 2))
    u = qp.to(torch.uint8) & 0xF
    return u[..., 0::2] | (u[..., 1::2] << 4)


def nibble_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`nibble_pack`: (..., b) uint8 → (..., n) int8 codes
    in [-8, 7], each nibble sign-extended; ``n ≤ 2b``."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    inter = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))[..., :n]
    return torch.where(inter >= 8, inter - 16, inter)
