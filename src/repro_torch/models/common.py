"""Shared building blocks: linear init, RMSNorm, RoPE, embedding and the
token cross-entropy (port of ``repro.models.common`` without tensor
parallelism — the port's model runs on one device per worker).

Layouts follow the JAX package: a linear weight is ``(d_in, d_out)`` and
applies as ``x @ W``, so parameters cross between the two packages without
transposes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core.matrixize import MatrixSpec


def dense_init(shape, in_axis_size: int, generator: Optional[torch.Generator],
               device=None, dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_axis_size)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype) * scale


def rmsnorm_init(d: int, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.ones((d,), device=device, dtype=dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Rotates the two halves of the head dim (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_init(vocab: int, d: int, generator, device=None,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, device=device,
                       dtype=dtype) * 0.02


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    # F.embedding, not table[ids]: indexing's backward accumulates repeated
    # ids in an order that changes from run to run on the CPU
    return torch.nn.functional.embedding(ids.long(), table)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy; labels outside [0, vocab) score 0 (the
    caller masks them out of the mean)."""
    vocab = logits.shape[-1]
    logits32 = logits.float()
    # the stabiliser needs no gradient
    gmax = torch.amax(logits32, dim=-1).detach()
    sumexp = torch.sum(torch.exp(logits32 - gmax[..., None]), dim=-1)
    lse = gmax + torch.log(sumexp)
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    picked = torch.gather(logits32, -1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    return lse - torch.where(valid, picked, torch.zeros_like(picked))


def stack_mspec(ms: MatrixSpec) -> MatrixSpec:
    """The spec of a leaf stacked on one more leading (layer) dim."""
    if not ms.is_compressed():
        return ms
    return MatrixSpec(kind=ms.kind, batch_dims=ms.batch_dims + 1)


def tree_stack_mspec(t):
    return tree.map(stack_mspec, t)
