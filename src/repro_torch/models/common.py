"""Shared building blocks: linear init, RMSNorm, RoPE, Megatron's *g*,
the vocab-sharded embedding and cross-entropy, and spec helpers (port of
``repro.models.common``).

Layouts follow the JAX package: a linear weight is ``(d_in, d_out)`` and
applies as ``x @ W``, so parameters cross between the two packages without
transposes.

Tensor parallelism over the ``model`` axis follows the JAX package's
convention, global shapes with :class:`~repro_torch.sharding.PartitionSpec`
s, each rank computing on its local slices:

  * column-parallel linear  W (d_in, d_out)   spec ``P(None, "model")``
  * row-parallel linear     W (d_in, d_out)   spec ``P("model", None)``,
    the caller sums the output with ``ctx.psum_model`` (*f*)
  * embedding               E (vocab, d)      spec ``P("model", None)``
  * replicated parameters                     spec ``P(None, ...)``

A replicated activation enters sharded compute through :func:`grad_synced`
(*g*).  Local dims are read off the local tensors, so the same functions
run without a model axis (``ctx=SINGLE``), with the bits of the port before
it had one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import dist
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.sharding import P


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


def grad_synced(x: torch.Tensor, ctx: MeshCtx = SINGLE) -> torch.Tensor:
    """The identity forward, the model group's sum of the cotangent
    backward: Megatron's *g*.  Wrap a model-replicated activation exactly
    where it enters rank-local sharded compute (the column-parallel
    projections, the vocab-sharded head): each model rank's backward gives
    only the cotangent of its own shard's use, and without this sum every
    replicated gradient would be a per-rank partial one.  A no-op without a
    model axis or with ``ctx.tp_grad_sync`` off."""
    return dist.model_grad_sync(x, ctx)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 ctx: MeshCtx = SINGLE) -> torch.Tensor:
    """``table`` is the local ``(vocab_local, d)`` slice, ``ids`` global
    token ids: each rank looks up the ids in its own rows, writes zeros for
    the others, and the model axis sums the pieces (*f*)."""
    # F.embedding, not table[ids]: indexing's backward accumulates repeated
    # ids in an order that changes from run to run on the CPU
    if ctx.model_axis is None:
        return torch.nn.functional.embedding(ids.long(), table)
    vocab_local = table.shape[0]
    local = ids.long() - ctx.model_index() * vocab_local
    valid = (local >= 0) & (local < vocab_local)
    out = torch.nn.functional.embedding(local.clamp(0, vocab_local - 1), table)
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return ctx.psum_model(out)


def sharded_softmax_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                         ctx: MeshCtx = SINGLE,
                         vocab: Optional[int] = None) -> torch.Tensor:
    """Per-token cross-entropy of vocab-sharded logits ``(..., vocab_local)``
    (replicated over the model axis).  Columns at or past ``vocab`` (the
    padding up to a multiple of the model size) are masked; the stabiliser
    is a detached max over the model axis; the sum of exponentials and the
    label's logit are summed over it (*f*).  Labels outside [0, vocab)
    score 0 (the caller masks them out of the mean)."""
    vocab_local = logits_local.shape[-1]
    offset = ctx.model_index() * vocab_local
    logits32 = logits_local.float()
    if vocab is not None and offset + vocab_local > vocab:
        col = offset + torch.arange(vocab_local, device=logits32.device)
        logits32 = torch.where(col < vocab, logits32,
                               torch.full_like(logits32, -math.inf))
    # the stabiliser needs no gradient
    gmax = ctx.pmax_model(torch.amax(logits32, dim=-1).detach())
    sumexp = ctx.psum_model(torch.sum(torch.exp(logits32 - gmax[..., None]),
                                      dim=-1))
    lse = gmax + torch.log(sumexp)
    local_label = labels.long() - offset
    valid = (local_label >= 0) & (local_label < vocab_local)
    picked = torch.gather(logits32, -1,
                          local_label.clamp(0, vocab_local - 1)[..., None])[..., 0]
    return lse - ctx.psum_model(torch.where(valid, picked,
                                            torch.zeros_like(picked)))


def stackspec(spec) -> P:
    """A spec with a leading whole (period/layer-stack) dim."""
    return P(*((None,) + tuple(spec)))


def tree_stackspec(t):
    return tree.map(stackspec, t)


def stack_mspec(ms: MatrixSpec) -> MatrixSpec:
    """The spec of a leaf stacked on one more leading (layer) dim."""
    if not ms.is_compressed():
        return ms
    return MatrixSpec(kind=ms.kind, batch_dims=ms.batch_dims + 1)


def tree_stack_mspec(t):
    return tree.map(stack_mspec, t)
