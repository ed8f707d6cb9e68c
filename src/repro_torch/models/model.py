"""Language model: embedding → block stack → final norm → head, and the
training loss (port of ``padded_vocab``, ``init``, ``pspecs``, ``mspecs``
and ``loss_fn`` of ``repro.models.model``).

:func:`init` draws the global parameters (heads and vocabulary padded to
``model_shards``); :func:`pspecs` says how the model axis splits them, and
:func:`loss_fn` runs on a rank's local slices under the step's
:class:`~repro_torch.core.dist.MeshCtx` (``SINGLE``: the whole model).

The paper's own models are ported beside it (ROADMAP queue A, item 15,
first half): :mod:`repro_torch.models.resnet` and
:mod:`repro_torch.models.lstm`.  Decode and prefill, MoE and Mamba-2 wait
for the second half of item 15."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
from repro_torch.models import blocks, common
from repro_torch.sharding import P


def padded_vocab(cfg: ModelConfig, model_shards: int) -> int:
    v = cfg.vocab_size
    return ((v + model_shards - 1) // model_shards) * model_shards


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, model_shards: int = 1):
    """Random global parameters drawn from ``generator`` on ``device``
    (``"meta"`` gives shapes without storage), query heads and vocabulary
    padded to a multiple of ``model_shards``."""
    dtype = cfg.torch_dtype()
    d, v = cfg.d_model, padded_vocab(cfg, model_shards)
    return {
        "embed": common.embed_init(v, d, generator, device, dtype),
        "blocks": blocks.init(cfg, generator, device, dtype,
                              model_shards=model_shards),
        "final_norm": common.rmsnorm_init(d, device, dtype),
        "head": common.dense_init((d, v), d, generator, device, dtype),
    }


def pspecs(cfg: ModelConfig):
    return {
        "embed": P("model", None),
        "blocks": blocks.pspecs(cfg),
        "final_norm": P(None),
        "head": P(None, "model"),
    }


def mspecs(cfg: ModelConfig):
    return {
        "embed": MatrixSpec("matrix", 0),
        "blocks": blocks.mspecs(cfg),
        "final_norm": SPEC_NONE,
        "head": MatrixSpec("matrix", 0),
    }


def loss_fn(params, batch, cfg: ModelConfig, ctx: MeshCtx = SINGLE, *,
            q_chunk: int = 512):
    """batch: tokens (B, S), labels (B, S) [-1 = masked].

    Returns ``(loss, metrics)``: the mean over this worker's unmasked
    tokens — the per-worker stochastic gradient PowerSGD compresses —
    replicated over the model axis."""
    x = common.embed_lookup(params["embed"], batch["tokens"], ctx)
    x = blocks.forward(params["blocks"], x, cfg, ctx, q_chunk=q_chunk)
    x = common.rmsnorm(x, params["final_norm"])
    labels = batch["labels"]
    logits_local = common.grad_synced(x, ctx) @ params["head"]
    tok_loss = common.sharded_softmax_xent(logits_local, labels, ctx,
                                           cfg.vocab_size)
    mask = (labels >= 0).float()
    loss = torch.sum(tok_loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"lm_loss": loss}
