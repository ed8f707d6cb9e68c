"""Language model: embedding → block stack → final norm → head, and the
training loss (port of ``init``, ``mspecs`` and ``loss_fn`` of
``repro.models.model``; decode and prefill wait for ROADMAP queue A,
item 12)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
from repro_torch.models import blocks, common


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None):
    """Random parameters drawn from ``generator`` on ``device`` (``"meta"``
    gives shapes without storage)."""
    dtype = cfg.torch_dtype()
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": common.embed_init(v, d, generator, device, dtype),
        "blocks": blocks.init(cfg, generator, device, dtype),
        "final_norm": common.rmsnorm_init(d, device, dtype),
        "head": common.dense_init((d, v), d, generator, device, dtype),
    }


def mspecs(cfg: ModelConfig):
    return {
        "embed": MatrixSpec("matrix", 0),
        "blocks": blocks.mspecs(cfg),
        "final_norm": SPEC_NONE,
        "head": MatrixSpec("matrix", 0),
    }


def loss_fn(params, batch, cfg: ModelConfig, *, q_chunk: int = 512):
    """batch: tokens (B, S), labels (B, S) [-1 = masked].

    Returns ``(loss, metrics)``: the mean over this worker's unmasked
    tokens — the per-worker stochastic gradient PowerSGD compresses."""
    x = common.embed_lookup(params["embed"], batch["tokens"])
    x = blocks.forward(params["blocks"], x, cfg, q_chunk=q_chunk)
    x = common.rmsnorm(x, params["final_norm"])
    labels = batch["labels"]
    tok_loss = common.softmax_xent(x @ params["head"], labels)
    mask = (labels >= 0).float()
    loss = torch.sum(tok_loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"lm_loss": loss}
