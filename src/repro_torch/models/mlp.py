"""SwiGLU feed-forward, column- then row-parallel over the model axis
(port of ``repro.models.mlp``, Megatron's pattern)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.models import common
from repro_torch.sharding import P


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": common.dense_init((d, ff), d, generator, device, dtype),
        "w_up": common.dense_init((d, ff), d, generator, device, dtype),
        "w_down": common.dense_init((ff, d), ff, generator, device, dtype),
    }


def pspecs(cfg: ModelConfig):
    return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
            "w_down": P("model", None)}


def mspecs(cfg: ModelConfig):
    return {k: MatrixSpec("matrix", 0) for k in ("w_gate", "w_up", "w_down")}


def forward(params, x: torch.Tensor, cfg: ModelConfig,
            ctx: MeshCtx = SINGLE) -> torch.Tensor:
    """x: (B, S, d) replicated over the model axis; the output likewise."""
    x = common.grad_synced(x, ctx)
    gate = torch.nn.functional.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return ctx.psum_model((gate * up) @ params["w_down"])
