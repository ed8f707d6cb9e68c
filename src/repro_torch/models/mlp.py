"""SwiGLU feed-forward (port of ``repro.models.mlp`` without tensor
parallelism)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.models import common


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": common.dense_init((d, ff), d, generator, device, dtype),
        "w_up": common.dense_init((d, ff), d, generator, device, dtype),
        "w_down": common.dense_init((ff, d), ff, generator, device, dtype),
    }


def mspecs(cfg: ModelConfig):
    return {k: MatrixSpec("matrix", 0) for k in ("w_gate", "w_up", "w_down")}


def forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]
