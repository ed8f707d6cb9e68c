"""Causal GQA self-attention for training (port of the train ``forward`` of
``repro.models.attention``, without tensor parallelism).

Written as the JAX package writes it: queries in chunks of ``q_chunk``,
einsum scores against the full key sequence, a causal mask and a softmax.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.models import common

NEG_INF = -1e30


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32):
    hd, d = cfg.resolved_head_dim, cfg.d_model
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {
        "wq": common.dense_init((d, hq), d, generator, device, dtype),
        "wk": common.dense_init((d, hkv), d, generator, device, dtype),
        "wv": common.dense_init((d, hkv), d, generator, device, dtype),
        "wo": common.dense_init((hq, d), hq, generator, device, dtype),
    }


def mspecs(cfg: ModelConfig):
    return {k: MatrixSpec("matrix", 0) for k in ("wq", "wk", "wv", "wo")}


def forward(params, x: torch.Tensor, cfg: ModelConfig, *, q_chunk: int = 512):
    """x: (B, S, d) → (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hl = params["wq"].shape[1] // hd
    scale = 1.0 / math.sqrt(hd)
    group = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))

    q = (x @ params["wq"]).reshape(b, s, hl, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, hd)

    positions = torch.arange(s, device=x.device)
    q = common.apply_rope(q, positions[None, :], cfg.rope_theta)
    k = common.apply_rope(k, positions[None, :], cfg.rope_theta)

    # each kv head serves `group` consecutive query heads.  An expand, not
    # index_select: its backward is a sum over the group, where
    # index_select's adds with atomics on the card, in an order that
    # changes from run to run
    kv_shape = (b, s, cfg.num_kv_heads, group, hd)
    k_h = k[:, :, :, None].expand(kv_shape).reshape(b, s, hl, hd)
    v_h = v[:, :, :, None].expand(kv_shape).reshape(b, s, hl, hd)

    qc = min(q_chunk, s)
    kpos = torch.arange(s, device=x.device)
    outs = []
    for start in range(0, s, qc):
        qck = q[:, start:start + qc]
        scores = torch.einsum("bqhd,bkhd->bhqk", qck, k_h) * scale
        qpos = start + torch.arange(qck.shape[1], device=x.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v_h))
    out = torch.cat(outs, dim=1).reshape(b, s, hl * hd)
    return out @ params["wo"]
