"""Causal GQA self-attention for training, with Megatron-style tensor
parallelism (port of the train ``forward`` of ``repro.models.attention``).

Written as the JAX package writes it: queries in chunks of ``q_chunk``,
einsum scores against the full key sequence, a causal mask and a softmax.

Sharding over the ``model`` axis:

* query heads are padded to a multiple of the model size and column-split;
  padded heads are masked out of the output (their weights get exactly
  zero gradient);
* ``wk``/``wv`` are column-split as plain matrices and all-gathered before
  attention, or, under ``cfg.tp_local_kv`` where the kv heads split evenly,
  kept local with no gather;
* ``wo`` is row-parallel: its output is summed over the model axis (*f*).

The decode and prefill paths wait for ROADMAP queue A, item 15.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.models import common
from repro_torch.sharding import P

NEG_INF = -1e30


def padded_heads(cfg: ModelConfig, model_shards: int) -> int:
    h = cfg.num_heads
    return ((h + model_shards - 1) // model_shards) * model_shards


def kv_map(cfg: ModelConfig, model_shards: int):
    """Static q-head → kv-head index map over the padded head range."""
    group = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    return [min(i, cfg.num_heads - 1) // group
            for i in range(padded_heads(cfg, model_shards))]


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32,
         model_shards: int = 1):
    """The global weights, query heads padded to ``model_shards``."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    hq, hkv = padded_heads(cfg, model_shards) * hd, cfg.num_kv_heads * hd
    return {
        "wq": common.dense_init((d, hq), d, generator, device, dtype),
        "wk": common.dense_init((d, hkv), d, generator, device, dtype),
        "wv": common.dense_init((d, hkv), d, generator, device, dtype),
        "wo": common.dense_init((hq, d), hq, generator, device, dtype),
    }


def pspecs(cfg: ModelConfig):
    return {"wq": P(None, "model"), "wk": P(None, "model"),
            "wv": P(None, "model"), "wo": P("model", None)}


def mspecs(cfg: ModelConfig):
    return {k: MatrixSpec("matrix", 0) for k in ("wq", "wk", "wv", "wo")}


def _heads(kv: torch.Tensor, kv_idx) -> torch.Tensor:
    """``kv[:, :, kv_idx]`` for a static index list, as expands of runs of
    one kv head, not index_select: the backward of an expand is a sum over
    the run, where index_select's adds with atomics on the card, in an
    order that changes from run to run.  A map of whole groups of
    consecutive kv heads is one expand of the kv heads it covers."""
    b, s, _, hd = kv.shape
    runs = []                       # [kv head, count] in order
    for j in kv_idx:
        if runs and runs[-1][0] == j:
            runs[-1][1] += 1
        else:
            runs.append([j, 1])
    counts = {c for _, c in runs}
    heads = [j for j, _ in runs]
    if len(counts) == 1 and heads == list(range(heads[0], heads[-1] + 1)):
        c = counts.pop()
        sel = kv if len(heads) == kv.shape[2] else kv[:, :, heads[0]:heads[-1] + 1]
        sel = sel[:, :, :, None]
        return sel.expand(b, s, len(heads), c, hd).reshape(b, s, len(kv_idx), hd)
    return torch.cat([kv[:, :, j:j + 1].expand(b, s, c, hd) for j, c in runs],
                     dim=2)


def forward(params, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
            *, q_chunk: int = 512):
    """x: (B, S, d), replicated over the model axis → (B, S, d), likewise."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hl = params["wq"].shape[1] // hd            # local (padded) head count
    scale = 1.0 / math.sqrt(hd)
    shards = ctx.model_size()
    group = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    local_kv = (cfg.tp_local_kv and cfg.num_kv_heads % shards == 0
                and cfg.num_heads % shards == 0)

    # the replicated x enters the column-parallel projections (g)
    x = common.grad_synced(x, ctx)
    q = (x @ params["wq"]).reshape(b, s, hl, hd)
    if local_kv:
        # shard m owns q heads [m·hl, (m+1)·hl) and kv heads [m·kvl,
        # (m+1)·kvl), hl = group·kvl: every local q head's kv head is local
        kvl = cfg.num_kv_heads // shards
        k = (x @ params["wk"]).reshape(b, s, kvl, hd)
        v = (x @ params["wv"]).reshape(b, s, kvl, hd)
    else:
        k = ctx.all_gather_model(x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
        v = ctx.all_gather_model(x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, hd)

    positions = torch.arange(s, device=x.device)
    q = common.apply_rope(q, positions[None, :], cfg.rope_theta)
    k = common.apply_rope(k, positions[None, :], cfg.rope_theta)

    # local q heads → kv heads (the global head id depends on the shard)
    head0 = ctx.model_index() * hl
    if local_kv:
        kv_idx = [j // group for j in range(hl)]
    else:
        kv_idx = [min(head0 + j, cfg.num_heads - 1) // group for j in range(hl)]
    k_h, v_h = _heads(k, kv_idx), _heads(v, kv_idx)

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
    out = torch.cat(outs, dim=1)
    if head0 + hl > cfg.num_heads:
        # padded heads contribute nothing (and get no gradient)
        real = torch.arange(head0, head0 + hl, device=x.device) < cfg.num_heads
        out = torch.where(real[None, None, :, None], out, torch.zeros_like(out))
    out = out.reshape(b, s, hl * hd)
    return ctx.psum_model(out @ params["wo"])
