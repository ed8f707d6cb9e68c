"""Causal GQA self-attention for training, with Megatron-style tensor
parallelism (port of the train ``forward`` of ``repro.models.attention``).

Written as the JAX package writes it: queries in chunks of ``q_chunk``,
einsum scores against the full key sequence (or, under a sliding
``window``, against a ``window + q_chunk`` wide slice of it), a causal
mask and a softmax.  ``cfg.qk_norm`` RMS-normalises each query and key
head (``q_norm``/``k_norm``) before RoPE.

Sharding over the ``model`` axis:

* query heads are padded to a multiple of the model size and column-split;
  padded heads are masked out of the output (their weights get exactly
  zero gradient);
* ``wk``/``wv`` are column-split as plain matrices and all-gathered before
  attention, or, under ``cfg.tp_local_kv`` where the kv heads split evenly,
  kept local with no gather;
* ``wo`` is row-parallel: its output is summed over the model axis (*f*).

The decode and prefill paths wait for ROADMAP queue A, item 15 (its
decode half).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
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
    params = {
        "wq": common.dense_init((d, hq), d, generator, device, dtype),
        "wk": common.dense_init((d, hkv), d, generator, device, dtype),
        "wv": common.dense_init((d, hkv), d, generator, device, dtype),
        "wo": common.dense_init((hq, d), hq, generator, device, dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = common.rmsnorm_init(hd, device, dtype)
        params["k_norm"] = common.rmsnorm_init(hd, device, dtype)
    return params


def pspecs(cfg: ModelConfig):
    s = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qk_norm:
        s["q_norm"] = P(None)
        s["k_norm"] = P(None)
    return s


def mspecs(cfg: ModelConfig):
    s = {k: MatrixSpec("matrix", 0) for k in ("wq", "wk", "wv", "wo")}
    if cfg.qk_norm:
        s["q_norm"] = SPEC_NONE
        s["k_norm"] = SPEC_NONE
    return s


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
            *, q_chunk: int = 512, window: int = 0):
    """x: (B, S, d), replicated over the model axis → (B, S, d), likewise.

    ``window`` > 0 (and < S) attends each query to the ``window`` keys
    ending at its own position (sliding-window attention)."""
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

    if cfg.qk_norm:
        q = common.rmsnorm(q, params["q_norm"])
        k = common.rmsnorm(k, params["k_norm"])

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
    if window and window < s:
        out = _windowed_chunks(q, k_h, v_h, qc, window, scale)
    else:
        out = _full_chunks(q, k_h, v_h, qc, scale)
    if head0 + hl > cfg.num_heads:
        # padded heads contribute nothing (and get no gradient)
        real = torch.arange(head0, head0 + hl, device=x.device) < cfg.num_heads
        out = torch.where(real[None, None, :, None], out, torch.zeros_like(out))
    out = out.reshape(b, s, hl * hd)
    return ctx.psum_model(out @ params["wo"])


def _attend(qck, ks, vs, mask, scale):
    scores = torch.einsum("bqhd,bkhd->bhqk", qck, ks) * scale
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vs)


def _full_chunks(q, k, v, qc, scale):
    """Each chunk of ``qc`` queries against every key, causally masked."""
    s = k.shape[1]
    kpos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, q.shape[1], qc):
        qck = q[:, start:start + qc]
        qpos = start + torch.arange(qck.shape[1], device=q.device)
        outs.append(_attend(qck, k, v, qpos[:, None] >= kpos[None, :], scale))
    return torch.cat(outs, dim=1)


def _windowed_chunks(q, k, v, qc, window, scale):
    """Sliding window: each chunk of ``qc`` queries attends a static
    ``wpad + qc`` wide slice of the keys, left-padded by ``wpad`` (the
    window rounded up to whole chunks) so that every slice has that
    width, as the JAX package's ``_windowed_chunks`` does."""
    b, s, h, hd = k.shape
    wpad = ((window + qc - 1) // qc) * qc
    kv_span = wpad + qc
    # the slices reach past the last key where S is no multiple of qc
    tail = -(-s // qc) * qc - s
    pad = lambda t: torch.cat([t.new_zeros((b, wpad, h, hd)), t,
                               t.new_zeros((b, tail, h, hd))], dim=1)
    kp, vp = pad(k), pad(v)
    outs = []
    for start in range(0, q.shape[1], qc):
        qck = q[:, start:start + qc]
        qpos = start + torch.arange(qck.shape[1], device=q.device)
        kpos = start + torch.arange(kv_span, device=q.device) - wpad
        mask = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window)
                & (kpos[None, :] >= 0))
        outs.append(_attend(qck, kp[:, start:start + kv_span],
                            vp[:, start:start + kv_span], mask, scale))
    return torch.cat(outs, dim=1)
