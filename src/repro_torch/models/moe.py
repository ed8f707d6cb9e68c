"""Mixture-of-Experts layer with top-k routing, capacity-based dispatch and
expert parallelism over the ``model`` axis (port of ``repro.models.moe``).

Activations are replicated within a model group (Megatron's pattern), so
each rank holds E/model_shards experts and processes the tokens routed to
*its* experts, with no all-to-all: the expert outputs combine with one
``psum_model`` (*f*).  The router is replicated; *g*
(:func:`~repro_torch.models.common.grad_synced`) on the gate path sums the
per-rank partial cotangents, so its gradient is whole and equal on every
model rank.

Dispatch is the capacity-factor scheme: per expert the first
C = ceil(T·k/E · cf) routed (token, slot) pairs in routing order are kept
(C clamped to [8, T]), the rest dropped (their residual path passes
through).  The auxiliary load-balance loss is Switch/GShard's
E · Σ_e f_e · p_e.

Every gather and scatter that repeats an index is written as an expand or
a sum over the top-k dim (each token's k slots are consecutive in routing
order), so the backward on the card is deterministic: an indexed add with
repeated indices adds with atomics there, in an order that changes from
run to run.  The one indexed write left, the dispatch into the expert
buffer, writes each kept pair to a slot of its own; only the discarded
dump row repeats.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import MatrixSpec
from repro_torch.models import common
from repro_torch.sharding import P


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    return {
        "router": common.dense_init((d, e), d, generator, device, dtype),
        "w_gate": common.dense_init((e, d, ff), d, generator, device, dtype),
        "w_up": common.dense_init((e, d, ff), d, generator, device, dtype),
        "w_down": common.dense_init((e, ff, d), ff, generator, device, dtype),
    }


def pspecs(cfg: ModelConfig):
    return {
        "router": P(None, None),
        "w_gate": P("model", None, None),
        "w_up": P("model", None, None),
        "w_down": P("model", None, None),
    }


def mspecs(cfg: ModelConfig):
    return {
        "router": MatrixSpec("matrix", 0),
        "w_gate": MatrixSpec("matrix", 1),   # expert dim is a compressor batch dim
        "w_up": MatrixSpec("matrix", 1),
        "w_down": MatrixSpec("matrix", 1),
    }


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts
                      * cfg.moe_capacity_factor))
    return max(8, min(c, tokens))


def forward(params, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
            *, dropless: bool = False):
    """x: (B, S, d) replicated over the model axis.  Returns ``(out,
    aux_loss)``, ``out`` replicated likewise.

    ``dropless=True`` sizes every expert's buffer to the full token count,
    so that no (token, expert) pair is dropped (inference); training uses
    the capacity-factor scheme."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    e_local = params["w_gate"].shape[0]
    cap = t if dropless else capacity(cfg, t)

    xt = x.reshape(t, d)
    logits = (xt @ params["router"]).float()                 # (T, E)
    # the gates are consumed inside the rank-local dispatch and combine, so
    # each rank's backward gives only its experts' share of their cotangent
    # (g sums it); the aux loss is replicated math and reads the unwrapped
    # logits
    probs = torch.softmax(common.grad_synced(logits, ctx), dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1, sorted=True)  # (T, k)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)

    # aux load-balance loss (replicated; from this worker's tokens)
    fe = experts.reshape(-1)                                 # (T·k,) routing order
    onehot = F.one_hot(fe, e)                                # (T·k, E)
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)    # (E,)
    ce = onehot.sum(0).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # capacity positions: the rank of each (token, slot) within its expert
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    keep = pos < cap

    # dispatch to the local experts (the dump slot e_local·cap is dropped)
    lo = ctx.model_index() * e_local
    local = (fe >= lo) & (fe < lo + e_local) & keep
    slot = torch.where(local, (fe - lo) * cap + pos,
                       torch.full_like(fe, e_local * cap))
    xt_local = common.grad_synced(xt, ctx)    # entering rank-local experts
    src = xt_local[:, None].expand(t, k, d).reshape(t * k, d)
    src = torch.where(local[:, None], src, torch.zeros_like(src))
    buf = x.new_zeros((e_local * cap + 1, d)).index_add(0, slot, src)
    h = buf[: e_local * cap].reshape(e_local, cap, d)

    # expert FFNs (SwiGLU), one batched product per weight
    g = F.silu(torch.bmm(h, params["w_gate"]))
    u = torch.bmm(h, params["w_up"])
    y = torch.bmm(g * u, params["w_down"]).reshape(e_local * cap, d)
    y = torch.cat([y, y.new_zeros((1, d))], dim=0)

    # combine: gather back, weight by gate, sum over the k slots and shards
    g_flat = gates.reshape(-1)
    contrib = y[slot] * torch.where(local, g_flat, torch.zeros_like(g_flat))[:, None]
    out = contrib.view(t, k, d).sum(dim=1)
    out = ctx.psum_model(out)
    return out.reshape(b, s, d), aux
