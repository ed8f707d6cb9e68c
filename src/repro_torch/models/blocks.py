"""Block stack: pre-norm residual blocks assembled from the period's layer
slots (port of ``repro.models.blocks``, attention + dense slots).

Parameters of every period are stacked on a leading period dim, as in the
JAX package (which scans over it); the port loops over the periods.  The
period dim is never sharded (:func:`pspecs`) and joins the compressor's
batch (:func:`mspecs`).
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE
from repro_torch.models import attention, common, mlp
from repro_torch.sharding import P


def _check_slots(cfg: ModelConfig) -> None:
    for s in cfg.slots:
        if (s.mixer, s.ffn) != ("attn", "dense"):
            raise NotImplementedError(
                f"layer slot {s} is not ported yet (ROADMAP queue A, item 15)")


def _slot_init(cfg: ModelConfig, generator, device, dtype, model_shards):
    return {
        "norm1": common.rmsnorm_init(cfg.d_model, device, dtype),
        "mixer": attention.init(cfg, generator, device, dtype,
                                model_shards=model_shards),
        "norm2": common.rmsnorm_init(cfg.d_model, device, dtype),
        "ffn": mlp.init(cfg, generator, device, dtype),
    }


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32,
         model_shards: int = 1):
    _check_slots(cfg)
    periods = [{f"slot{i}": _slot_init(cfg, generator, device, dtype,
                                       model_shards)
                for i in range(cfg.period)} for _ in range(cfg.num_periods)]
    return tree.map(common.stack, *periods)


def pspecs(cfg: ModelConfig):
    per = {f"slot{i}": {"norm1": P(None), "mixer": attention.pspecs(cfg),
                        "norm2": P(None), "ffn": mlp.pspecs(cfg)}
           for i in range(cfg.period)}
    return common.tree_stackspec(per)  # prepend the period dim


def mspecs(cfg: ModelConfig):
    per = {f"slot{i}": {"norm1": SPEC_NONE, "mixer": attention.mspecs(cfg),
                        "norm2": SPEC_NONE, "ffn": mlp.mspecs(cfg)}
           for i in range(cfg.period)}
    return common.tree_stack_mspec(per)  # period dim joins the compressor batch


def forward(params, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
            *, q_chunk: int = 512) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d)."""
    _check_slots(cfg)
    for p in range(cfg.num_periods):
        pparams = tree.map(lambda t: t[p], params)
        for i in range(cfg.period):
            sp = pparams[f"slot{i}"]
            z = common.rmsnorm(x, sp["norm1"])
            x = x + attention.forward(sp["mixer"], z, cfg, ctx, q_chunk=q_chunk)
            z = common.rmsnorm(x, sp["norm2"])
            x = x + mlp.forward(sp["ffn"], z, cfg, ctx)
    return x
