"""Language model: embedding (and a vision frontend's projected patches) →
block stack → final norm → head, and the training loss (port of
``padded_vocab``, ``init``, ``pspecs``, ``mspecs``, ``embed_inputs`` and
``loss_fn`` of ``repro.models.model``).

:func:`init` draws the global parameters (heads and vocabulary padded to
``model_shards``); :func:`pspecs` says how the model axis splits them, and
:func:`loss_fn` runs on a rank's local slices under the step's
:class:`~repro_torch.core.dist.MeshCtx` (``SINGLE``: the whole model).

Every registered architecture trains through it: dense, MoE
(:mod:`repro_torch.models.moe`), Mamba-2 (:mod:`repro_torch.models.mamba2`),
the hybrid and the vision stub.  The paper's own models are ported beside
it: :mod:`repro_torch.models.resnet` and :mod:`repro_torch.models.lstm`.
:func:`init_cache`, :func:`decode_step` and :func:`prefill_step` raise:
they wait for ROADMAP queue A, item 15 (its decode half)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
from repro_torch.models import blocks, common
from repro_torch.sharding import P


def has_moe(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has MoE layers (an auxiliary loss that is not 0)."""
    return any(s.ffn == "moe" for s in cfg.slots)


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
    params = {
        "embed": common.embed_init(v, d, generator, device, dtype),
        "blocks": blocks.init(cfg, generator, device, dtype,
                              model_shards=model_shards),
        "final_norm": common.rmsnorm_init(d, device, dtype),
        "head": common.dense_init((d, v), d, generator, device, dtype),
    }
    if cfg.frontend == "vision":
        params["frontend_proj"] = common.dense_init(
            (cfg.frontend_dim, d), cfg.frontend_dim, generator, device, dtype)
    return params


def pspecs(cfg: ModelConfig):
    s = {
        "embed": P("model", None),
        "blocks": blocks.pspecs(cfg),
        "final_norm": P(None),
        "head": P(None, "model"),
    }
    if cfg.frontend == "vision":
        s["frontend_proj"] = P(None, None)
    return s


def mspecs(cfg: ModelConfig):
    s = {
        "embed": MatrixSpec("matrix", 0),
        "blocks": blocks.mspecs(cfg),
        "final_norm": SPEC_NONE,
        "head": MatrixSpec("matrix", 0),
    }
    if cfg.frontend == "vision":
        s["frontend_proj"] = MatrixSpec("matrix", 0)
    return s


def embed_inputs(params, batch, cfg: ModelConfig, ctx: MeshCtx = SINGLE):
    """batch: ``{"tokens": (B, S)}`` and, for a VLM, ``{"patches": (B,
    S_img, frontend_dim)}``: the projected patches form the sequence
    prefix (anyres tiles), the text tokens follow."""
    x = common.embed_lookup(params["embed"], batch["tokens"], ctx)
    if cfg.frontend == "vision" and "patches" in batch:
        proj = batch["patches"].to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([proj, x], dim=1)
    return x


def loss_fn(params, batch, cfg: ModelConfig, ctx: MeshCtx = SINGLE, *,
            window: int = 0, q_chunk: int = 512, remat: bool = False):
    """batch: tokens (B, S), labels (B, S) [-1 = masked], optional patches.

    Returns ``(total, metrics)``: ``total = lm_loss + moe_aux_weight ·
    moe_aux``, where ``lm_loss`` is the mean over this worker's unmasked
    text tokens (the per-worker stochastic gradient PowerSGD compresses)
    and ``moe_aux`` the MoE layers' summed load-balance loss (0 without
    any), both in ``metrics`` and replicated over the model axis.
    ``window`` and ``remat`` as in :func:`repro_torch.models.blocks.forward`."""
    x = embed_inputs(params, batch, cfg, ctx)
    x, moe_aux = blocks.forward(params["blocks"], x, cfg, ctx, window=window,
                                q_chunk=q_chunk, remat=remat)
    x = common.rmsnorm(x, params["final_norm"])
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        # patches carry no LM loss: score only the text suffix
        x = x[:, batch["patches"].shape[1]:]
    logits_local = common.grad_synced(x, ctx) @ params["head"]
    tok_loss = common.sharded_softmax_xent(logits_local, labels, ctx,
                                           cfg.vocab_size)
    mask = (labels >= 0).float()
    loss = torch.sum(tok_loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + cfg.moe_aux_weight * moe_aux
    return total, {"lm_loss": loss, "moe_aux": moe_aux}


def _decode_not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"model.{name} is not ported yet (ROADMAP queue A, item 15: the "
            f"decode and prefill paths)")
    stub.__name__ = name
    stub.__doc__ = (f"The reference's ``{name}``; raises until ROADMAP "
                    f"queue A, item 15 (its decode half) ports it.")
    return stub


init_cache = _decode_not_ported("init_cache")
decode_step = _decode_not_ported("decode_step")
prefill_step = _decode_not_ported("prefill_step")
