"""Block stack: pre-norm residual blocks assembled from the period's layer
slots (port of the training half of ``repro.models.blocks``).

Every architecture is ``num_periods`` repetitions of a static tuple of
:class:`~repro_torch.configs.base.LayerSlot`: dense models have one slot,
Jamba eight (seven Mamba-2 and one attention mixer, MoE on every other
feed-forward).  A slot's mixer is ``"attn"`` or ``"mamba"``, its
feed-forward ``"dense"``, ``"moe"`` or ``"none"``.

Parameters of every period are stacked on a leading period dim, as in the
JAX package (which scans over it); the port loops over the periods.  The
period dim is never sharded (:func:`pspecs`) and joins the compressor's
batch (:func:`mspecs`).  ``remat=True`` recomputes each period's forward
in the backward (``torch.utils.checkpoint``, the twin of the reference's
``jax.checkpoint`` of its scan body); the decode and prefill stacks wait
for ROADMAP queue A, item 15 (its decode half).
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE
from repro_torch.models import attention, common, mamba2, mlp, moe
from repro_torch.sharding import P

MIXERS = ("attn", "mamba")
FFNS = ("dense", "moe", "none")


def _check_slot(slot) -> None:
    if slot.mixer not in MIXERS or slot.ffn not in FFNS:
        raise ValueError(f"unknown layer slot {slot}")


def _slot_init(slot, cfg: ModelConfig, generator, device, dtype, model_shards):
    _check_slot(slot)
    p = {"norm1": common.rmsnorm_init(cfg.d_model, device, dtype)}
    if slot.mixer == "attn":
        p["mixer"] = attention.init(cfg, generator, device, dtype,
                                    model_shards=model_shards)
    else:
        p["mixer"] = mamba2.init(cfg, generator, device, dtype)
    if slot.ffn != "none":
        p["norm2"] = common.rmsnorm_init(cfg.d_model, device, dtype)
        p["ffn"] = (moe.init(cfg, generator, device, dtype) if slot.ffn == "moe"
                    else mlp.init(cfg, generator, device, dtype))
    return p


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32,
         model_shards: int = 1):
    periods = [{f"slot{i}": _slot_init(s, cfg, generator, device, dtype,
                                       model_shards)
                for i, s in enumerate(cfg.slots)}
               for _ in range(cfg.num_periods)]
    return tree.map(common.stack, *periods)


def _slot_specs(slot, cfg: ModelConfig, spec_of, none):
    _check_slot(slot)
    p = {"norm1": none,
         "mixer": spec_of(attention if slot.mixer == "attn" else mamba2)}
    if slot.ffn != "none":
        p["norm2"] = none
        p["ffn"] = spec_of(moe if slot.ffn == "moe" else mlp)
    return p


def pspecs(cfg: ModelConfig):
    per = {f"slot{i}": _slot_specs(s, cfg, lambda m: m.pspecs(cfg), P(None))
           for i, s in enumerate(cfg.slots)}
    return common.tree_stackspec(per)  # prepend the period dim


def mspecs(cfg: ModelConfig):
    per = {f"slot{i}": _slot_specs(s, cfg, lambda m: m.mspecs(cfg), SPEC_NONE)
           for i, s in enumerate(cfg.slots)}
    return common.tree_stack_mspec(per)  # period dim joins the compressor batch


def _period(pparams, x, aux, cfg: ModelConfig, ctx: MeshCtx, window: int,
            q_chunk: int):
    """One period's slots: ``(x, aux)`` → ``(x, aux)``."""
    for i, slot in enumerate(cfg.slots):
        sp = pparams[f"slot{i}"]
        z = common.rmsnorm(x, sp["norm1"])
        if slot.mixer == "attn":
            x = x + attention.forward(sp["mixer"], z, cfg, ctx,
                                      q_chunk=q_chunk, window=window)
        else:
            x = x + mamba2.forward(sp["mixer"], z, cfg, ctx)
        if slot.ffn != "none":
            z = common.rmsnorm(x, sp["norm2"])
            if slot.ffn == "moe":
                y, a = moe.forward(sp["ffn"], z, cfg, ctx)
                x, aux = x + y, aux + a
            else:
                x = x + mlp.forward(sp["ffn"], z, cfg, ctx)
    return x, aux


def forward(params, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
            *, window: int = 0, q_chunk: int = 512, remat: bool = False):
    """x: (B, S, d) → ``(out (B, S, d), moe_aux_loss)``, the auxiliary loss
    summed over the MoE layers (a float32 zero without any).

    ``remat=True`` keeps only each period's input for the backward and
    runs the period's forward again there, every op of it (the
    recomputation does not stop early), so that a model axis sees each
    forward collective of the blocks twice a step
    (:func:`repro_torch.launch.train.tp_calls_per_step`).  The gradients
    are the same bits."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(cfg.num_periods):
        pparams = tree.map(lambda t: t[p], params)
        if remat:
            with torch_checkpoint.set_checkpoint_early_stop(False):
                x, aux = torch_checkpoint.checkpoint(
                    _period, pparams, x, aux, cfg, ctx, window, q_chunk,
                    use_reentrant=False)
        else:
            x, aux = _period(pparams, x, aux, cfg, ctx, window, q_chunk)
    return x, aux
