"""Simulated data-parallel error-feedback training step (port of
``TrainHyper`` and ``make_sim_train_step`` of ``repro.launch.train``).

W workers run in one process on one device (:class:`~repro_torch.core.
simmesh.SimMesh`): each computes its gradient on its own batch shard, and
the compressor aggregates over the stacked worker dim.  The command-line
entry point, checkpointing and a ``torch.distributed`` step wait for
ROADMAP queue A, items 13 and 17.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import error_feedback
from repro_torch.core.compressors import Compressor, PowerSGDCompressor
from repro_torch.core.error_feedback import EFState
from repro_torch.models import model
from repro_torch.optim import schedules


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    rank: int = 2
    q_chunk: int = 512
    orthogonalizer: str = "gram_schmidt"
    wire_dtype: str = "auto"


def _schedule(hyper: TrainHyper, step: int) -> float:
    return schedules.linear_warmup(step, hyper.lr, hyper.warmup_steps, 0.1)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def make_sim_train_step(cfg: ModelConfig, sim, hyper: TrainHyper,
                        compressor: Optional[Compressor] = None,
                        stats=None, device=None):
    """W-worker error-feedback train step on a :class:`~repro_torch.core.
    simmesh.SimMesh`.  Returns ``(step_fn, init_state)``.

    ``compressor`` defaults to rank-``hyper.rank`` PowerSGD on the
    ``hyper.wire_dtype`` wire; any compressor of
    :func:`repro_torch.core.compressors.make_compressor` (e.g. ``"top_k"``
    with ``wire_dtype="int4"``) drops in.

    ``step_fn(params, ef_state, batch, generator=None)`` →
    ``(params, ef_state, metrics)``.  ``batch`` holds per-worker shards
    ``(W, b, S)`` (:meth:`SimMesh.shard`).  Parameters, momentum and the
    compressor state are worker-identical and held once; the error
    buffers carry the worker dim.  Parameters and momentum are updated in
    place.  ``metrics["lm_loss"]`` is the worker-mean loss.

    ``init_state(generator)`` → ``(params, ef_state)``: random parameters
    (and PowerSGD factors) drawn from ``generator``, zero error buffers and
    momentum.
    """
    dev = resolve_device(device)
    if compressor is None:
        compressor = PowerSGDCompressor(rank=hyper.rank,
                                        orthogonalizer=hyper.orthogonalizer,
                                        wire_dtype=hyper.wire_dtype)
    mspec_tree = model.mspecs(cfg)
    ctx = sim.ctx(stats=stats)
    w = sim.workers

    def step_fn(params, ef_state: EFState, batch, generator=None):
        flat = tree.leaves(params)
        grads = [torch.empty((w,) + tuple(p.shape), device=p.device,
                             dtype=p.dtype) for p in flat]
        losses = []
        for i in range(w):
            live = [p.detach().requires_grad_(True) for p in flat]
            shard = {k: v[i].to(dev) for k, v in batch.items()}
            loss, metrics = model.loss_fn(tree.unflatten(params, live), shard,
                                          cfg, q_chunk=hyper.q_chunk)
            for buf, g in zip(grads, torch.autograd.grad(loss, live)):
                buf[i].copy_(g)
            losses.append(metrics["lm_loss"].detach())
        lr = _schedule(hyper, ef_state.step)
        params, ef_state, aux = error_feedback.apply_updates(
            compressor, params, tree.unflatten(params, grads), ef_state,
            mspec_tree, lr=lr, momentum=hyper.momentum,
            weight_decay=hyper.weight_decay, ctx=ctx, generator=generator)
        metrics = {"lm_loss": torch.stack(losses).mean(), "lr": lr,
                   "bits_per_worker": aux["bits_per_worker"]}
        return params, ef_state, metrics

    def init_state(generator: Optional[torch.Generator] = None):
        params = model.init(cfg, generator, device=dev)
        return params, error_feedback.init_state(
            compressor, params, mspec_tree, lead=ctx.lead, generator=generator)

    return step_fn, init_state
