"""Data-parallel error-feedback training steps (port of ``TrainHyper``,
``make_train_step`` and ``make_sim_train_step`` of ``repro.launch.train``).

* :func:`make_train_step` — one worker per process over a
  ``torch.distributed`` process group (:class:`~repro_torch.core.dist.
  DistBackend`): each process computes the gradient of its own batch shard
  and the compressor's collectives are real ones.
* :func:`make_sim_train_step` — W workers in one process on one device
  (:class:`~repro_torch.core.simmesh.SimMesh`): each computes its gradient
  on its own batch shard, and the compressor aggregates over the stacked
  worker dim.

The command-line entry point and checkpointing wait for ROADMAP queue A,
item 10; the model axis (tensor parallelism) for item 14.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import error_feedback
from repro_torch.core.compressors import Compressor, PowerSGDCompressor
from repro_torch.core.dist import DistBackend, MeshCtx
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


def local_grads(cfg: ModelConfig, params, shard, *, q_chunk: int, device):
    """The gradient of one worker's loss on its batch ``shard`` (``(b, S)``
    leaves): a list of gradients in ``tree.leaves(params)`` order, and the
    worker's ``lm_loss``."""
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    shard = {k: v.to(device) for k, v in shard.items()}
    loss, metrics = model.loss_fn(tree.unflatten(params, live), shard, cfg,
                                  q_chunk=q_chunk)
    return list(torch.autograd.grad(loss, live)), metrics["lm_loss"].detach()


def worker_grads(cfg: ModelConfig, params, batch, workers: int, *,
                 q_chunk: int, device):
    """Each simulated worker's gradient on its own shard of ``batch``
    (``(W, b, S)`` leaves): a tree like ``params`` of ``(W,) + shape``
    gradients, and the list of the W worker losses."""
    grads = [torch.empty((workers,) + tuple(p.shape), device=p.device,
                         dtype=p.dtype) for p in tree.leaves(params)]
    losses = []
    for i in range(workers):
        local, loss = local_grads(cfg, params,
                                  {k: v[i] for k, v in batch.items()},
                                  q_chunk=q_chunk, device=device)
        for buf, g in zip(grads, local):
            buf[i].copy_(g)
        losses.append(loss)
        del local   # free this worker's gradients before the next backward
    return tree.unflatten(params, grads), losses


def _default_compressor(hyper: TrainHyper) -> Compressor:
    return PowerSGDCompressor(rank=hyper.rank,
                              orthogonalizer=hyper.orthogonalizer,
                              wire_dtype=hyper.wire_dtype)


def _make_step(cfg: ModelConfig, hyper: TrainHyper,
               compressor: Optional[Compressor], ctx: MeshCtx, grads_fn, dev):
    """``(step_fn, init_state)`` around ``grads_fn(params, batch)`` →
    (gradient tree with ``ctx.lead`` worker dims, worker-mean ``lm_loss``);
    the step body shared by both public builders."""
    if compressor is None:
        compressor = _default_compressor(hyper)
    mspec_tree = model.mspecs(cfg)

    def step_fn(params, ef_state: EFState, batch, generator=None):
        grads, loss = grads_fn(params, batch)
        lr = _schedule(hyper, ef_state.step)
        params, ef_state, aux = error_feedback.apply_updates(
            compressor, params, grads, ef_state, mspec_tree, lr=lr,
            momentum=hyper.momentum, weight_decay=hyper.weight_decay, ctx=ctx,
            generator=generator)
        metrics = {"lm_loss": loss, "lr": lr,
                   "bits_per_worker": aux["bits_per_worker"]}
        return params, ef_state, metrics

    def init_state(generator: Optional[torch.Generator] = None):
        params = model.init(cfg, generator, device=dev)
        return params, error_feedback.init_state(
            compressor, params, mspec_tree, lead=ctx.lead, generator=generator)

    return step_fn, init_state


def make_train_step(cfg: ModelConfig, hyper: TrainHyper,
                    compressor: Optional[Compressor] = None, group=None,
                    stats=None, device=None):
    """One data-parallel worker's error-feedback train step, one process per
    worker over the ``torch.distributed`` process group ``group`` (``None``:
    the default group).  Returns ``(step_fn, init_state)``.

    The caller creates the group, as the reference's caller creates its
    mesh: gloo for ``device="cpu"``, NCCL for the card (``device=None``);
    any other pairing raises.  ``compressor`` defaults as in
    :func:`make_sim_train_step`.  The reference's ``abstract_state`` (shapes
    and shardings without values) waits for the dry-run, ROADMAP queue A,
    item 16.

    ``step_fn(params, ef_state, batch, generator=None)`` →
    ``(params, ef_state, metrics)``.  ``batch`` is this worker's own shard
    ``(b, S)``.  Parameters, momentum and the compressor state stay
    identical on every worker; the error buffers are this worker's own, with
    no worker dim.  Parameters and momentum are updated in place.
    ``metrics["lm_loss"]`` is the loss averaged over the workers (an
    ``all_reduce`` outside ``stats``: metrics are not gradient traffic).

    ``init_state(generator)`` → ``(params, ef_state)``: random parameters
    (and PowerSGD factors) drawn from ``generator``, zero error buffers and
    momentum.  Every worker must pass a generator with the same seed, so
    that all start from the same parameters and factors.
    """
    dev = resolve_device(device)
    backend = DistBackend(group)
    backend.check_device(dev)
    ctx = MeshCtx(data_axes=("data",), stats=stats, backend=backend)

    def grads_fn(params, batch):
        grads, loss = local_grads(cfg, params, batch, q_chunk=hyper.q_chunk,
                                  device=dev)
        return tree.unflatten(params, grads), backend.pmean(loss)

    return _make_step(cfg, hyper, compressor, ctx, grads_fn, dev)


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
    w = sim.workers

    def grads_fn(params, batch):
        grads, losses = worker_grads(cfg, params, batch, w,
                                     q_chunk=hyper.q_chunk, device=dev)
        return grads, torch.stack(losses).mean()

    return _make_step(cfg, hyper, compressor, sim.ctx(stats=stats), grads_fn,
                      dev)
