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

Both take :class:`TrainHyper`; ``start_compress_step=k`` runs the first k
steps dense (one fused all-reduce of the whole gradient, error buffers
held at zero) before the compressor takes over, as
:func:`repro_torch.core.error_feedback.apply_updates` describes.

``rank_schedule`` and ``track_residual`` pass to the default PowerSGD
compressor.  The schedule is driven by the caller's loop, between steps:

    comp = PowerSGDCompressor(rank_schedule="2@0,4@100", track_residual=True)
    step, init = make_sim_train_step(cfg, sim, hyper, compressor=comp)
    ctl, residual = comp.controller(), None
    for i, batch in enumerate(batches):
        new_comp, changed = ctl.update(ef.comp, i, residual)
        if changed:
            ef = error_feedback.replace_comp(ef, new_comp)
        params, ef, metrics = step(params, ef, batch)
        residual = metrics["residual_ratio"].item()

``metrics["residual_ratio"]`` is the workers' residual ratios averaged as
the loss is, outside ``stats``, so every rank sees the same value and
takes the same switch.

The command-line entry point and checkpointing wait for ROADMAP queue A,
item 10; the model axis (tensor parallelism) for ROADMAP queue A, item 14.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import error_feedback
from repro_torch.core.compressors import Compressor, PowerSGDCompressor
from repro_torch.core.dist import DistBackend, MeshCtx
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
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
    bucketing: str = "auto"         # "auto"/"on" = bucketed engine, "off" = per-leaf
    wire_dtype: str = "auto"
    start_compress_step: int = 0    # dense warm-up steps before compression
    rank_schedule: Optional[str] = None  # adaptive-rank spec ("4@0,2@60",
    #   "residual:min=1,max=8", ...; repro_torch.core.powersgd.parse_schedule),
    #   driven by the host loop: a RankController from the compressor
    #   transitions ef.comp between steps
    track_residual: bool = False    # residual_ratio in the step's metrics


def _schedule(hyper: TrainHyper, step: int) -> float:
    return schedules.linear_warmup(step, hyper.lr, hyper.warmup_steps, 0.1)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def grad_with_aux(loss_fn: Callable) -> Callable:
    """The twin of ``jax.grad(loss_fn, has_aux=True)``: for
    ``loss_fn(params, *args, **kw)`` → ``(loss, aux)``, a function of the
    same arguments returning ``(grads, aux)``, ``grads`` a tree like
    ``params`` of the loss's gradient with respect to every leaf and
    ``aux`` with its tensors detached."""
    def grad(params, *args, **kw):
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, aux = loss_fn(tree.unflatten(params, live), *args, **kw)
        grads = torch.autograd.grad(loss, live)
        return (tree.unflatten(params, list(grads)),
                tree.map_nest(lambda x: x.detach(), aux))
    return grad


def local_grads(cfg: ModelConfig, params, shard, *, q_chunk: int, device):
    """The gradient of one worker's loss on its batch ``shard`` (``(b, S)``
    leaves): a list of gradients in ``tree.leaves(params)`` order, and the
    worker's ``lm_loss``."""
    shard = {k: v.to(device) for k, v in shard.items()}
    grads, metrics = grad_with_aux(model.loss_fn)(params, shard, cfg,
                                                  q_chunk=q_chunk)
    return tree.leaves(grads), metrics["lm_loss"]


def worker_grads(cfg: ModelConfig, params, batch, workers: int, *,
                 q_chunk: int, device):
    """Each simulated worker's gradient on its own shard of ``batch``
    (``(W, b, S)`` leaves): a tree like ``params`` of ``(W,) + shape``
    gradients, and the ``(W,)`` worker losses."""
    grads, losses = SimMesh(workers).run(
        lambda shard: local_grads(cfg, params, shard, q_chunk=q_chunk,
                                  device=device))(batch)
    return tree.unflatten(params, grads), losses


def _default_compressor(hyper: TrainHyper) -> Compressor:
    return PowerSGDCompressor(rank=hyper.rank,
                              orthogonalizer=hyper.orthogonalizer,
                              bucketing=hyper.bucketing,
                              wire_dtype=hyper.wire_dtype,
                              rank_schedule=hyper.rank_schedule,
                              track_residual=hyper.track_residual)


def _make_step(cfg: ModelConfig, hyper: TrainHyper,
               compressor: Optional[Compressor], lead, grads_fn, dev):
    """``(step_fn, init_state)`` around ``grads_fn(params, batch)`` →
    (gradient tree with ``lead`` worker dims, the workers' ``lm_loss``);
    ``step_fn(params, ef_state, batch, ctx, seed)`` is the step body shared
    by both public builders, run under the step's context ``ctx``."""
    if compressor is None:
        compressor = _default_compressor(hyper)
    mspec_tree = model.mspecs(cfg)

    def step_fn(params, ef_state: EFState, batch, ctx: MeshCtx, seed=None):
        grads, losses = grads_fn(params, batch)
        # metrics aggregate through the backend directly: they are not
        # gradient traffic, so ``stats`` does not record them
        loss = ctx.backend.pmean(losses)
        lr = _schedule(hyper, ef_state.step)
        params, ef_state, aux = error_feedback.apply_updates(
            compressor, params, grads, ef_state, mspec_tree, lr=lr,
            momentum=hyper.momentum, weight_decay=hyper.weight_decay, ctx=ctx,
            seed=seed, start_compress_step=hyper.start_compress_step)
        metrics = {"lm_loss": loss, "lr": lr,
                   "bits_per_worker": aux["bits_per_worker"]}
        if "residual_ratio" in aux:   # what a host-side RankController reads
            metrics["residual_ratio"] = ctx.backend.pmean(aux["residual_ratio"])
        return params, ef_state, metrics

    def init_state(generator: Optional[torch.Generator] = None):
        params = model.init(cfg, generator, device=dev)
        return params, error_feedback.init_state(
            compressor, params, mspec_tree, lead=lead, generator=generator)

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

    ``step_fn(params, ef_state, batch, seed=None)`` →
    ``(params, ef_state, metrics)``.  ``batch`` is this worker's own shard
    ``(b, S)``; ``seed`` is the run's base seed for shared-seed draws (the
    same on every rank; the step index is folded in, see
    :func:`repro_torch.core.error_feedback.apply_updates`).  Parameters, momentum and the compressor state stay
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
        return tree.unflatten(params, grads), loss

    body, init_state = _make_step(cfg, hyper, compressor, ctx.lead, grads_fn,
                                  dev)

    def step_fn(params, ef_state: EFState, batch, seed=None):
        return body(params, ef_state, batch, ctx, seed)

    return step_fn, init_state


def make_sim_train_step(cfg: ModelConfig, sim, hyper: TrainHyper,
                        compressor: Optional[Compressor] = None,
                        stats=None, device=None):
    """W-worker error-feedback train step on a :class:`~repro_torch.core.
    simmesh.SimMesh`.  Returns ``(step_fn, init_state)``.

    ``compressor`` defaults to rank-``hyper.rank`` PowerSGD on the
    ``hyper.wire_dtype`` wire; any compressor of
    :func:`repro_torch.core.compressors.make_compressor` (e.g. ``"top_k"``
    with ``wire_dtype="int4"``) drops in.

    ``step_fn(params, ef_state, batch, seed=None, weights=None)`` →
    ``(params, ef_state, metrics)``.  ``batch`` holds per-worker shards
    ``(W, b, S)`` (:meth:`SimMesh.shard`); ``seed`` as in
    :func:`make_train_step`.  ``weights`` is an optional ``(W,)`` vector
    of the workers' scenario weights for this step (checked, then moved to
    the step's device as float32; see :meth:`SimMesh.ctx`): every
    aggregate is then the weighted mean ``Σ wᵢxᵢ / Σ wᵢ``.  0 drops a
    worker from this round's aggregates, while its own error buffer still
    updates from its own Δ, against the round's reconstruction; for
    heterogeneous batches pass each worker's valid-token count.  ``None``
    is uniform, plain means.  Parameters, momentum and the compressor
    state are worker-identical and held once; the error buffers carry the
    worker dim.  Parameters and momentum are updated in place.
    ``metrics["lm_loss"]`` is the workers' loss averaged as the aggregates
    are (weighted under ``weights``).

    ``init_state(generator)`` → ``(params, ef_state)``: random parameters
    (and PowerSGD factors) drawn from ``generator``, zero error buffers and
    momentum.
    """
    dev = resolve_device(device)
    w = sim.workers

    def grads_fn(params, batch):
        return worker_grads(cfg, params, batch, w, q_chunk=hyper.q_chunk,
                            device=dev)

    body, init_state = _make_step(cfg, hyper, compressor, (w,), grads_fn, dev)

    def step_fn(params, ef_state: EFState, batch, seed=None, weights=None):
        return body(params, ef_state, batch,
                    sim.ctx(stats=stats, weights=weights, device=dev), seed)

    return step_fn, init_state
