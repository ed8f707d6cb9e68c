"""Error-feedback training steps (port of ``TrainHyper``,
``make_train_step``, ``train_state_partition`` and ``make_sim_train_step``
of ``repro.launch.train``).

* :func:`make_train_step` — one worker per process over a
  ``torch.distributed`` process group (:class:`~repro_torch.core.dist.
  DistBackend`): each process computes the gradient of its own batch shard
  and the compressor's collectives are real ones.  Given a
  :class:`~repro_torch.launch.mesh.Mesh`, the processes form a (data,
  model) grid: the model's weights are split over the model axis
  (Megatron-style tensor parallelism, :mod:`repro_torch.models`), each
  rank compresses its local shards, and the compressor's collectives span
  the data axis only.
* :func:`make_sim_train_step` — W workers in one process on one device
  (:class:`~repro_torch.core.simmesh.SimMesh`): each computes its gradient
  on its own batch shard, and the compressor aggregates over the stacked
  worker dim.

Both take :class:`TrainHyper`; ``start_compress_step=k`` runs the first k
steps dense (one fused all-reduce of the whole gradient, error buffers
held at zero) before the compressor takes over, and
``staleness="one_step"`` applies each step's aggregate one step late (the
in-flight tree in ``EFState.inflight``, the default compressor on the
double-buffered transport), as
:func:`repro_torch.core.error_feedback.apply_updates` describes.
``sync_mode="broadcast"`` makes every aggregate replica-deterministic (the
canonical reduce and the rank-0 broadcast of
:class:`~repro_torch.core.dist.MeshCtx`), and ``track_drift`` adds the
``drift_params``, ``drift_momentum``, ``drift_error`` and ``drift_q``
metrics (:func:`replica_drift`).

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

:func:`main` is the command-line entry point, ``python -m
repro_torch.launch.train``: the JAX package's flags, printed lines,
checkpoints (:mod:`repro_torch.checkpoint`, envelopes either package
reads) and resume guards, one process per worker, ``--sync-mode
broadcast`` included.  Four or more processes form a (world/2, 2) grid,
as the JAX CLI forms its mesh, and save, resume and drive rank schedules
on it as the JAX CLI does: :func:`~repro_torch.checkpoint.train_state.
canonicalize_mesh` before a save, :func:`global_template` →
:func:`~repro_torch.checkpoint.train_state.stack_model_template` →
``restore_train_state(model_axis_size=M)`` →
:func:`~repro_torch.checkpoint.train_state.replicate_mesh` at a resume, and
the controller given the state's partition and the rank's model
coordinate.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as tdist

from repro_torch import tree
from repro_torch.checkpoint import train_state as ts
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import dist, error_feedback, matrixize
from repro_torch.core.compressors import Compressor, PowerSGDCompressor
from repro_torch.core.dist import SINGLE, DistBackend, MeshCtx
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import model
from repro_torch.optim import schedules
from repro_torch.sharding import shard_tree


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    rank: int = 2
    q_chunk: int = 512
    window: int = 0                 # sliding-window attention (0 = full)
    remat: bool = False             # recompute each period's forward in the
    #   backward (the reference defaults to True; the port keeps every
    #   existing path without recomputation, ROADMAP C6: the gradients are
    #   the same bits either way)
    orthogonalizer: str = "gram_schmidt"
    bucketing: str = "auto"         # "auto"/"on" = bucketed engine, "off" = per-leaf
    wire_dtype: str = "auto"
    start_compress_step: int = 0    # dense warm-up steps before compression
    rank_schedule: Optional[str] = None  # adaptive-rank spec ("4@0,2@60",
    #   "residual:min=1,max=8", ...; repro_torch.core.powersgd.parse_schedule),
    #   driven by the host loop: a RankController from the compressor
    #   transitions ef.comp between steps
    track_residual: bool = False    # residual_ratio in the step's metrics
    staleness: str = "none"         # "one_step" = delayed-parameter-update
    #   pipeline: apply step t−1's aggregate while step t's is formed, the
    #   in-flight aggregate carried in EFState.inflight and the default
    #   compressor on the double-buffered PipelinedTransport
    sync_mode: str = "allreduce"    # "broadcast" = replica-deterministic
    #   data-axis aggregation (canonical reduction order + rank-0 broadcast;
    #   see repro_torch.core.dist.MeshCtx) — bit-identical replicas where
    #   the library's all-reduce order depends on the rank
    track_drift: bool = False       # drift_{params,momentum,error,q} in the
    #   step's metrics: the largest difference of each tree from rank 0's
    tp_grad_sync: bool = True       # the model axis's g/f pair (models/
    #   common.grad_synced); False is the reference's legacy debug switch,
    #   whose replicated gradients are per-model-rank partial sums


def _schedule(hyper: TrainHyper, step: int) -> float:
    return schedules.linear_warmup(step, hyper.lr, hyper.warmup_steps, 0.1)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def replica_drift(ctx: MeshCtx, t, per_worker: bool = False) -> torch.Tensor:
    """The largest absolute difference, in float32, of ``t``'s float leaves
    from rank 0's copies over the data ranks: the drift probe behind
    ``TrainHyper.track_drift``.  Rank 0's copy comes from the backend's
    ``broadcast0`` and the worst difference from its ``pmax``, called on
    the backend directly, so ``stats`` records neither.  Exactly 0.0
    certifies bit-identical replicas of those leaves this step.

    ``per_worker``: under :class:`~repro_torch.core.dist.SimBackend` the
    leaves carry the worker dim (the error buffers) and each worker's row
    is held against worker 0's; otherwise they are held once (parameters,
    momentum, factors) and compared with worker 0's copy of themselves.
    Under :class:`~repro_torch.core.dist.DistBackend` each leaf is the
    process's own.  A tree without float leaves drifts 0.0."""
    stacked = per_worker and bool(ctx.lead)
    drifts = []
    for x in tree.leaves(t):
        if x is None or not x.is_floating_point():
            continue
        x = x.float()
        ref = ctx.backend.broadcast0(x, stacked=stacked)
        drifts += [torch.linalg.vector_norm(row - ref, ord=math.inf)
                   for row in (x if stacked else (x,))]
    if not drifts:
        return torch.zeros((), dtype=torch.float32)
    # the worst over this process's copies, then over the data ranks (each
    # simulated worker holds that value)
    return ctx.backend.pmax(torch.stack(drifts).amax().expand(ctx.lead))


def grad_with_aux(loss_fn: Callable) -> Callable:
    """The twin of ``jax.grad(loss_fn, has_aux=True)``: for
    ``loss_fn(params, *args, **kw)`` → ``(loss, aux)``, a function of the
    same arguments returning ``(grads, aux)``, ``grads`` a tree like
    ``params`` of the loss's gradient with respect to every leaf (zeros
    where the loss does not use it) and
    ``aux`` with its tensors detached."""
    def grad(params, *args, **kw):
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, aux = loss_fn(tree.unflatten(params, live), *args, **kw)
        # a leaf the loss does not use (a vision frontend's projection on a
        # batch without patches) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        return (tree.unflatten(params, list(grads)),
                tree.map_nest(lambda x: x.detach(), aux))
    return grad


def local_grads(cfg: ModelConfig, params, shard, *, q_chunk: int, device,
                ctx: MeshCtx = SINGLE, window: int = 0, remat: bool = False):
    """The gradient of one worker's total loss (``lm_loss`` plus the
    weighted MoE auxiliary loss, :func:`repro_torch.models.model.loss_fn`)
    on its batch ``shard`` (``(b, S)`` leaves): a list of gradients in
    ``tree.leaves(params)`` order, and the worker's metrics, the dict of
    its ``lm_loss`` and ``moe_aux``.  Under a
    model axis (``ctx``) ``params`` are the rank's local shards and so are
    the gradients."""
    shard = {k: v.to(device) for k, v in shard.items()}
    grads, metrics = grad_with_aux(model.loss_fn)(
        params, shard, cfg, ctx, window=window, q_chunk=q_chunk, remat=remat)
    return tree.leaves(grads), metrics


def worker_grads(cfg: ModelConfig, params, batch, workers: int, *,
                 q_chunk: int, device, window: int = 0, remat: bool = False):
    """Each simulated worker's gradient on its own shard of ``batch``
    (``(W, b, S)`` leaves): a tree like ``params`` of ``(W,) + shape``
    gradients, and the workers' metrics, the dict of their ``(W,)``
    ``lm_loss`` and ``moe_aux``."""
    grads, losses = SimMesh(workers).run(
        lambda shard: local_grads(cfg, params, shard, q_chunk=q_chunk,
                                  device=device, window=window,
                                  remat=remat))(batch)
    return tree.unflatten(params, grads), losses


def _default_compressor(hyper: TrainHyper) -> Compressor:
    return PowerSGDCompressor(rank=hyper.rank,
                              orthogonalizer=hyper.orthogonalizer,
                              bucketing=hyper.bucketing,
                              wire_dtype=hyper.wire_dtype,
                              rank_schedule=hyper.rank_schedule,
                              track_residual=hyper.track_residual,
                              pipeline=hyper.staleness == "one_step")


def _make_step(cfg: ModelConfig, hyper: TrainHyper,
               compressor: Optional[Compressor], lead, grads_fn, dev,
               mesh=None):
    """``(step_fn, init_state)`` around ``grads_fn(params, batch)`` →
    (gradient tree with ``lead`` worker dims, the workers' ``lm_loss`` and
    ``moe_aux``);
    ``step_fn(params, ef_state, batch, ctx, seed)`` is the step body shared
    by both public builders, run under the step's context ``ctx``.  With a
    ``mesh``, the state is this rank's shards (``init_state`` slices the
    global draw by :func:`train_state_partition`'s specs), and the metrics
    are averaged (the drifts maxed) over the model axis after the data
    axis."""
    if compressor is None:
        compressor = _default_compressor(hyper)
    mspec_tree = model.mspecs(cfg)
    m_size = 1 if mesh is None else mesh.shape["model"]
    parts = None
    if mesh is not None:
        parts = train_state_partition(cfg, mesh, compressor, hyper.staleness)
        if hasattr(compressor, "bind_state_partition"):
            compressor.bind_state_partition(parts.comp)

    def step_fn(params, ef_state: EFState, batch, ctx: MeshCtx, seed=None):
        grads, worker_metrics = grads_fn(params, batch)
        # metrics aggregate through the backend directly: they are not
        # gradient traffic, so ``stats`` does not record them
        loss = ctx.pmean_model(ctx.backend.pmean(worker_metrics["lm_loss"]))
        # without MoE layers the auxiliary loss is 0 on every worker: no call
        aux_loss = (ctx.pmean_model(ctx.backend.pmean(worker_metrics["moe_aux"]))
                    if model.has_moe(cfg) else torch.zeros((), device=dev))
        lr = _schedule(hyper, ef_state.step)
        params, ef_state, aux = error_feedback.apply_updates(
            compressor, params, grads, ef_state, mspec_tree, lr=lr,
            momentum=hyper.momentum, weight_decay=hyper.weight_decay, ctx=ctx,
            seed=seed, start_compress_step=hyper.start_compress_step,
            staleness=hyper.staleness)
        metrics = {"lm_loss": loss, "moe_aux": aux_loss, "lr": lr,
                   "bits_per_worker": aux["bits_per_worker"]}
        if "residual_ratio" in aux:   # what a host-side RankController reads
            metrics["residual_ratio"] = ctx.pmean_model(
                ctx.backend.pmean(aux["residual_ratio"]))
        if hyper.track_drift:
            for name, t in (("params", params), ("momentum", ef_state.momentum),
                            ("error", ef_state.error), ("q", ef_state.comp)):
                metrics[f"drift_{name}"] = ctx.pmax_model(replica_drift(
                    ctx, t, per_worker=name == "error"))
        return params, ef_state, metrics

    def init_state(generator: Optional[torch.Generator] = None, *,
                   global_state=None):
        if mesh is None:
            params = model.init(cfg, generator, device=dev)
            return params, error_feedback.init_state(
                compressor, params, mspec_tree, lead=lead, generator=generator,
                staleness=hyper.staleness)
        if global_state is None:
            params = model.init(cfg, generator, device=dev, model_shards=m_size)
            comp = compressor.init(params, mspec_tree, generator)
        else:
            params, comp = global_state
        specs = specs_lib.partition_specs(parts)
        params = shard_tree(params, model.pspecs(cfg), mesh)
        zeros = lambda t: tree.map(torch.zeros_like, t)
        return params, EFState(
            error=zeros(params), momentum=zeros(params),
            comp=None if comp is None else shard_tree(comp, specs.comp, mesh),
            step=0,
            inflight=zeros(params) if hyper.staleness == "one_step" else None)

    return step_fn, init_state


def make_train_step(cfg: ModelConfig, hyper: TrainHyper,
                    compressor: Optional[Compressor] = None, group=None,
                    stats=None, device=None, mesh=None):
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
    ``all_reduce`` outside ``stats``: metrics are not gradient traffic),
    ``metrics["moe_aux"]`` the MoE auxiliary loss likewise (another, with
    MoE layers; without them a 0 and no call).

    ``init_state(generator)`` → ``(params, ef_state)``: random parameters
    (and PowerSGD factors) drawn from ``generator``, zero error buffers and
    momentum (and in-flight aggregate, under ``staleness="one_step"``).
    Every worker must pass a generator with the same seed, so
    that all start from the same parameters and factors.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, exclusive with
    ``group``): tensor parallelism over its model axis.  The data-axis
    collectives span ``mesh.data_group`` and the model's *f*/*g* pair and
    gathers ``mesh.model_group`` (:data:`repro_torch.core.dist.MODEL_CALLS`
    counts them); ``hyper.tp_grad_sync`` is the reference's switch.
    ``init_state(generator)`` draws the global parameters (heads and
    vocabulary padded to the model size) and the compressor's global state,
    then keeps this rank's slices under :func:`train_state_partition`'s
    specs: a model-sharded Q factor its rows, a model-LOCAL one the whole
    draw; ``init_state(global_state=(params, comp))`` slices a given global
    state instead (its whole leaves are used in place).  Every tree the step
    takes and returns is the rank's local one; ``metrics["lm_loss"]`` is
    averaged over the data ranks, then over the model ranks.  A rank
    schedule's controller transitions the local state given the
    partition's records and the rank's model coordinate,
    ``ctl.update(ef.comp, i, residual, partition=train_state_partition(
    cfg, mesh).comp, model_coord=mesh.coords["model"])``, so that a growth
    draws a model-sharded factor's columns at global shape.
    """
    if mesh is not None and group is not None:
        raise ValueError("make_train_step takes a group or a mesh, not both")
    dev = resolve_device(device)
    if mesh is None:
        backend = DistBackend(group)
        ctx = MeshCtx(data_axes=("data",), sync_mode=hyper.sync_mode,
                      stats=stats, backend=backend)
    else:
        backend = DistBackend(mesh.data_group)
        dist.check_backend_device(tdist.get_backend(mesh.model_group), dev)
        ctx = MeshCtx(data_axes=mesh_lib.data_axes(mesh),
                      sync_mode=hyper.sync_mode, stats=stats, backend=backend,
                      model_axis=mesh_lib.model_axis(mesh),
                      tp_grad_sync=hyper.tp_grad_sync,
                      model_group=mesh.model_group)
    backend.check_device(dev)

    def grads_fn(params, batch):
        grads, metrics = local_grads(cfg, params, batch, q_chunk=hyper.q_chunk,
                                     device=dev, ctx=ctx, window=hyper.window,
                                     remat=hyper.remat)
        return tree.unflatten(params, grads), metrics

    body, init_state = _make_step(cfg, hyper, compressor, ctx.lead, grads_fn,
                                  dev, mesh)

    def step_fn(params, ef_state: EFState, batch, seed=None):
        return body(params, ef_state, batch, ctx, seed)

    return step_fn, init_state


def train_state_partition(cfg: ModelConfig, mesh,
                          compressor: Optional[Compressor] = None,
                          staleness: str = "none") -> EFState:
    """The per-leaf :class:`~repro_torch.core.engine.StatePartition` tree of
    the error-feedback state on ``mesh`` (what :func:`make_train_step`
    slices its state by and binds into the engine), built without a step.
    Pass the run's ``staleness`` so a one-step state's in-flight leaves are
    classified too."""
    if compressor is None:
        compressor = PowerSGDCompressor()
    return specs_lib.ef_partition(
        model.pspecs(cfg), model.mspecs(cfg), mesh_lib.data_axes(mesh),
        compressor=compressor, stateful=compressor.stateful,
        staleness=staleness)


# model-axis calls of one layer slot's part: (forward all_reduce, backward
# all_reduce, forward all_gather), with tp_grad_sync on
_SLOT_CALLS = {
    # g entering the projections; the K and V gathers, whose backward is
    # an all_reduce each; f after wo
    "attn": (1, 3, 2),
    # g entering x_loc, B and C; the norm's mean square summed (f) and its
    # g; f after out_proj
    "mamba": (2, 4, 0),
    "dense": (1, 1, 0),        # g, f after w_down
    "moe": (1, 2, 0),          # g on the router logits and on the tokens; f
    "none": (0, 0, 0),
}


def tp_calls_per_step(cfg: ModelConfig, hyper: TrainHyper) -> dict:
    """The model-axis ``torch.distributed`` calls of one
    :func:`make_train_step` step on a mesh (:data:`repro_torch.core.dist.
    MODEL_CALLS`), forward and backward, with ``tp_grad_sync`` on and the
    K/V gathers of the attention (not ``tp_local_kv``).  Per layer, by its
    slot's mixer and feed-forward: an attention's *g* (an ``all_reduce``
    backward), its K and V gathers (an ``all_gather`` forward and an
    ``all_reduce`` backward each) and the *f* after ``wo``; a Mamba-2
    mixer's three *g* (x, B, C), its norm's summed mean square and that
    sum's *g*, and the *f* after ``out_proj``; a dense MLP's *g* and *f*;
    an MoE layer's two *g* (router logits, tokens) and its *f*.  Once: the
    embedding's *f*, the head's *g*, the cross-entropy's max and its two
    sums, the loss metric's mean over the model axis (and the MoE
    auxiliary loss's, with MoE layers); the residual ratio's mean under
    ``track_residual`` and the four drift probes' max under
    ``track_drift``.  Under ``remat`` every forward call of the blocks runs
    again in the backward (the recomputation runs each period whole)."""
    if not hyper.tp_grad_sync:
        raise ValueError("the count is for tp_grad_sync=True")
    fwd = bwd = gather = 0
    for slot in cfg.slots:
        for part in (slot.mixer, slot.ffn):
            f, b, g = _SLOT_CALLS[part]
            fwd, bwd, gather = fwd + f, bwd + b, gather + g
    reps = 2 if hyper.remat else 1
    all_reduce = ((reps * fwd + bwd) * cfg.num_periods + 5 + 1
                  + int(model.has_moe(cfg)) + int(hyper.track_residual)
                  + 4 * int(hyper.track_drift))
    return {"all_reduce": all_reduce, "all_gather": reps * gather * cfg.num_periods}


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
    are (weighted under ``weights``), and ``metrics["moe_aux"]`` their MoE
    auxiliary loss likewise (0 without MoE layers).

    ``init_state(generator)`` → ``(params, ef_state)``: random parameters
    (and PowerSGD factors) drawn from ``generator``, zero error buffers and
    momentum (and in-flight aggregate, held once, under
    ``staleness="one_step"``).
    """
    dev = resolve_device(device)
    w = sim.workers

    def grads_fn(params, batch):
        return worker_grads(cfg, params, batch, w, q_chunk=hyper.q_chunk,
                            device=dev, window=hyper.window,
                            remat=hyper.remat)

    body, init_state = _make_step(cfg, hyper, compressor, (w,), grads_fn, dev)

    def step_fn(params, ef_state: EFState, batch, seed=None, weights=None):
        return body(params, ef_state, batch,
                    sim.ctx(stats=stats, weights=weights, device=dev,
                            sync_mode=hyper.sync_mode), seed)

    return step_fn, init_state


def check_wire_dtype_meta(meta: dict, wire_dtype: str) -> None:
    """Resume guard: the checkpoint's recorded wire policy must match.

    Under a quantized wire every step's quantization error lands in the
    error buffers, so the buffers in the envelope mean something only under
    the policy that made them.  A mismatch is a configuration error."""
    saved = meta.get("wire_dtype", "auto")
    if saved != wire_dtype:
        raise SystemExit(
            f"--wire-dtype {wire_dtype!r} does not match the checkpoint's "
            f"{saved!r} — the wire policy shapes the error-feedback "
            f"trajectory (quantization error is part of the algorithm "
            f"state); resume with the wire dtype the run was started with")


# ---------------------------------------------------------------------------
# The command line: end-to-end training of the reduced model, one process per
# worker
# ---------------------------------------------------------------------------

def _join_group(dev: torch.device, rendezvous_dir: str) -> bool:
    """Make sure a default process group exists: keep one that does, else
    join torchrun's (``RANK``/``WORLD_SIZE`` in the environment), else make
    a one-rank group on a file store in ``rendezvous_dir``; NCCL for the
    card, gloo for the CPU.  Returns whether this call made it."""
    if tdist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"timeout": datetime.timedelta(seconds=60)}
    if dev.type == "cuda":
        kw["device_id"] = dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        tdist.init_process_group(backend, **kw)
    else:
        tdist.init_process_group(
            backend, init_method=f"file://{rendezvous_dir}/rdzv",
            world_size=1, rank=0, **kw)
    return True


def main(argv=None) -> None:
    """``python -m repro_torch.launch.train``: train the reduced model of
    ``--arch`` with EF-PowerSGD, one worker per process of the default
    process group (or a one-rank group), on ``--device`` (the card unless
    told otherwise).  Flags, printed lines, checkpoints and resume guards
    are the JAX package's."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split evenly over the processes")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rank", type=int, default=2)
    ap.add_argument("--rank-schedule", default=None,
                    help="adaptive-rank spec, e.g. '4@0,2@60,1@120' or "
                         "'residual:min=1,max=8,init=4' (see "
                         "repro_torch.core.powersgd.parse_schedule)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--sync-mode", default="allreduce",
                    choices=("allreduce", "broadcast"),
                    help="'broadcast' makes every data-axis aggregate "
                         "replica-deterministic (canonical reduction order "
                         "+ rank-0 broadcast)")
    ap.add_argument("--wire-dtype", default="auto",
                    choices=matrixize.WIRE_DTYPES,
                    help="fused-collective wire policy: 'auto' keeps each "
                         "part's dtype, float32/bfloat16 cast, int8/int4 "
                         "quantize float payloads symmetrically per slot")
    ap.add_argument("--staleness", default="none",
                    choices=("none", "one_step"),
                    help="'one_step' turns on the delayed-parameter-update "
                         "pipeline: apply step t-1's aggregated compressed "
                         "update while step t's gradients are computed "
                         "(error feedback absorbs the delay)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; each torchrun process takes "
                         "cuda:LOCAL_RANK, so four or more processes, a "
                         "(world/2, 2) data x model grid, need as many "
                         "cards) or 'cpu'")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a full TrainState checkpoint every N steps "
                         "(0 = only at the end; needs --ckpt-dir)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retention: keep the newest N checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir: "
                         "full algorithm state (EF buffers, warm-start "
                         "factors, rank controller, base seed, data "
                         "cursor), bit-exact at the same worker count")
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every requires --ckpt-dir (no checkpoint would "
                 "ever be written)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")

    cfg = get_config(args.arch, reduced=True)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    with tempfile.TemporaryDirectory() as rendezvous:
        made = _join_group(dev, rendezvous)
        try:
            _train(args, cfg, dev)
        finally:
            if made:
                tdist.destroy_process_group()


def global_template(cfg: ModelConfig, mesh, compressor: Compressor,
                    staleness: str = "none"):
    """``(params, ef)`` of ``mesh``'s global state as empty tensors on the
    ``meta`` device: parameters at ``model_shards=M`` (heads and vocabulary
    padded), error buffers ``(D,) + shape``, momentum, the compressor's
    state at its initial rank and, under ``staleness="one_step"``, the
    in-flight aggregate.  The restore template of a grid, before
    :func:`~repro_torch.checkpoint.train_state.stack_model_template` (the
    twin of the JAX CLI's global ``init_state``; nothing is drawn)."""
    params = model.init(cfg, None, "meta", model_shards=mesh.shape["model"])
    empty = lambda lead: tree.map(lambda p: torch.empty(
        lead + tuple(p.shape), dtype=p.dtype, device="meta"), params)
    return params, EFState(
        error=empty((mesh.shape["data"],)), momentum=empty(()),
        comp=compressor.init(params, model.mspecs(cfg)), step=0,
        inflight=empty(()) if staleness == "one_step" else None)


def _train(args, cfg, dev) -> None:
    """The body of :func:`main`, inside the process group: the JAX CLI's
    grid (:func:`repro_torch.launch.mesh.cli_shape`), the batch split over
    the data ranks (every model rank of a data row takes the same shard)."""
    world, rank = tdist.get_world_size(), tdist.get_rank()
    try:
        shape = mesh_lib.cli_shape(world)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.batch % shape[0]:
        over = f"{world} processes" if shape[1] == 1 else f"{shape[0]} data ranks"
        raise SystemExit(f"--batch {args.batch} does not split over {over}")
    mesh = mesh_lib.make_mesh(shape)
    data_rank, data_size = mesh.coords["data"]
    model_size = shape[1]
    say = print if rank == 0 else (lambda *a, **k: None)
    if model_size > 1:
        say(f"mesh (data, model) = {shape}")
    hyper = TrainHyper(lr=args.lr, rank=args.rank, q_chunk=64,
                       warmup_steps=20, rank_schedule=args.rank_schedule,
                       wire_dtype=args.wire_dtype, sync_mode=args.sync_mode,
                       staleness=args.staleness)
    compressor = PowerSGDCompressor(
        rank=args.rank, rank_schedule=args.rank_schedule,
        wire_dtype=args.wire_dtype, pipeline=args.staleness == "one_step")
    step_fn, init_state = make_train_step(cfg, hyper, compressor=compressor,
                                          device=dev, mesh=mesh)
    controller = (compressor.controller()
                  if compressor.rank_schedule is not None else None)
    # the state's partition records: which leaves are model-sharded and which
    # model-LOCAL (a row-parallel weight's Q, stacked per model rank in the
    # envelope; a growth draws a sharded factor's columns at global shape)
    parts = train_state_partition(cfg, mesh, compressor, args.staleness)
    seed = 0   # the base seed (the JAX package's jax.random.key(0))
    params, ef = init_state(torch.Generator(dev).manual_seed(0))
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)

    start, residual = 0, None
    if args.resume:
        p_t, ef_t = global_template(cfg, mesh, compressor, args.staleness)
        template = ts.TrainState(
            params=p_t, ef=ts.stack_model_template(ef_t, parts, model_size),
            seed=seed)
        state, meta = ts.restore_train_state(args.ckpt_dir, template,
                                             model_axis_size=model_size)
        if meta.get("rank_schedule") != args.rank_schedule:
            raise SystemExit(
                f"--rank-schedule {args.rank_schedule!r} does not match the "
                f"checkpoint's {meta.get('rank_schedule')!r} — resume with "
                f"the schedule the run was started with")
        if meta.get("staleness", "none") != args.staleness:
            raise SystemExit(
                f"--staleness {args.staleness!r} does not match the "
                f"checkpoint's {meta.get('staleness', 'none')!r} — the "
                f"envelope does (not) carry an in-flight aggregate; resume "
                f"with the mode the run was started with")
        check_wire_dtype_meta(meta, args.wire_dtype)
        # each model rank takes its own slices, a model-LOCAL factor its own
        # pre-save copy (not model rank 0's)
        params, ef = ts.replicate_mesh(mesh, state.params, state.ef, parts,
                                       device=dev)
        seed = state.seed
        start = int(state.ef.step)
        if state.data_step != start:
            raise SystemExit(
                f"checkpoint data cursor {state.data_step} does not "
                f"match its step counter {start} — this CLI keys batches "
                f"by step, so the envelope was written by another training "
                f"loop; resume it with that loop")
        if controller is not None and meta.get("controller"):
            controller.load_state_dict(meta["controller"])
        residual = meta.get("last_residual")
        say(f"resumed from step {start} in {args.ckpt_dir} "
            f"(saved at {meta.get('workers')} worker(s), rank "
            f"{controller.rank if controller else args.rank})")

    def save_ckpt():
        # the state after the step that just completed: "about to run step
        # ef.step"; a collective (the grid's leaves are gathered), rank 0
        # writes
        p_c, ef_c = ts.canonicalize_mesh(mesh, params, ef, parts)
        if rank != 0:
            return None
        return ts.save_train_state(
            args.ckpt_dir,
            ts.TrainState(params=p_c, ef=ef_c, seed=seed,
                          data_step=int(ef.step)),
            controller=controller, keep=args.ckpt_keep,
            model_axis_size=model_size,
            mesh_shape={"data": shape[0], "model": model_size},
            extra_meta={"rank_schedule": args.rank_schedule,
                        "arch": args.arch, "last_residual": residual,
                        "staleness": args.staleness,
                        "wire_dtype": args.wire_dtype})

    lo = data_rank * args.batch // data_size
    hi = (data_rank + 1) * args.batch // data_size
    t0 = time.time()
    metrics = {}
    for i in range(start, args.steps):
        if controller is not None:
            new_comp, changed = controller.update(
                ef.comp, i, residual, partition=parts.comp,
                model_coord=mesh.coords["model"])
            if changed:
                ef = error_feedback.replace_comp(ef, new_comp)
                say(f"step {i:4d} rank -> {controller.rank}")
        # the data cursor is the step index: batch i is sample(step=i), so a
        # resumed run rejoins the stream where it left off
        toks = torch.from_numpy(data.sample(args.batch, args.seq, step=i)[lo:hi])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].contiguous()}
        params, ef, metrics = step_fn(params, ef, batch, seed=seed)
        if "residual_ratio" in metrics:
            residual = float(metrics["residual_ratio"])
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d} loss={float(metrics['lm_loss']):.4f} "
                f"lr={float(metrics['lr']):.4f} ({time.time() - t0:.1f}s)")
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            path = save_ckpt()
            say(f"step {i:4d} checkpoint -> {path}")
    if args.ckpt_dir and start < args.steps:
        path = save_ckpt()
        say(f"final checkpoint -> {path}")
    if metrics:
        # full precision, so that a resumed run can be compared bit for bit
        loss = float(metrics["lm_loss"])
        say(f"final lm_loss={loss:.6f} hex={loss.hex()}")


if __name__ == "__main__":
    main()
