"""Distributed error-feedback SGD with post-compression momentum (Alg. 2),
synchronous schedule (port of ``repro.core.error_feedback``).

    Δ_w   ← g_w + e_w                      (feedback)
    C(Δ)  ← compress+aggregate(Δ_1..Δ_W)   (the compressor's job)
    e_w   ← Δ_w − recon                    (memorize local error)
    m     ← λ m + Δ'
    x     ← x − γ (Δ' + m)

Memory: the port updates in place where the JAX package made new arrays.
Δ is formed in the gradient buffers, which then become the new error
buffers; momentum and parameters are updated in their own storage.  Under
a :class:`~repro_torch.core.simmesh.SimMesh` context the gradients and error
buffers carry the leading worker dim, while parameters and momentum —
identical on every worker after each all-reduced update — are held once.

Weight decay follows the paper (§5): coupled, added to the gradient before
compression, and not applied to uncompressed (norm) parameters.

``start_compress_step=k`` delays compression, as the PyTorch DDP PowerSGD
hook's ``start_powerSGD_iter`` does: for the first k steps the deltas are
aggregated dense (one fused :meth:`MeshCtx.pmean_flat` on the compressor's
wire) and the reconstruction is the delta itself, so the error buffers
stay exactly zero and the trajectory is bit-identical to the identity
compressor's.  Compression and error feedback start at step k.  The step
counter is a host ``int``, so the switch is a plain branch and only the
branch taken runs (the JAX package's ``lax.cond`` traces both).

Declared divergence (``CollectiveStats``): the JAX package records at trace
time, and its ``cond`` traces both branches, so one warm-up step there
records the dense reduce and the compressor's collectives together.  The
port records what each step ran: the dense reduce while ``step < k``, the
compressor's collectives afterwards.

``staleness="one_step"`` is the delayed-parameter-update pipeline: step t
applies the aggregate of step t−1 (``EFState.inflight``) and parks its own
for step t+1, so the collectives that produce Δ'ₜ never sit between the
gradient and the parameter write of the same step.  Step 0 applies zeros
(the pipeline bubble); the error buffers follow the synchronous rule.  The
port updates in place, where the JAX package's ``shift`` is pure
structure: the fresh aggregate may share storage with Δ (a part alone in
its wire chunk without data axes, a dense step's aggregate), which the
step then turns into the error buffer, so the aggregate is copied into the
in-flight tree's own storage after the apply has read the old one.

Elastic rescaling of the per-worker error buffers to another worker count
(:func:`rescale_error_buffers`) and the rank-transition hook
(:func:`replace_comp`) are ported beside the step.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize
from repro_torch.core.compressors import Compressor
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.kernels import ops


@dataclasses.dataclass
class EFState:
    """The optimizer's cross-step state."""

    error: Any       # per-worker error buffers e_w (tree like params, lead dims)
    momentum: Any    # post-compression momentum m (tree like params)
    comp: Any        # compressor state (PowerSGD Q factors; None if stateless)
    step: int = 0
    # staleness="one_step" only: the aggregate Δ'ₜ₋₁ of the previous step,
    # not yet applied (tree like params, held once); None when synchronous
    inflight: Any = None

    def to(self, device) -> "EFState":
        """A copy of this state on ``device``."""
        move = lambda t: tree.map(
            lambda x: None if x is None else x.to(device, copy=True), t)
        return dataclasses.replace(self, error=move(self.error),
                                   momentum=move(self.momentum),
                                   comp=move(self.comp),
                                   inflight=move(self.inflight))


def init_state(compressor: Compressor, params, specs, *, lead=(),
               generator: Optional[torch.Generator] = None,
               staleness: str = "none") -> EFState:
    """Zero error buffers (with ``lead`` worker dims) and momentum, fresh
    compressor state; under ``staleness="one_step"`` a zero in-flight
    aggregate shaped like ``params``."""
    return EFState(
        error=tree.map(lambda p: torch.zeros(tuple(lead) + tuple(p.shape),
                                             dtype=p.dtype, device=p.device),
                       params),
        momentum=tree.map(torch.zeros_like, params),
        comp=compressor.init(params, specs, generator),
        step=0,
        inflight=(engine.PipelinedTransport.init_inflight(params)
                  if staleness == "one_step" else None))


def rescale_path(w_old: int, w_new: int) -> str:
    """Which :func:`rescale_error_buffers` branch a ``w_old → w_new``
    rescale takes: ``"identity"`` / ``"grow"`` / ``"shrink"`` /
    ``"coprime-mean"``."""
    if w_new == w_old:
        return "identity"
    if w_new % w_old == 0:
        return "grow"
    if w_old % w_new == 0:
        return "shrink"
    return "coprime-mean"


def rescale_error_buffers(error, workers: int):
    """Re-shard a stacked per-worker error-buffer tree (a leading worker dim
    ``W_old`` on every leaf) to ``workers`` workers, preserving the
    worker-mean of the buffers, which is what Algorithm 2 aggregates:

    * ``workers == W_old``: ``error`` itself.
    * grow (``workers % W_old == 0``): each buffer repeated to its
      ``workers / W_old`` consecutive successors, bit-exact.
    * shrink (``W_old % workers == 0``): each new buffer the mean of the
      ``W_old / workers`` consecutive buffers it absorbs.
    * otherwise every new buffer is the global worker-mean, with a
      ``UserWarning``.

    Every new buffer owns its storage (the step updates error buffers in
    place, so a broadcast view would tie workers together).
    """
    leaves = tree.leaves(error)
    if not leaves:
        return error
    w_old = leaves[0].shape[0]
    for e in leaves:
        if e.shape[0] != w_old:
            raise ValueError(f"error buffers disagree on the worker dim: "
                             f"{tuple(e.shape)} against {w_old} workers")
    path = rescale_path(w_old, workers)
    if path == "identity":
        return error
    if path == "coprime-mean":
        warnings.warn(
            f"coprime EF rescale {w_old} -> {workers}: every new buffer is "
            f"the global worker-mean (per-worker identity lost; mean "
            f"preserved)", stacklevel=2)

    def leaf(e):
        if path == "grow":
            return torch.repeat_interleave(e, workers // w_old, dim=0)
        if path == "shrink":
            k = w_old // workers
            return e.reshape((workers, k) + tuple(e.shape[1:])).mean(dim=1)
        mean = e.mean(dim=0, keepdim=True)
        return mean.expand((workers,) + tuple(e.shape[1:])).contiguous()

    return tree.map(leaf, error)


def replace_comp(state: EFState, comp) -> EFState:
    """``state`` with a new compressor state, the rank-transition hook:
    error buffers, momentum and the step counter pass through as the same
    objects."""
    return dataclasses.replace(state, comp=comp)


def apply_updates(compressor: Compressor, params, grads, state: EFState,
                  specs, *, lr, momentum: float = 0.9,
                  weight_decay: float = 0.0, ctx: MeshCtx = SINGLE,
                  seed: Optional[int] = None,
                  start_compress_step: int = 0, staleness: str = "none"):
    """One EF-SGD step.  Returns ``(params, new_state, aux)``.

    ``staleness="one_step"`` applies ``state.inflight`` (step t−1's
    aggregate) instead of this step's, and parks this step's aggregate in
    ``new_state.inflight`` (the same tensors as ``state.inflight``,
    overwritten after the apply); see the module docstring.

    ``seed`` is the run's base seed for shared-seed draws: the compressor
    gets ``engine.step_seed(seed, state.step)``, the twin of the JAX
    package's ``fold_in(key, state.step)``.

    ``start_compress_step=k`` aggregates the steps with ``state.step < k``
    dense (see the module docstring); with the default 0 every step
    compresses.

    ``grads`` are the per-worker gradients (``ctx.lead`` worker dims); they
    are consumed: their storage becomes ``new_state.error``.  ``params`` and
    ``state.momentum`` are updated in place and returned.  ``aux`` holds
    ``bits_per_worker`` and the compressor's metrics (with ``ctx.lead``
    worker dims), the latter only where ``start_compress_step`` is 0.
    """
    if staleness not in ("none", "one_step"):
        raise ValueError(f"unknown staleness mode {staleness!r}")
    stale = staleness == "one_step"
    if stale and state.inflight is None:
        raise ValueError(
            "staleness='one_step' needs EFState.inflight initialized "
            "(init_state(..., staleness='one_step'))")
    with torch.no_grad():
        for g, p, spec in zip(tree.leaves(grads), tree.leaves(params),
                              tree.leaves(specs)):
            if weight_decay and spec.is_compressed():
                g.add_(weight_decay * p)
        # Δ_w = g_w + e_w, in the gradient buffers
        deltas = tree.map(lambda g, e: g.add_(e), grads, state.error)
        if state.step < start_compress_step:
            out = _dense_step(compressor, deltas, state.comp, ctx)
        else:
            out = compressor.step(
                deltas, state.comp, specs, ctx=ctx,
                seed=None if seed is None else engine.step_seed(seed, state.step))
        applied, fresh = (engine.PipelinedTransport.shift(out.agg,
                                                          state.inflight)
                          if stale else (out.agg, None))
        params, new_momentum = ops.ef_apply_tree(
            params, applied, state.momentum, lr=lr, momentum=momentum)
        if stale:
            # park Δ'ₜ in the in-flight tree's own storage, now that the
            # apply has read Δ'ₜ₋₁ from it
            for buf, agg in zip(tree.leaves(state.inflight),
                                tree.leaves(fresh)):
                buf.copy_(agg)
        # e_w = Δ_w − recon, in the same buffers.  Last: without data axes
        # an uncompressed leaf's aggregate may be a view of its Δ.  A dense
        # step's recon is Δ itself: Δ − Δ, so a non-finite Δ stays so.
        new_error = tree.map(lambda d, rc: d.sub_(rc), deltas, out.recon)
    new_state = EFState(error=new_error, momentum=new_momentum,
                        comp=out.state, step=state.step + 1,
                        inflight=state.inflight)
    aux = {"bits_per_worker": out.bits_per_worker}
    # the compressor's observability (PowerSGD's residual ratios under
    # track_residual).  As in the JAX package, a run with a dense warm-up
    # reports none on any step: its switch returns the step without them.
    if out.metrics and not start_compress_step:
        aux.update(out.metrics)
    return params, new_state, aux


def _dense_step(compressor: Compressor, deltas, comp_state,
                ctx: MeshCtx) -> engine.CompressOut:
    """A warm-up step: the deltas reduced in one fused dense all-reduce on
    the compressor's wire, the reconstruction the deltas themselves, the
    compressor state passed through untouched.  ``bits_per_worker`` counts
    every leaf at 32 bits per float, per worker (``ctx.lead`` stripped).
    Under ``sync_mode="broadcast"`` the reduce is the canonical one and
    each chunk records a reduce and a broadcast leg, as the JAX package's
    dense branch does."""
    leaves = tree.leaves(deltas)
    agg = ctx.pmean_flat(leaves,
                         wire_dtype=getattr(compressor, "wire_dtype", "auto"),
                         max_chunk_bytes=getattr(compressor, "max_chunk_bytes",
                                                 None))
    nl = len(ctx.lead)
    bits = sum(matrixize.uncompressed_floats(tuple(d.shape[nl:])) * 32
               for d in leaves)
    return engine.CompressOut(agg=tree.unflatten(deltas, agg), recon=deltas,
                              state=comp_state, bits_per_worker=bits)
