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

Not ported yet: ``start_compress_step`` > 0 (dense warmup, ROADMAP queue A,
item 7) and ``staleness="one_step"`` (item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core import engine
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

    def to(self, device) -> "EFState":
        """A copy of this state on ``device``."""
        move = lambda t: tree.map(
            lambda x: None if x is None else x.to(device, copy=True), t)
        return dataclasses.replace(self, error=move(self.error),
                                   momentum=move(self.momentum),
                                   comp=move(self.comp))


def init_state(compressor: Compressor, params, specs, *, lead=(),
               generator: Optional[torch.Generator] = None) -> EFState:
    """Zero error buffers (with ``lead`` worker dims) and momentum, fresh
    compressor state."""
    return EFState(
        error=tree.map(lambda p: torch.zeros(tuple(lead) + tuple(p.shape),
                                             dtype=p.dtype, device=p.device),
                       params),
        momentum=tree.map(torch.zeros_like, params),
        comp=compressor.init(params, specs, generator),
        step=0)


def apply_updates(compressor: Compressor, params, grads, state: EFState,
                  specs, *, lr, momentum: float = 0.9,
                  weight_decay: float = 0.0, ctx: MeshCtx = SINGLE,
                  seed: Optional[int] = None,
                  start_compress_step: int = 0, staleness: str = "none"):
    """One EF-SGD step.  Returns ``(params, new_state, aux)``.

    ``seed`` is the run's base seed for shared-seed draws: the compressor
    gets ``engine.step_seed(seed, state.step)``, the twin of the JAX
    package's ``fold_in(key, state.step)``.

    ``grads`` are the per-worker gradients (``ctx.lead`` worker dims); they
    are consumed: their storage becomes ``new_state.error``.  ``params`` and
    ``state.momentum`` are updated in place and returned.
    """
    if staleness != "none":
        raise NotImplementedError(
            f"staleness={staleness!r} is not ported yet (ROADMAP queue A, "
            f"item 12)")
    if start_compress_step:
        raise NotImplementedError(
            "start_compress_step > 0 (dense warmup) is not ported yet "
            "(ROADMAP queue A, item 7)")
    with torch.no_grad():
        for g, p, spec in zip(tree.leaves(grads), tree.leaves(params),
                              tree.leaves(specs)):
            if weight_decay and spec.is_compressed():
                g.add_(weight_decay * p)
        # Δ_w = g_w + e_w, in the gradient buffers
        deltas = tree.map(lambda g, e: g.add_(e), grads, state.error)
        out = compressor.step(
            deltas, state.comp, specs, ctx=ctx,
            seed=None if seed is None else engine.step_seed(seed, state.step))
        params, new_momentum = ops.ef_apply_tree(
            params, out.agg, state.momentum, lr=lr, momentum=momentum)
        # e_w = Δ_w − recon, in the same buffers.  Last: without data axes
        # an uncompressed leaf's aggregate may be a view of its Δ.
        new_error = tree.map(lambda d, rc: d.sub_(rc), deltas, out.recon)
    new_state = EFState(error=new_error, momentum=new_momentum,
                        comp=out.state, step=state.step + 1)
    return params, new_state, {"bits_per_worker": out.bits_per_worker}
