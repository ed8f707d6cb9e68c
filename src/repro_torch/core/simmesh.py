"""SimMesh — W data-parallel workers simulated in one process on one device
(port of ``repro.core.simmesh``).

Every per-worker value (gradients, error-feedback buffers, batch shards)
carries a leading worker dim of size W, written out where the JAX package
used ``vmap``, and ``MeshCtx`` collectives are exact means over it,
weighted under scenario weights (see
:class:`repro_torch.core.dist.SimBackend`).  Values every worker holds
identically after an all-reduce (parameters, momentum, warm-start factors)
are held once.

:meth:`SimMesh.run` is the counterpart of the reference's ``SimMesh.run``
with one difference: the reference ``vmap``s the whole step, collectives
included, while here the mapped function is worker-local (a gradient, a
forward with its BatchNorm state) and runs once per worker; the
error-feedback step then runs once over the stacked results under
:meth:`SimMesh.ctx`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch import tree
from repro_torch.core.dist import CollectiveStats, MeshCtx, SimBackend


@dataclasses.dataclass(frozen=True)
class SimMesh:
    workers: int
    axis: str = "simworker"

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be ≥ 1, got {self.workers}")

    def ctx(self, stats: Optional[CollectiveStats] = None, weights=None,
            device=None, sync_mode: str = "allreduce") -> MeshCtx:
        """A :class:`MeshCtx` whose data axis is the stacked worker dim.

        ``weights`` — the workers' scenario weights for one step, a ``(W,)``
        vector of finite, non-negative values; ``None`` = uniform (plain
        means).  0 drops a worker from the round's aggregates; for
        heterogeneous batches pass each worker's valid-token count
        (:class:`~repro_torch.core.dist.SimBackend`).  They are checked
        where they are given (host values on the host; a CUDA tensor costs
        a device sync) and held as float32 on ``device`` (default: where
        they are).  Weights are per step, so build the context per step.

        ``sync_mode="broadcast"`` selects the canonical reduction order
        (:class:`~repro_torch.core.dist.MeshCtx`): the simulated mean is
        already the same on every worker, but the canonical order makes
        every collective result bit-equal to a ``torch.distributed`` run
        in the same mode, and to the JAX package's in either substrate."""
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=torch.float32)
            if tuple(weights.shape) != (self.workers,):
                raise ValueError(f"weights of shape {tuple(weights.shape)}, "
                                 f"want ({self.workers},)")
            if not bool((torch.isfinite(weights) & (weights >= 0)).all()):
                raise ValueError(f"weights must be finite and non-negative, "
                                 f"got {weights.tolist()}")
            if device is not None:
                weights = weights.to(device)
        return MeshCtx(data_axes=(self.axis,), sync_mode=sync_mode, stats=stats,
                       backend=SimBackend(workers=self.workers,
                                          weights=weights))

    def run(self, fn: Callable, in_axes: Union[int, None, Sequence] = 0
            ) -> Callable:
        """``fn`` mapped over the workers: ``run(fn, in_axes)(*args)`` calls
        ``fn`` once per worker ``w`` on ``args`` with every mapped argument
        (``in_axes`` entry 0) cut to its slice ``[w]`` and every shared one
        (``None``) whole, and stacks the W results on a new leading dim.

        Arguments and results may be tensors, or dicts, tuples and lists of
        them (``None`` passes through).  Each result is copied into its
        stacked buffer before the next worker runs, so one worker's
        temporaries (its autograd graph) are freed before the next is
        built.  No collective may run inside ``fn``: it is worker-local.
        """
        def mapped(*args):
            axes = (tuple(in_axes) if isinstance(in_axes, (tuple, list))
                    else (in_axes,) * len(args))
            if len(axes) != len(args) or any(a not in (0, None) for a in axes):
                raise ValueError(f"in_axes {in_axes!r} must give 0 or None for "
                                 f"each of the {len(args)} arguments")
            out = None
            for w in range(self.workers):
                res = fn(*(a if ax is None
                           else tree.map_nest(lambda x: x[w], a)
                           for a, ax in zip(args, axes)))
                if out is None:
                    out = tree.map_nest(lambda x: torch.empty(
                        (self.workers,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device), res)
                tree.map_nest(lambda buf, x: buf[w].copy_(x), out, res)
                del res
            return out
        return mapped

    def replicate(self, t):
        """W copies of every leaf: shape → (W,) + shape (a read-only
        expanded view; ``clone`` it before writing)."""
        return tree.map(lambda x: x.unsqueeze(0).expand(
            (self.workers,) + tuple(x.shape)), t)

    def shard(self, t):
        """Split every leaf's leading (global batch) dim W ways:
        (W·b, ...) → (W, b, ...)."""
        def leaf(x):
            n = x.shape[0]
            if n % self.workers:
                raise ValueError(f"batch {n} does not split over "
                                 f"{self.workers} workers")
            return x.reshape((self.workers, n // self.workers) + tuple(x.shape[1:]))
        return tree.map(leaf, t)

    def assert_replicated(self, t, what: str = "tree") -> None:
        """Every leaf bit-identical across the worker dim."""
        for path, x in tree.items(t):
            if x is None:
                continue
            if not torch.equal(x, x[:1].expand_as(x)):
                diff = (x - x[:1]).abs().max().item()
                raise AssertionError(
                    f"{what}{list(path)} diverges across workers "
                    f"(max |Δ| = {diff})")
