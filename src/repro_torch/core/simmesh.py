"""SimMesh — W data-parallel workers simulated in one process on one device
(port of ``repro.core.simmesh``).

Every per-worker value (gradients, error-feedback buffers, batch shards)
carries a leading worker dim of size W, written out where the JAX package
used ``vmap``, and ``MeshCtx`` collectives are exact means over it (see
:class:`repro_torch.core.dist.SimBackend`).  Values every worker holds
identically after an all-reduce (parameters, momentum, warm-start factors)
are held once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    def ctx(self, stats: Optional[CollectiveStats] = None) -> MeshCtx:
        """A :class:`MeshCtx` whose data axis is the stacked worker dim."""
        return MeshCtx(data_axes=(self.axis,), stats=stats,
                       backend=SimBackend(workers=self.workers))

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
