"""Data-axis context threaded through the compression engine (port of
``repro.core.dist``, data axis only).

Model code and compressors are written against :class:`MeshCtx`.  Outside
any data-parallel group (:data:`SINGLE`) every collective is the identity.
Inside a :class:`~repro_torch.core.simmesh.SimMesh` step the context holds a
:class:`SimBackend`: per-worker tensors carry a leading worker dim of size W
(``ctx.lead``) where the JAX package mapped the step with ``vmap``, and a
collective is the exact mean over that dim.  The mean is worker-identical,
so it comes back once, without the worker dim; :meth:`MeshCtx.per_worker`
stacks it again where per-worker math needs it.

Not ported yet: model/seq-axis collectives, weighted means, gathers,
``sync_mode="broadcast"`` (ROADMAP queue A, items 4 and 20) and a
``torch.distributed`` backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import matrixize


@dataclasses.dataclass(eq=False)
class CollectiveStats:
    """Counter of data-axis collectives.

    Attach one to a :class:`MeshCtx` and every ``pmean_data`` / ``pmean_flat``
    call records the logical collective it issues — the count a real
    data-parallel group would see, recorded even where the collective
    degenerates to the identity.  The port runs eagerly, so every call
    records (the JAX package records once per trace).
    """

    data_collectives: int = 0
    sizes: List[int] = dataclasses.field(default_factory=list)
    itemsizes: List[int] = dataclasses.field(default_factory=list)
    kinds: List[str] = dataclasses.field(default_factory=list)

    def record(self, n_elems: int, itemsize: int = 4, kind: str = "reduce") -> None:
        self.data_collectives += 1
        self.sizes.append(int(n_elems))
        self.itemsizes.append(int(itemsize))
        self.kinds.append(kind)

    @property
    def reduce_collectives(self) -> int:
        return sum(1 for k in self.kinds if k == "reduce")


@dataclasses.dataclass(frozen=True)
class SimBackend:
    """W simulated workers stacked on a leading dim of every per-worker
    tensor; the mean over workers is exact and held once."""

    workers: int

    @property
    def lead(self) -> Tuple[int, ...]:
        return (self.workers,)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=0)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Names of the data axes the computation is mapped over.

    stats:   optional :class:`CollectiveStats` (excluded from eq).
    backend: how the data-axis collectives run (:class:`SimBackend`);
             required when ``data_axes`` is non-empty.
    """

    data_axes: Tuple[str, ...] = ()
    sync_mode: str = "allreduce"
    stats: Optional[CollectiveStats] = dataclasses.field(default=None, compare=False)
    backend: Optional[SimBackend] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.sync_mode != "allreduce":
            raise NotImplementedError(
                f"sync_mode={self.sync_mode!r} is not ported yet (ROADMAP "
                f"queue A, item 20)")
        if self.data_axes and self.backend is None:
            raise ValueError("a MeshCtx with data axes needs a backend")

    @property
    def lead(self) -> Tuple[int, ...]:
        """Leading worker dims of per-worker tensors (``()`` when every
        tensor is one worker's own)."""
        return self.backend.lead if self.data_axes else ()

    def per_worker(self, x: torch.Tensor) -> torch.Tensor:
        """A worker-identical tensor stacked once per worker (contiguous)."""
        if not self.lead:
            return x
        return x.expand(self.lead + tuple(x.shape)).contiguous()

    def _record(self, n_elems: int, itemsize: int) -> None:
        if self.stats is not None:
            self.stats.record(n_elems, itemsize, kind="reduce")

    def pmean_data(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the data axes of one per-worker tensor."""
        self._record(math.prod(x.shape[len(self.lead):]), x.dtype.itemsize)
        return self.backend.pmean(x) if self.data_axes else x

    def pmean_flat(self, parts: Sequence[torch.Tensor], *,
                   wire_dtype: str = "auto",
                   max_chunk_bytes: Optional[int] = None) -> List[torch.Tensor]:
        """Fused all-reduce-mean: one collective per wire chunk for a whole
        list of per-worker tensors (see :func:`matrixize.plan_flat` for the
        chunking policy).  Elementwise, so numerically the same as one
        ``pmean_data`` per part when no wire cast applies."""
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead)
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)
        out: dict = {}
        for chunk in plan.chunks:
            buf = matrixize.pack_flat(chunk, parts, lead=nl)
            self._record(chunk.size, chunk.wire_itemsize)
            if self.data_axes:
                buf = self.backend.pmean(buf)
            out.update(matrixize.unpack_flat(chunk, buf))
        return [out[i] for i in range(len(parts))]


SINGLE = MeshCtx()  # single worker: all collectives are identities
