"""Data-axis context threaded through the compression engine (port of
``repro.core.dist``, data axis only).

Model code and compressors are written against :class:`MeshCtx`.  Outside
any data-parallel group (:data:`SINGLE`) every collective is the identity.
The context's backend says how a data-axis collective runs:

* :class:`SimBackend` — inside a :class:`~repro_torch.core.simmesh.SimMesh`
  step: per-worker tensors carry a leading worker dim of size W
  (``ctx.lead``) where the JAX package mapped the step with ``vmap``, and a
  collective is the exact mean over that dim.  The mean is
  worker-identical, so it comes back once, without the worker dim;
  :meth:`MeshCtx.per_worker` stacks it again where per-worker math needs it.
* :class:`DistBackend` — one worker per process over a
  ``torch.distributed`` process group (gloo for CPU tensors, NCCL for CUDA
  tensors): every tensor is the process's own (``ctx.lead == ()``), a mean
  is a real ``all_reduce`` and a gather a real ``all_gather``.

Not ported yet: model-axis collectives (ROADMAP queue A, item 14), weighted
means (item 6), ``broadcast_flat`` and ``sync_mode="broadcast"`` (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from repro_torch.core import matrixize


@dataclasses.dataclass(eq=False)
class CollectiveStats:
    """Counter of data-axis collectives.

    Attach one to a :class:`MeshCtx` and every ``pmean_data`` /
    ``pmean_flat`` / ``allgather_flat`` call records the logical collective
    it sends — the count a real data-parallel group would see, recorded
    even where the collective degenerates to the identity.  The port runs
    eagerly, so every call records (the JAX package records once per
    trace).

    Each record holds the elements per worker (``sizes``), the wire bytes
    per element (``itemsizes``: fractional 0.5 for nibble-packed int4),
    the ``kind`` (``"reduce"``: flat in W; ``"gather"``: every worker
    receives ``fanout`` = W payloads) and the scale-sidecar bytes of a
    quantized chunk (``overheads``).
    """

    data_collectives: int = 0
    sizes: List[int] = dataclasses.field(default_factory=list)
    itemsizes: List[float] = dataclasses.field(default_factory=list)
    kinds: List[str] = dataclasses.field(default_factory=list)
    fanouts: List[int] = dataclasses.field(default_factory=list)
    overheads: List[int] = dataclasses.field(default_factory=list)

    def record(self, n_elems: int, itemsize: float = 4, kind: str = "reduce",
               fanout: int = 1, overhead: int = 0) -> None:
        if kind not in ("reduce", "gather"):
            raise ValueError(f"unknown collective kind {kind!r}")
        self.data_collectives += 1
        self.sizes.append(int(n_elems))
        i = float(itemsize)
        self.itemsizes.append(int(i) if i.is_integer() else i)
        self.kinds.append(kind)
        self.fanouts.append(int(fanout))
        self.overheads.append(int(overhead))

    def reset(self) -> None:
        self.data_collectives = 0
        for records in (self.sizes, self.itemsizes, self.kinds, self.fanouts,
                        self.overheads):
            records.clear()

    @property
    def reduce_collectives(self) -> int:
        return sum(1 for k in self.kinds if k == "reduce")

    @property
    def gather_collectives(self) -> int:
        return sum(1 for k in self.kinds if k == "gather")

    def bytes_per_collective(self) -> List[float]:
        """Wire bytes each worker receives per collective: ``size·itemsize
        + overhead``, times the fanout for a gather."""
        out = []
        for s, i, k, f, o in zip(self.sizes, self.itemsizes, self.kinds,
                                 self.fanouts, self.overheads):
            b = (s * i + o) * (f if k == "gather" else 1)
            out.append(int(b) if float(b).is_integer() else b)
        return out


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

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The stacked ``(W, ...)`` buffer already holds every worker's
        payload."""
        return x


# the process-group backend that carries tensors of each device type
DEVICE_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def check_backend_device(backend: str, device) -> None:
    """Raise unless a ``backend`` process group carries ``device`` tensors
    (:data:`DEVICE_BACKENDS`)."""
    dev = torch.device(device)
    want = DEVICE_BACKENDS.get(dev.type)
    if backend != want:
        raise ValueError(
            f"a {backend!r} process group cannot carry {dev.type} tensors: "
            f"{dev.type} needs a {want!r} group")


# torch.distributed calls made by every DistBackend of this process, by kind
CALLS = {"all_reduce": 0, "all_gather": 0}


def reset_calls() -> None:
    for kind in CALLS:
        CALLS[kind] = 0


@dataclasses.dataclass(frozen=True)
class DistBackend:
    """One data-parallel worker per process over a ``torch.distributed``
    process group (``None``: the default group).  Every tensor is this
    process's own, so there is no worker dim.  Each call is counted in
    :data:`CALLS`."""

    group: Any = None

    @property
    def workers(self) -> int:
        return tdist.get_world_size(self.group)

    @property
    def lead(self) -> Tuple[int, ...]:
        return ()

    def check_device(self, device) -> None:
        check_backend_device(tdist.get_backend(self.group), device)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the group: a sum all-reduce on a copy (``x`` may be a
        view of a caller's tensor), then a divide (gloo has no average)."""
        buf = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(buf, group=self.group)
        CALLS["all_reduce"] += 1
        return buf.div_(self.workers)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x``, stacked in rank order: ``(W,) + x.shape``."""
        out = x.new_empty(self.workers * x.numel())
        tdist.all_gather_into_tensor(out, x.reshape(-1), group=self.group)
        CALLS["all_gather"] += 1
        return out.view((self.workers,) + tuple(x.shape))


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Names of the data axes the computation is mapped over.

    stats:   optional :class:`CollectiveStats` (excluded from eq).
    backend: how the data-axis collectives run (:class:`SimBackend` or
             :class:`DistBackend`); given exactly when ``data_axes`` is
             non-empty.
    """

    data_axes: Tuple[str, ...] = ()
    sync_mode: str = "allreduce"
    stats: Optional[CollectiveStats] = dataclasses.field(default=None, compare=False)
    backend: Optional[Union[SimBackend, DistBackend]] = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        if self.sync_mode != "allreduce":
            raise NotImplementedError(
                f"sync_mode={self.sync_mode!r} is not ported yet (ROADMAP "
                f"queue A, item 13)")
        if bool(self.data_axes) != (self.backend is not None):
            raise ValueError("a MeshCtx has a backend exactly when it has "
                             "data axes")

    @property
    def lead(self) -> Tuple[int, ...]:
        """Leading worker dims of per-worker tensors (``()`` when every
        tensor is one worker's own)."""
        return self.backend.lead if self.backend is not None else ()

    def per_worker(self, x: torch.Tensor) -> torch.Tensor:
        """A worker-identical tensor stacked once per worker (contiguous)."""
        if not self.lead:
            return x
        return x.expand(self.lead + tuple(x.shape)).contiguous()

    def data_size(self) -> int:
        """Number of data-parallel workers (1 outside any data axis)."""
        return self.backend.workers if self.backend is not None else 1

    def _record(self, n_elems: int, itemsize: float, kind: str = "reduce",
                overhead: int = 0) -> None:
        if self.stats is not None:
            self.stats.record(n_elems, itemsize, kind=kind,
                              fanout=self.data_size() if kind == "gather" else 1,
                              overhead=overhead)

    def _record_chunk(self, chunk: matrixize.FlatChunk, kind: str) -> None:
        """Record a wire chunk at its honest cost: fractional itemsize (0.5
        for int4) plus the scale-sidecar bytes of a quantized chunk."""
        self._record(chunk.size, chunk.wire_itemsize, kind, chunk.overhead_bytes)

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
        ``pmean_data`` per part when no wire cast applies.

        Under ``wire_dtype="int8"``/``"int4"`` each float slot is quantized
        and dequantized on its worker and the mean is taken over the float32
        result (a widened accumulator); the record carries the quantized
        wire cost.  That record models the reference's wire, not what
        :class:`DistBackend` sends: its all-reduce moves the float32 result,
        4x the recorded bytes of an int8 chunk and 8x those of an int4
        chunk."""
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead)
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)
        out: dict = {}
        for chunk in plan.chunks:
            if chunk.quant is not None:
                buf = matrixize.quant_dequant_flat(chunk, parts, lead=nl)
            else:
                buf = matrixize.pack_flat(chunk, parts, lead=nl)
            self._record_chunk(chunk, "reduce")
            if self.data_axes:
                buf = self.backend.pmean(buf)
            out.update(matrixize.unpack_flat(chunk, buf))
        return [out[i] for i in range(len(parts))]

    def allgather_flat(self, parts: Sequence[torch.Tensor], *,
                       wire_dtype: str = "auto",
                       max_chunk_bytes: Optional[int] = None
                       ) -> List[torch.Tensor]:
        """Fused all-gather: one collective per wire chunk; every part comes
        back with a leading worker dim of ``data_size()``, held once.

        For payloads that cannot be summed on the wire (top-k selections):
        every worker receives every worker's payload.  Under the simulated
        backend the worker dim is already written out, so the gathered
        buffer is the ``(W, size)`` wire buffer itself.  A quantized chunk
        ships its integer codes (nibble-packed for int4) and its scale
        sidecar as two backend gathers, recorded as one collective, and is
        dequantized after the gather.  Recorded as ``kind="gather"`` with
        ``fanout=data_size()``."""
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead)
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)
        w = (self.data_size(),)
        out: dict = {}
        for chunk in plan.chunks:
            self._record_chunk(chunk, "gather")
            if chunk.quant is not None:
                payload, scales = matrixize.quant_pack_flat(chunk, parts, lead=nl)
                out.update(matrixize.quant_unpack_flat(
                    chunk, self._gather(payload), self._gather(scales),
                    leading=w))
                continue
            buf = self._gather(matrixize.pack_flat(chunk, parts, lead=nl))
            out.update(matrixize.unpack_flat(chunk, buf, leading=w))
        return [out[i] for i in range(len(parts))]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.backend.all_gather(x) if self.data_axes else x[None]

    def gather_data_weight(self) -> Optional[torch.Tensor]:
        """The workers' contribution weights for a gather-pattern combine,
        or ``None`` for uniform workers: no backend carries weights yet
        (scenario weights wait for ROADMAP queue A, item 6)."""
        return None


SINGLE = MeshCtx()  # single worker: all collectives are identities
