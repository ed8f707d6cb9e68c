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

Not ported yet: model-axis collectives (ROADMAP queue A, item 14),
``broadcast_flat`` and ``sync_mode="broadcast"`` (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

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


def worker_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading worker dim of a stacked ``(W, ...)`` tensor, as
    the JAX package's ``lax.psum`` over a ``vmap``'d worker axis sums it.
    A bfloat16 tensor is folded in worker order, ``((x₀ + x₁) + x₂) + …``,
    rounded to bfloat16 after every add (``x.sum(0)`` would accumulate in
    float32 and round once, which differs from the reference at W ≥ 3);
    the fold starts from a copy, so ``x`` is never written.  Other dtypes
    take ``x.sum(0)``."""
    if x.dtype != torch.bfloat16:
        return x.sum(dim=0)
    acc = x[0].clone()
    for xi in x[1:]:
        acc += xi
    return acc


def weighted_mean(x: torch.Tensor, w: torch.Tensor, sum_fn,
                  in_place: bool = False) -> torch.Tensor:
    """``Σ w·x / Σ w`` with a guarded denominator, ``sum_fn`` the sum over
    the workers (:func:`worker_sum` over a stacked worker dim, ``w`` viewed
    as ``(W, 1, …, 1)``).  The single home of the weighted-aggregation
    semantics: :meth:`SimBackend.pmean` and the engine's receiver-side
    combine (:meth:`repro_torch.core.engine.Transport.combine_mean`) both
    call it, so the two are bit-equal.  If every weight is 0 the result is
    exactly zero, not NaN; the numerator is summed in ``x``'s dtype (a
    bfloat16 wire folds it in bfloat16) and the division happens in the
    weight's dtype (float32).  ``in_place=True`` scales ``x`` itself (the
    caller's buffer is consumed) instead of a copy: the same values, and no
    second ``x``-sized buffer."""
    total = sum_fn(w)
    wx = w.to(x.dtype)
    numer = sum_fn(x.mul_(wx) if in_place else x * wx)
    denom = torch.clamp_min(total, torch.finfo(total.dtype).tiny)
    return (numer.to(total.dtype) / denom).to(x.dtype)


def _per_worker_view(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(W,)`` weights viewed as ``(W, 1, …, 1)`` against a stacked ``x``."""
    return weights.view((-1,) + (1,) * (x.dim() - 1))


def stacked_weighted_mean(x: torch.Tensor, weights: torch.Tensor,
                          in_place: bool = False) -> torch.Tensor:
    """:func:`weighted_mean` over the leading worker dim of a stacked
    ``(W, ...)`` tensor, ``weights`` a ``(W,)`` vector: what a weighted
    :meth:`SimBackend.pmean` and the engine's weighted combine compute."""
    return weighted_mean(x, _per_worker_view(weights, x), worker_sum, in_place)


@dataclasses.dataclass(frozen=True, eq=False)
class SimBackend:
    """W simulated workers stacked on a leading dim of every per-worker
    tensor; the mean over workers is exact and held once.

    ``weights`` (optional, a float32 ``(W,)`` tensor on the step's device)
    are the workers' scenario weights: heterogeneous batches (a worker's
    valid-token count), dropout and stragglers skipped this round (0).
    ``pmean`` is then ``Σ wᵢxᵢ / Σ wᵢ`` (exactly zero when every worker is
    dropped) and ``psum`` is ``Σ wᵢxᵢ``; ``all_gather`` is unweighted (the
    weights travel beside the payloads, :meth:`MeshCtx.gather_data_weight`).

    Sums run in the buffer's dtype in the JAX package's order
    (:func:`worker_sum`): a bfloat16 wire buffer is folded over the workers
    in bfloat16 and the unweighted mean divides it by W in bfloat16, bit
    for bit as the reference's ``lax.pmean``.
    """

    workers: int
    weights: Optional[torch.Tensor] = None

    @property
    def lead(self) -> Tuple[int, ...]:
        return (self.workers,)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        if self.weights is not None:
            return stacked_weighted_mean(x, self.weights)
        if x.dtype == torch.bfloat16:
            return worker_sum(x).div_(self.workers)
        return x.mean(dim=0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if self.weights is None:
            return worker_sum(x)
        return worker_sum(x * _per_worker_view(self.weights, x).to(x.dtype))

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
        view of a caller's tensor), then a divide (gloo has no average), in
        ``x``'s dtype.  A bfloat16 wire buffer is summed in the library's
        order (NCCL's or gloo's), not in the JAX package's worker-order
        fold (:func:`worker_sum`), so across processes the bfloat16 mean
        agrees with the reference's within a few bfloat16 roundings, not
        bit for bit; the divide runs in bfloat16 as the reference's."""
        return self.psum(x).div_(self.workers)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group: an ``all_reduce`` on a copy."""
        buf = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(buf, group=self.group)
        CALLS["all_reduce"] += 1
        return buf

    def pmean_issue(self, x: torch.Tensor) -> Callable[[], torch.Tensor]:
        """:meth:`pmean` in two halves: the ``all_reduce`` of a copy is
        issued now (``async_op=True``, counted in :data:`CALLS` now), and
        the returned function waits on it and divides, giving
        :meth:`pmean`'s bits."""
        buf = x.clone(memory_format=torch.contiguous_format)
        work = tdist.all_reduce(buf, group=self.group, async_op=True)
        CALLS["all_reduce"] += 1

        def wait() -> torch.Tensor:
            work.wait()
            return buf.div_(self.workers)
        return wait

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

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data axes of one per-worker tensor (recorded as a
        reduce, as :meth:`pmean_data` is)."""
        self._record(math.prod(x.shape[len(self.lead):]), x.dtype.itemsize)
        return self.backend.psum(x) if self.data_axes else x

    def pmean_flat(self, parts: Sequence[torch.Tensor], *,
                   wire_dtype: str = "auto",
                   max_chunk_bytes: Optional[int] = None,
                   interleave: bool = False) -> List[torch.Tensor]:
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
        chunk.

        ``interleave=True`` is the double-buffered schedule: the reduce of
        chunk b is issued before chunk b−1 is unpacked.  Under
        :class:`DistBackend` the reduce is an asynchronous ``all_reduce``
        (:meth:`DistBackend.pmean_issue`), waited on just before its chunk
        is unpacked; :class:`SimBackend` reduces at issue.  Chunks, bytes,
        reduction order, the records (made at issue) and the
        ``torch.distributed`` calls are the serial schedule's, so the
        result is bit for bit the same."""
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead)
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)

        def issue(chunk) -> Callable[[], torch.Tensor]:
            if chunk.quant is not None:
                buf = matrixize.quant_dequant_flat(chunk, parts, lead=nl)
            else:
                buf = matrixize.pack_flat(chunk, parts, lead=nl)
            self._record_chunk(chunk, "reduce")
            if not self.data_axes:
                return lambda: buf
            if interleave and isinstance(self.backend, DistBackend):
                return self.backend.pmean_issue(buf)
            buf = self.backend.pmean(buf)
            return lambda: buf

        out: dict = {}
        pending = None   # the chunk in flight and its result
        for chunk in plan.chunks:
            result = issue(chunk)
            if not interleave:
                out.update(matrixize.unpack_flat(chunk, result()))
                continue
            if pending is not None:
                out.update(matrixize.unpack_flat(pending[0], pending[1]()))
            pending = (chunk, result)
        if pending is not None:
            out.update(matrixize.unpack_flat(pending[0], pending[1]()))
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
        """The workers' contribution weights as a ``(W,)`` vector for a
        gather-pattern combine, or ``None`` for uniform workers.

        Gather-pattern schemes average *decoded* payloads on the receiver,
        so scenario weights travel with the payloads as a side channel: the
        engine weights its combine exactly as a weighted ``pmean``.  Not
        recorded in ``stats`` (no collective budget is spent on it).  Only
        a weighted :class:`SimBackend` carries weights."""
        return getattr(self.backend, "weights", None)


SINGLE = MeshCtx()  # single worker: all collectives are identities
