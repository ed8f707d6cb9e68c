"""The mesh context threaded through the model and the compression engine
(port of ``repro.core.dist``).

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

``sync_mode="broadcast"`` makes every data-axis aggregate
replica-deterministic: each reduce gathers the contributions in rank order
and sums them in one fixed pairwise tree (:func:`_tree_sum`), the same
expression on every rank and on both backends; fused transports defer the
replica sync to one rank-0 broadcast (:meth:`MeshCtx.broadcast_flat`).

The model axis (tensor parallelism) runs only over ``torch.distributed``:
``model_axis="model"`` and ``model_group``, the ranks that split one
replica (:mod:`repro_torch.launch.mesh`).  :meth:`MeshCtx.psum_model` is
Megatron's *f* (an ``all_reduce`` forward, the identity backward) and
:func:`model_grad_sync` its *g* (the identity forward, an ``all_reduce``
of the cotangent backward), the pair that makes every replicated gradient
whole on every model rank; ``tp_grad_sync=False`` is the reference's
legacy switch (``lax.psum``'s own transpose, no *g*).  Model-axis calls
are counted in :data:`MODEL_CALLS`, apart from the data axis's
:data:`CALLS`; :class:`CollectiveStats` records the data axis only.
Without a model axis every model collective is the identity.  Still to
come with ROADMAP queue A, item 14 (A14b): the mesh-aware checkpoints.
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
    receives ``fanout`` = W payloads; ``"broadcast"``: rank 0's payload
    delivered to every worker under ``sync_mode="broadcast"``, flat in W,
    ``fanout`` 1) and the scale-sidecar bytes of a quantized chunk
    (``overheads``).
    """

    data_collectives: int = 0
    sizes: List[int] = dataclasses.field(default_factory=list)
    itemsizes: List[float] = dataclasses.field(default_factory=list)
    kinds: List[str] = dataclasses.field(default_factory=list)
    fanouts: List[int] = dataclasses.field(default_factory=list)
    overheads: List[int] = dataclasses.field(default_factory=list)

    def record(self, n_elems: int, itemsize: float = 4, kind: str = "reduce",
               fanout: int = 1, overhead: int = 0) -> None:
        if kind not in ("reduce", "gather", "broadcast"):
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

    @property
    def broadcast_collectives(self) -> int:
        return sum(1 for k in self.kinds if k == "broadcast")

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


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading worker dim of a stacked ``(W, ...)`` tensor in
    one fixed pairwise tree, the canonical order of
    ``sync_mode="broadcast"``: adjacent rows are added in pairs, an odd
    last row is carried on unchanged, and the halving repeats until one row
    is left.  Every add runs in ``x``'s dtype (a bfloat16 buffer rounds
    after each add), so every rank and both backends replay the same
    expression and get the same bits, the JAX package's too.  Not
    :func:`worker_sum`'s left fold, nor ``torch.sum``'s order.  Returns a
    new tensor; ``x`` is never written."""
    n = x.shape[0]
    if n == 1:
        return x[0].clone()
    while n > 1:
        half = n // 2
        paired = x[0:2 * half:2] + x[1:2 * half:2]
        if n % 2:
            paired = torch.cat([paired, x[2 * half:]])
        x, n = paired, n - half
    return x[0]


def _from_rank0(x: torch.Tensor, workers: int) -> torch.Tensor:
    """Rank 0's ``x`` as the JAX package's broadcast delivers it to each of
    ``workers`` ranks: a masked unweighted sum, rank 0's value plus W − 1
    exact zeros.  At W ≥ 2 that sum turns −0.0 into +0.0 and leaves every
    other value as it is, a NaN with its payload too; at W = 1 it has one
    term and keeps the sign.  Written as a select of the zeros, not an add,
    since an add on the card would write its own NaN (0x7FFFFFFF) where
    the reference keeps the input's.  A new tensor."""
    return x.clone() if workers == 1 else x.masked_fill(x == 0, 0)


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

    def broadcast0(self, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """Worker 0's copy of ``x``, held once (:func:`_from_rank0`'s bits):
        row 0 of a stacked ``(W, ...)`` tensor, or a held-once ``x`` itself
        (``stacked=False``).  Scenario weights never apply: a broadcast is a
        replica sync, not an aggregate, so a dropped worker 0 still
        delivers its copy."""
        return _from_rank0(x[0] if stacked else x, self.workers)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the leading worker dim of a stacked ``(W, ...)``
        tensor."""
        return x.amax(dim=0)


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
CALLS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


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
        return self.all_gather_issue(x)()

    def all_gather_issue(self, x: torch.Tensor) -> Callable[[], torch.Tensor]:
        """:meth:`all_gather` in two halves: the ``all_gather_into_tensor``
        is issued now (``async_op=True``, counted in :data:`CALLS` now),
        and the returned function waits on it and returns the stack."""
        out = x.new_empty(self.workers * x.numel())
        work = tdist.all_gather_into_tensor(out, x.reshape(-1), group=self.group,
                                            async_op=True)
        CALLS["all_gather"] += 1

        def wait() -> torch.Tensor:
            work.wait()
            return out.view((self.workers,) + tuple(x.shape))
        return wait

    def broadcast0(self, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """Rank 0's ``x`` on every rank: a ``broadcast`` of a copy (half an
        all-reduce's bytes), then :func:`_from_rank0`'s −0.0 → +0.0 on
        every rank where the group has two or more, so the bits are those
        of the JAX package's masked sum (and of
        :meth:`SimBackend.broadcast0`).  ``stacked`` is ignored: a process
        holds only its own tensors."""
        buf = x.clone(memory_format=torch.contiguous_format)
        src = 0 if self.group is None else tdist.get_global_rank(self.group, 0)
        tdist.broadcast(buf, src=src, group=self.group)
        CALLS["broadcast"] += 1
        return buf if self.workers == 1 else buf.masked_fill_(buf == 0, 0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the group: a ``MAX`` all-reduce of a copy."""
        buf = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(buf, op=tdist.ReduceOp.MAX, group=self.group)
        CALLS["all_reduce"] += 1
        return buf


# model-axis torch.distributed calls, forward and backward, by kind
MODEL_CALLS = {"all_reduce": 0, "all_gather": 0}


def reset_model_calls() -> None:
    for kind in MODEL_CALLS:
        MODEL_CALLS[kind] = 0


def _model_all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """An ``all_reduce`` over the model group of a copy of ``x``."""
    buf = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM if op is None else op,
                     group=group)
    MODEL_CALLS["all_reduce"] += 1
    return buf


class _ModelPsum(torch.autograd.Function):
    """Megatron's *f*: the model group's sum forward; backward the identity
    (``grad_reduce=False``) or, as ``lax.psum``'s own transpose, the sum
    again (the reference's ``tp_grad_sync=False``)."""

    @staticmethod
    def forward(ctx, x, group, grad_reduce):
        ctx.group, ctx.grad_reduce = group, grad_reduce
        return _model_all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        if ctx.grad_reduce:
            ct = _model_all_reduce(ct, ctx.group)
        return ct, None, None


class _ModelGradSync(torch.autograd.Function):
    """Megatron's *g*: the identity forward, the model group's sum of the
    cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _model_all_reduce(ct, ctx.group), None


class _ModelAllGather(torch.autograd.Function):
    """The model group's pieces concatenated along ``axis`` in rank order
    (``lax.all_gather(..., tiled=True)``).  Backward is that gather's
    transpose, a reduce-scatter, written as a sum ``all_reduce`` of the
    cotangent and this rank's slice of it (gloo has no reduce-scatter; for
    two ranks the sums are the same bits)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        n = tdist.get_world_size(group)
        xc = x.contiguous()
        flat = xc.new_empty(n * xc.numel())   # gloo gathers into flat outputs
        tdist.all_gather_into_tensor(flat, xc.reshape(-1), group=group)
        MODEL_CALLS["all_gather"] += 1
        ctx.group, ctx.axis, ctx.n = group, axis, n
        ctx.index = tdist.get_group_rank(group, tdist.get_rank())
        return torch.cat(flat.view((n,) + tuple(xc.shape)).unbind(0), dim=axis)

    @staticmethod
    def backward(ctx, ct):
        total = _model_all_reduce(ct, ctx.group)
        size = ct.shape[ctx.axis] // ctx.n
        return total.narrow(ctx.axis, ctx.index * size, size), None, None


def model_grad_sync(x: torch.Tensor, ctx: "MeshCtx") -> torch.Tensor:
    """Megatron's *g* on ``x`` under ``ctx``: a no-op without a model axis
    or with ``tp_grad_sync=False``."""
    if ctx.model_axis is None or not ctx.tp_grad_sync:
        return x
    return _ModelGradSync.apply(x, ctx.model_group)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Names of the data axes (and model axis) the computation is mapped
    over.

    sync_mode: ``"allreduce"`` (default) trusts the backend's reduce to
             hand every rank the same value, which a library reduce whose
             order depends on the rank does not promise at the last bit.
             ``"broadcast"`` makes every data-axis aggregate
             replica-deterministic: the contributions are gathered in rank
             order and summed in one canonical pairwise tree
             (:func:`_tree_sum`) on every rank, and each reduce is recorded
             as its two logical legs, ``"reduce"`` + ``"broadcast"``.  A
             fused transport passes ``sync=False`` to its phase reduces and
             sends one real rank-0 broadcast at the end of the step
             (:meth:`broadcast_flat`).
    stats:   optional :class:`CollectiveStats` (excluded from eq).
    backend: how the data-axis collectives run (:class:`SimBackend` or
             :class:`DistBackend`); given exactly when ``data_axes`` is
             non-empty.
    model_axis: ``"model"`` where the model's weights are split over
             ``model_group`` (tensor parallelism), else ``None``.
    tp_grad_sync: whether :func:`model_grad_sync` sums cotangents over the
             model group where a replicated activation enters sharded
             compute (*g*) and :meth:`psum_model` passes its cotangent
             through (*f*).  ``True`` (default) gives whole gradients on
             every model rank; ``False`` is the reference's legacy debug
             switch: no *g*, and a sum backward for :meth:`psum_model`.
    model_group: the ``torch.distributed`` group of the model axis; given
             exactly when ``model_axis`` is.
    """

    data_axes: Tuple[str, ...] = ()
    sync_mode: str = "allreduce"
    stats: Optional[CollectiveStats] = dataclasses.field(default=None, compare=False)
    backend: Optional[Union[SimBackend, DistBackend]] = dataclasses.field(
        default=None, compare=False)
    model_axis: Optional[str] = None
    tp_grad_sync: bool = True
    model_group: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.sync_mode not in ("allreduce", "broadcast"):
            raise ValueError(f"unknown sync_mode {self.sync_mode!r}")
        if bool(self.data_axes) != (self.backend is not None):
            raise ValueError("a MeshCtx has a backend exactly when it has "
                             "data axes")
        if (self.model_axis is None) != (self.model_group is None):
            raise ValueError("a MeshCtx has a model group exactly when it "
                             "has a model axis")

    # -- the model axis (tensor parallelism) ------------------------------
    def model_size(self) -> int:
        """Ranks on the model axis (1 without one)."""
        return 1 if self.model_axis is None else tdist.get_world_size(self.model_group)

    def model_index(self) -> int:
        """This rank's index on the model axis (0 without one)."""
        if self.model_axis is None:
            return 0
        return tdist.get_group_rank(self.model_group, tdist.get_rank())

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model axis, Megatron's *f*: identity backward, or
        under ``tp_grad_sync=False`` a sum backward as ``lax.psum``'s."""
        if self.model_axis is None:
            return x
        return _ModelPsum.apply(x, self.model_group, not self.tp_grad_sync)

    def pmean_model(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the model axis of a tensor outside autograd (metrics)."""
        if self.model_axis is None:
            return x
        return _model_all_reduce(x, self.model_group).div_(self.model_size())

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the model axis of a tensor outside autograd."""
        if self.model_axis is None:
            return x
        return _model_all_reduce(x, self.model_group, tdist.ReduceOp.MAX)

    def all_gather_model(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """The model ranks' ``x`` concatenated along ``axis`` in rank order;
        backward the reduce-scatter that is the gather's transpose."""
        if self.model_axis is None:
            return x
        return _ModelAllGather.apply(x, self.model_group, axis % x.dim())

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

    @property
    def _synced(self) -> bool:
        return self.sync_mode == "broadcast" and bool(self.data_axes)

    def _canonical_reduce(self, stacked: torch.Tensor, *,
                          mean: bool) -> torch.Tensor:
        """The replica-deterministic sum or mean of ``sync_mode=
        "broadcast"`` over ``stacked``, every worker's contribution in rank
        order (:class:`SimBackend`'s stacked buffer as it is,
        :class:`DistBackend`'s all-gather): :func:`_tree_sum`, the mean
        divided by W in the buffer's dtype.  A weighted
        :class:`SimBackend` follows the JAX package's recipe, which is not
        :func:`stacked_weighted_mean`'s: the weights are cast to the
        buffer's dtype before the multiply, the sum Σwᵢxᵢ runs in the
        tree, and the mean divides it in float32 by the tree sum of the
        float32 weights, held at float32's smallest normal (an all-dropped
        round gives exactly zero), then casts back."""
        weights = getattr(self.backend, "weights", None)
        if weights is None:
            total = _tree_sum(stacked)
            return total.div_(self.data_size()) if mean else total
        numer = _tree_sum(stacked * _per_worker_view(weights, stacked).to(
            stacked.dtype))
        if not mean:
            return numer
        denom = torch.clamp_min(_tree_sum(weights),
                                torch.finfo(weights.dtype).tiny)
        return (numer.to(weights.dtype) / denom).to(stacked.dtype)

    def _reduce(self, x: torch.Tensor, n_elems: int, *, mean: bool,
                sync: Optional[bool]) -> torch.Tensor:
        """:meth:`pmean_data` / :meth:`psum_data` after the reduce record."""
        if not self.data_axes:
            return x
        if self._synced:
            if sync is not False:
                self._record(n_elems, x.dtype.itemsize, "broadcast")
            return self._canonical_reduce(self._gather(x), mean=mean)
        return self.backend.pmean(x) if mean else self.backend.psum(x)

    def pmean_data(self, x: torch.Tensor, *,
                   sync: Optional[bool] = None) -> torch.Tensor:
        """Mean over the data axes of one per-worker tensor.  Under
        ``sync_mode="broadcast"`` the canonical reduce, recorded as a
        reduce and a broadcast (``sync=False``: the reduce only)."""
        n = math.prod(x.shape[len(self.lead):])
        self._record(n, x.dtype.itemsize)
        return self._reduce(x, n, mean=True, sync=sync)

    def psum_data(self, x: torch.Tensor, *,
                  sync: Optional[bool] = None) -> torch.Tensor:
        """Sum over the data axes of one per-worker tensor (recorded as
        :meth:`pmean_data` is)."""
        n = math.prod(x.shape[len(self.lead):])
        self._record(n, x.dtype.itemsize)
        return self._reduce(x, n, mean=False, sync=sync)

    def pmean_flat(self, parts: Sequence[torch.Tensor], *,
                   wire_dtype: str = "auto",
                   max_chunk_bytes: Optional[int] = None,
                   sync: Optional[bool] = None,
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
        result is bit for bit the same.

        Under ``sync_mode="broadcast"`` each chunk takes the canonical
        reduce (:meth:`_canonical_reduce`; under :class:`DistBackend` one
        ``all_gather`` a chunk, issued asynchronously when interleaved and
        summed after its wait) and records a broadcast leg after its
        reduce: the wire buffer's elements at its own itemsize, float32
        for a quantized chunk (the dequantized buffer).  ``sync=False``
        keeps the canonical order and records the reduce only, for a
        scheme that ends its step with one :meth:`broadcast_flat`."""
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead)
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)
        pipelined = interleave and isinstance(self.backend, DistBackend)

        def issue(chunk) -> Callable[[], torch.Tensor]:
            if chunk.quant is not None:
                buf = matrixize.quant_dequant_flat(chunk, parts, lead=nl)
            else:
                buf = matrixize.pack_flat(chunk, parts, lead=nl)
            self._record_chunk(chunk, "reduce")
            if not self.data_axes:
                return lambda: buf
            if self._synced:
                if sync is not False:
                    self._record(chunk.size, buf.dtype.itemsize, "broadcast")
                if pipelined:
                    wait = self.backend.all_gather_issue(buf)
                    return lambda: self._canonical_reduce(wait(), mean=True)
                buf = self._canonical_reduce(self._gather(buf), mean=True)
                return lambda: buf
            if pipelined:
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

    def broadcast_flat(self, parts: Sequence[torch.Tensor], *,
                       wire_dtype: str = "auto",
                       max_chunk_bytes: Optional[int] = None,
                       stacked: bool = False) -> List[torch.Tensor]:
        """Fused rank-0 broadcast, the end-of-step replica sync of
        ``sync_mode="broadcast"``: every part replaced by worker 0's copy,
        held once.  Parts are packed into wire chunks as
        :meth:`pmean_flat` packs them, and each chunk is one backend
        ``broadcast0`` (the bits of the JAX package's masked sum: −0.0
        comes back as +0.0 where W ≥ 2), recorded as ``kind="broadcast"``,
        bytes flat in W.  Without data axes it records and returns the
        parts' values.

        ``stacked=False`` (the path's case): the parts are held once, as
        the port holds every worker-identical aggregate (P̂, Q, the
        uncompressed aggregates).  ``stacked=True``: under
        :class:`SimBackend` the parts carry the worker dim and worker 0's
        row is delivered, as the JAX package's per-worker broadcast does.
        A quantized wire remaps to ``"auto"``: the sync delivers rank 0's
        exact bits, not a requantization."""
        if wire_dtype in matrixize.QUANT_WIRE_DTYPES:
            wire_dtype = "auto"
        parts = list(parts)
        if not parts:
            return []
        nl = len(self.lead) if stacked else 0
        plan = matrixize.plan_flat(parts, wire_dtype=wire_dtype,
                                   max_chunk_bytes=max_chunk_bytes, lead=nl)
        out: dict = {}
        for chunk in plan.chunks:
            buf = matrixize.pack_flat(chunk, parts, lead=nl)
            self._record_chunk(chunk, "broadcast")
            if self.data_axes:
                buf = self.backend.broadcast0(buf, stacked=bool(nl))
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
        """The workers' contribution weights as a ``(W,)`` vector for a
        gather-pattern combine, or ``None`` for uniform workers.

        Gather-pattern schemes average *decoded* payloads on the receiver,
        so scenario weights travel with the payloads as a side channel: the
        engine weights its combine exactly as a weighted ``pmean``.  Not
        recorded in ``stats`` (no collective budget is spent on it).  Only
        a weighted :class:`SimBackend` carries weights."""
        return getattr(self.backend, "weights", None)


SINGLE = MeshCtx()  # single worker: all collectives are identities
