"""The compressed-collective transport engine (port of
``repro.core.engine``).

* :class:`Transport` — the fused all-reduce and all-gather bound to a
  context and a wire policy, and the receiver-side mean over gathered
  decodes; :class:`PipelinedTransport`, its double-buffered form for the
  one-step-stale pipeline.
* :class:`MatrixPayloads` — a tree's compressed leaves as zero-padded
  ``(B, n, m)`` bucket slabs, and the scatter of results back to the tree.
* :func:`run_step` — the generic step of single-round schemes (the whole
  zoo but PowerSGD).  A compressor declares per leaf what travels
  (``encode_leaf`` → :class:`Encoded`) and how to rebuild a leaf from a
  payload (``decode_leaf``); ``wire_mode`` says how it travels:
  ``"reduce"`` all-reduces the fused payloads and decodes once,
  ``"gather"`` all-gathers them, decodes every worker's payload and
  averages the W decodes.  Uncompressed leaves ride one fused all-reduce.
* :func:`keystr`, :func:`step_seed`, :func:`leaf_seed` — the seeds of the
  shared-seed draws: a leaf's draws depend only on the step's seed and the
  leaf's path, so every worker draws the same values.

Under a simulated data-parallel context the per-worker tensors carry the
worker dims ``ctx.lead``: ``encode_leaf(path, g, q, spec, lead)`` gets a
``lead + shape`` delta and returns payloads with the same leading dims,
and ``decode_leaf(enc, payload, lead)`` rebuilds ``lead + shape`` from
payloads that carry ``lead`` (the worker's own payload, or the gathered
``(W,)`` stack).  Under a ``torch.distributed`` context ``lead`` is ``()``.

Under a model axis each rank runs the engine on its local shards with
data-axis collectives only.  :class:`StatePartition` records how each
state leaf relates to the model axis (replicated, sharded, or model-LOCAL:
per-rank content behind a replicated-shaped spec), and
:func:`partition_mismatches` audits a partition tree against a state.
The mesh-aware checkpoints that read these records wait for ROADMAP queue
A, item 14 (A14b).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.core import dist, matrixize
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.sharding import mentions


def keystr(path) -> str:
    """A leaf's path written as ``jax.tree_util.keystr`` writes a path of
    dict keys: ``('blocks', 'wq')`` → ``"['blocks']['wq']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _seed63(text: str) -> int:
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step`` of a run with base seed ``seed`` (the twin
    of the JAX package's ``fold_in(key, step)``): every worker and every
    rank derives the same value."""
    return _seed63(f"step:{int(seed)}:{int(step)}")


def leaf_seed(seed: int, path) -> int:
    """A 63-bit seed for one leaf's draws (the twin of ``leaf_key``): a
    function of the step's ``seed`` and the leaf's path only, not of the
    worker, the rank, the leaf order or the device."""
    return _seed63(f"leaf:{int(seed)}:{keystr(path)}")


def leaf_generator(seed: int, path) -> torch.Generator:
    """A fresh CPU generator seeded with :func:`leaf_seed`.  Draws are made
    on the CPU, so a leaf draws the same values whatever device it lives
    on (a CUDA generator with the same seed gives another stream)."""
    return torch.Generator().manual_seed(leaf_seed(seed, path))


@dataclasses.dataclass
class CompressOut:
    """What one compress+aggregate step hands back to error feedback."""

    agg: Any              # tree: aggregated update, worker-identical, held once
    recon: Any            # tree: reconstruction used for the error update
    state: Any            # tree: new compressor state (warm-start Q)
    bits_per_worker: int  # payload bits sent per step per worker
    metrics: Any = None   # optional dict of observability tensors (PowerSGD's
    #                       residual ratios under track_residual)


@dataclasses.dataclass(frozen=True)
class Encoded:
    """One leaf's wire declaration: ``payload`` travels, ``aux`` stays local
    (shape breadcrumbs for decode), ``bits`` is the analytic payload size
    per worker."""

    payload: Tuple[torch.Tensor, ...]
    aux: Any = None
    bits: int = 0


@dataclasses.dataclass(frozen=True)
class Transport:
    """Fused data-axis transport bound to a context and a wire policy."""

    ctx: MeshCtx = SINGLE
    wire_dtype: str = "auto"
    max_chunk_bytes: Optional[int] = None

    def reduce_mean(self, parts: Sequence[torch.Tensor],
                    sync: Optional[bool] = None) -> List[torch.Tensor]:
        """Fused all-reduce-mean (one collective per wire chunk).
        ``sync=False`` (meaningful under ``sync_mode="broadcast"`` only)
        marks a phase of a multi-reduce scheme: the canonical order, but no
        broadcast leg recorded, since the scheme ends with one
        :meth:`broadcast`."""
        return self.ctx.pmean_flat(parts, wire_dtype=self.wire_dtype,
                                   max_chunk_bytes=self.max_chunk_bytes,
                                   sync=sync)

    def broadcast(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Fused rank-0 broadcast of held-once parts, the end-of-step
        replica sync of ``sync_mode="broadcast"``
        (:meth:`MeshCtx.broadcast_flat`)."""
        return self.ctx.broadcast_flat(parts, wire_dtype=self.wire_dtype,
                                       max_chunk_bytes=self.max_chunk_bytes)

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Fused all-gather (one collective per wire chunk); every part comes
        back with a leading worker dim of ``ctx.data_size()``."""
        return self.ctx.allgather_flat(parts, wire_dtype=self.wire_dtype,
                                       max_chunk_bytes=self.max_chunk_bytes)

    @staticmethod
    def combine_mean(stacked: torch.Tensor,
                     weights: Optional[torch.Tensor]) -> torch.Tensor:
        """Average W per-worker decodes over the leading gathered dim: the
        plain mean (``weights=None``) or the weighted ``pmean`` semantics of
        :func:`repro_torch.core.dist.weighted_mean` (an all-dropped round
        gives exactly zero): the same function as, so bit-equal to, a weighted
        :meth:`~repro_torch.core.dist.SimBackend.pmean` of ``stacked``.
        Weighted, it consumes ``stacked``: the decodes are scaled in place,
        so no second ``(W,) + leaf`` buffer is made."""
        if weights is None:
            return stacked.mean(dim=0)
        return dist.stacked_weighted_mean(stacked, weights, in_place=True)


@dataclasses.dataclass(frozen=True)
class PipelinedTransport(Transport):
    """The double-buffered :class:`Transport`, the engine half of the
    one-step-stale pipeline (``staleness="one_step"``), bit for bit the
    serial transport:

    * within a step, :meth:`reduce_mean` runs the interleaved chunk
      schedule (``MeshCtx.pmean_flat(interleave=True)``): chunk b's reduce
      is issued before chunk b−1 is unpacked, with the serial schedule's
      chunks, bytes, reduction order and records;
    * across steps, :meth:`shift` rotates the double buffer: this step's
      fresh aggregate in, the one to apply now (step t−1's) out.  The
      in-flight tree is explicit state (``EFState.inflight``), so a
      checkpoint carries it.
    """

    def reduce_mean(self, parts: Sequence[torch.Tensor],
                    sync: Optional[bool] = None) -> List[torch.Tensor]:
        return self.ctx.pmean_flat(parts, wire_dtype=self.wire_dtype,
                                   max_chunk_bytes=self.max_chunk_bytes,
                                   sync=sync, interleave=True)

    @staticmethod
    def shift(fresh, inflight):
        """``(apply_now, new_inflight)`` = ``(inflight, fresh)``: structure
        only.  The step that runs in place parks ``fresh`` by copying it
        into the in-flight tree's own storage
        (:func:`repro_torch.core.error_feedback.apply_updates`)."""
        return inflight, fresh

    @staticmethod
    def init_inflight(params):
        """The step-0 in-flight tree: zeros shaped like ``params``, on their
        device (the pipeline bubble applies no update)."""
        return tree.map(torch.zeros_like, params)


def collect_leaves(deltas, state, specs) -> list:
    """Aligned ``(path, g, q, spec)`` tuples in tree order; ``state=None``
    gives every leaf ``q=None``."""
    paths_g = list(tree.items(deltas))
    qs = [None] * len(paths_g) if state is None else tree.leaves(state)
    spec_leaves = tree.leaves(specs)
    if not len(paths_g) == len(qs) == len(spec_leaves):
        raise ValueError("deltas, state and specs trees do not align")
    return [(path, g, q, spec)
            for (path, g), q, spec in zip(paths_g, qs, spec_leaves)]


def scatter_tree(deltas, results):
    """Per-leaf ``(agg, recon, state)`` triples (in :func:`collect_leaves`
    order) → three trees shaped like ``deltas``."""
    return tuple(tree.unflatten(deltas, [r[k] for r in results])
                 for k in range(3))


# ---------------------------------------------------------------------------
# Per-leaf state partitioning: how a state leaf relates to the model axis
# ---------------------------------------------------------------------------

# Only the first two are visible in a leaf's dims spec; the third is the
# class of leaves a checkpoint that reads model rank 0's copy corrupts.
MODEL_REPLICATED = "replicated"  # the same bits on every model rank
MODEL_SHARDED = "sharded"        # a dim carries the model axis
MODEL_LOCAL = "local"            # per-model-rank content, no dim carrying the
#                                  axis (the Q factor of a row-parallel
#                                  weight: Q = Mᵀ P̂ from the rank's n-rows)


@dataclasses.dataclass(frozen=True)
class StatePartition:
    """Partition record of one state leaf: ``spec``, the dims
    :class:`~repro_torch.sharding.PartitionSpec` the leaf is sliced by, and
    ``model``, one of :data:`MODEL_REPLICATED` / :data:`MODEL_SHARDED` /
    :data:`MODEL_LOCAL`."""

    spec: Any
    model: str


def partition_leaves(partition, leaves) -> list:
    """Per-leaf model relation (or ``None``) aligned with
    :func:`collect_leaves`'s leaves."""
    rels = [None if p is None else p.model for p in tree.leaves(partition)]
    if len(rels) != len(leaves):
        raise ValueError(f"the partition has {len(rels)} leaves, the state "
                         f"{len(leaves)}")
    return rels


def _items_with_path(t, path: str = ""):
    """``(keystr path, leaf)`` pairs as ``jax.tree_util.
    tree_flatten_with_path`` writes them: dict keys as ``['k']``, the
    fields of a state dataclass (``EFState``) as ``.name``; ``None`` has no
    leaves; a :class:`StatePartition` is a leaf."""
    if t is None:
        return
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _items_with_path(t[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(t) and not isinstance(t, StatePartition):
        for f in dataclasses.fields(t):
            yield from _items_with_path(getattr(t, f.name), f"{path}.{f.name}")
    else:
        yield path, t


def partition_mismatches(state, partition, model_axis: str = "model",
                         mesh_axes=None) -> list:
    """Structural audit of a :class:`StatePartition` tree against a state
    (a compressor state or a whole ``EFState``): ``(path, problem,
    detail)`` triples, empty when the tree is sound.  Per state leaf:

    * ``"unclassified"`` — no :class:`StatePartition` at its path;
    * ``"spec-rank"`` — the spec names more dims than the leaf has;
    * ``"unknown-axis"`` — the spec names an axis not in ``mesh_axes``
      (when given);
    * ``"model-mismatch"`` — the spec carries ``model_axis`` but the leaf
      is not :data:`MODEL_SHARDED`, or the other way round.
    """
    problems = []
    state_paths = dict(_items_with_path(state))
    part_paths = {p: x for p, x in _items_with_path(partition)
                  if isinstance(x, StatePartition)}
    for path, leaf in sorted(state_paths.items()):
        part = part_paths.get(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if part is None:
            problems.append((path, "unclassified",
                             f"state leaf {shape} has no StatePartition"))
            continue
        entries = tuple(part.spec) if part.spec is not None else ()
        if len(entries) > len(shape):
            problems.append((path, "spec-rank",
                             f"spec {part.spec} names {len(entries)} dims "
                             f"for a {len(shape)}-d leaf"))
        if mesh_axes is not None:
            for e in entries:
                for ax in ((e,) if isinstance(e, str) else (e or ())):
                    if ax not in mesh_axes:
                        problems.append((path, "unknown-axis",
                                         f"spec {part.spec} names axis "
                                         f"{ax!r} not on the mesh "
                                         f"{tuple(mesh_axes)}"))
        carries = any(mentions(e, model_axis) for e in entries)
        if part.model == MODEL_SHARDED and not carries:
            problems.append((path, "model-mismatch",
                             f"classified {MODEL_SHARDED} but spec "
                             f"{part.spec} never carries {model_axis!r}"))
        if part.model in (MODEL_REPLICATED, MODEL_LOCAL) and carries:
            problems.append((path, "model-mismatch",
                             f"classified {part.model} but spec {part.spec} "
                             f"carries {model_axis!r}"))
    return problems


@dataclasses.dataclass
class MatrixPayloads:
    """A tree's compressed leaves as zero-padded ``(B, n, m)`` bucket slabs.

    ``lead`` is the worker dims of the per-worker ``deltas``: slabs are
    ``lead + (B, n, m)``, factor slabs ``(B, m, r)`` (the warm-start state is
    worker-identical and held once).  The rank of each bucket is read off
    its leaves' factors; leaves sharing a bucket must share a rank.
    """

    deltas: Any
    leaves: list                        # (path, g, q, spec) in tree order
    plan: matrixize.BucketPlan
    m_bufs: List[torch.Tensor]          # per bucket: lead + (B, n, m)
    q_bufs: List[torch.Tensor]          # per bucket: (B, m, r_b)
    lshapes: list                       # per leaf: (batch_shape, n, m) or None
    unc_ids: List[int]                  # leaves that travel uncompressed
    bucket_ranks: List[int]
    bits: int                           # analytic payload bits per worker
    lead: Tuple[int, ...] = ()
    bucket_model_sharded: Optional[List[bool]] = None  # per bucket: does it
    #   hold a leaf whose state is model-sharded or model-local (None: no
    #   partition was given)

    @classmethod
    def build(cls, deltas, state, specs, *, dtype=torch.float32,
              tolerance: float = 0.25, lead: Tuple[int, ...] = (),
              resample: Optional[Callable] = None,
              partition=None) -> "MatrixPayloads":
        """``resample(path, shape)`` replaces every warm-start factor with
        the fresh standard-normal draw it returns for that leaf (cold
        start).  ``partition``, a :class:`StatePartition` tree aligned with
        ``state``, fills ``bucket_model_sharded``."""
        leaves = collect_leaves(deltas, state, specs)
        relations = (None if partition is None
                     else partition_leaves(partition, leaves))
        nl = len(lead)
        mats, qs, plan_shapes, lshapes, unc_ids = [], [], [], [], []
        ranks = {}
        floats = 0
        for i, (path, g, q, spec) in enumerate(leaves):
            shape = tuple(g.shape[nl:])
            ms = matrixize.matrix_shape(shape, spec) if q is not None else None
            if ms is None:
                mats.append(None)
                qs.append(None)
                plan_shapes.append(None)
                lshapes.append(None)
                unc_ids.append(i)
                floats += matrixize.uncompressed_floats(shape)
                continue
            batch_shape, n, m = ms
            count = math.prod(batch_shape)
            r = q.shape[-1]
            ranks[i] = r
            mats.append(g.to(dtype).reshape(tuple(lead) + (count, n, m)))
            if resample is not None:
                q = resample(path, tuple(q.shape)).to(q.device)
            qs.append(q.to(dtype).reshape(count, m, r))
            plan_shapes.append((count, n, m))
            lshapes.append((batch_shape, n, m))
            floats += matrixize.compressed_floats(shape, spec, r)

        plan = matrixize.plan_buckets(plan_shapes, tolerance=tolerance)
        bucket_ranks = []
        for b in plan.buckets:
            rs = {ranks[e.index] for e in b.entries}
            if len(rs) != 1:
                raise ValueError(
                    "leaves sharing a shape bucket must share a rank (bucket "
                    f"({b.n}, {b.m}) has ranks {sorted(rs)})")
            bucket_ranks.append(rs.pop())
        bucket_ms = None
        if relations is not None:
            bucket_ms = [any(relations[e.index] not in (None, MODEL_REPLICATED)
                             for e in b.entries) for b in plan.buckets]
        return cls(
            deltas=deltas, leaves=leaves, plan=plan,
            m_bufs=[matrixize.pack_matrices(b, mats, lead=nl)
                    for b in plan.buckets],
            q_bufs=[matrixize.pack_factors(b, qs) for b in plan.buckets],
            lshapes=lshapes, unc_ids=unc_ids, bucket_ranks=bucket_ranks,
            bits=floats * 32, lead=tuple(lead), bucket_model_sharded=bucket_ms)

    @property
    def unc_values(self) -> List[torch.Tensor]:
        """The uncompressed leaves' per-worker tensors (they ride the first
        fused reduce)."""
        return [self.leaves[i][1] for i in self.unc_ids]

    def scatter(self, agg_bufs, recon_bufs, q_bufs, unc_agg,
                recon_lead: Tuple[int, ...] = ()):
        """Crop per-leaf blocks out of the slabs and emit the (agg, recon,
        state) trees.  ``agg_bufs`` and ``q_bufs`` are held once;
        ``recon_bufs`` carry ``recon_lead`` worker dims.  Uncompressed
        leaves reconstruct as themselves.  Crops of unpadded slabs are
        views."""
        unc_by_id = dict(zip(self.unc_ids, unc_agg))
        results = []
        for i, (_, g, q, spec) in enumerate(self.leaves):
            if self.lshapes[i] is None:
                results.append((unc_by_id[i], g, None))
                continue
            batch_shape, n, m = self.lshapes[i]
            b_id, entry = self.plan.entry_for(i)
            shape = tuple(g.shape[len(self.lead):])

            def crop(buf, lead):
                mat = matrixize.unpack_entry(buf, entry, n, m, lead=len(lead))
                return mat.reshape(tuple(lead) + shape).to(g.dtype)

            new_q = matrixize.unpack_entry(q_bufs[b_id], entry, m)
            new_q = new_q.reshape(batch_shape + (m, self.bucket_ranks[b_id]))
            results.append((crop(agg_bufs[b_id], ()),
                            crop(recon_bufs[b_id], recon_lead), new_q))
        return scatter_tree(self.deltas, results)


def run_step(comp, deltas, state, specs, ctx: MeshCtx = SINGLE,
             seed: Optional[int] = None, *, wire_dtype: str = "auto",
             max_chunk_bytes: Optional[int] = None) -> CompressOut:
    """One compress+aggregate step of a stateless single-round scheme
    through the fused transport (stateful PowerSGD runs its own phases).

    Encodes every leaf (``seed`` is the step's seed for shared-seed
    draws), fuses all payloads into one collective per wire chunk (reduce
    or gather by ``comp.wire_mode``), decodes and scatters back to the
    tree.  Leaves the scheme leaves uncompressed (``encode_leaf`` →
    ``None``) ride a fused all-reduce: for a gather scheme that is one
    reduce beside the payload gathers.  ``agg`` is held once; ``recon`` is
    the worker's own decode, with ``ctx.lead``, or the aggregate itself
    where ``comp.recon_is_agg``.
    """
    transport = Transport(ctx=ctx, wire_dtype=wire_dtype,
                          max_chunk_bytes=max_chunk_bytes)
    lead = ctx.lead
    leaves = collect_leaves(deltas, state, specs)

    encs, bits = [], 0
    for path, g, q, spec in leaves:
        enc = comp.encode_leaf(path, g, q, spec, lead, seed)
        encs.append(enc)
        bits += (matrixize.uncompressed_floats(tuple(g.shape[len(lead):])) * 32
                 if enc is None else enc.bits)
    unc_ids = [i for i, e in enumerate(encs) if e is None]
    enc_ids = [i for i, e in enumerate(encs) if e is not None]
    payload_parts, slices = [], {}
    for i in enc_ids:
        slices[i] = (len(payload_parts), len(payload_parts) + len(encs[i].payload))
        payload_parts.extend(encs[i].payload)

    def local_recon(i, agg):
        if comp.recon_is_agg:
            return agg
        return comp.decode_leaf(encs[i], encs[i].payload, lead)

    results: dict = {}
    if comp.wire_mode == "reduce":
        reduced = transport.reduce_mean(
            payload_parts + [leaves[i][1] for i in unc_ids])
        for i in enc_ids:
            lo, hi = slices[i]
            agg = comp.decode_leaf(encs[i], tuple(reduced[lo:hi]), ())
            results[i] = (agg, local_recon(i, agg), None)
        for j, i in enumerate(unc_ids):
            results[i] = (reduced[len(payload_parts) + j], leaves[i][1], None)
    else:
        unc_agg = transport.reduce_mean([leaves[i][1] for i in unc_ids])
        for j, i in enumerate(unc_ids):
            results[i] = (unc_agg[j], leaves[i][1], None)
        gathered = transport.gather(payload_parts)   # each: (W,) + shape
        weights = ctx.gather_data_weight()
        w = (ctx.data_size(),)
        for i in enc_ids:
            lo, hi = slices[i]
            decoded = comp.decode_leaf(encs[i], tuple(gathered[lo:hi]), w)
            agg = transport.combine_mean(decoded, weights)
            del decoded   # free the W decodes before the local one is built
            results[i] = (agg, local_recon(i, agg), None)

    agg, recon, _ = scatter_tree(deltas, [results[i] for i in range(len(leaves))])
    return CompressOut(agg=agg, recon=recon, state=None, bits_per_worker=bits)


def run_step_per_leaf(comp, deltas, state, specs, ctx: MeshCtx = SINGLE,
                      seed: Optional[int] = None) -> CompressOut:
    """The per-leaf reference path of a single-round scheme
    (``transport="per_leaf"``): one collective per payload array per leaf,
    no fusion and no wire cast.

    A reduce scheme mean-reduces each payload array and decodes the mean
    (a ``recon_is_agg`` scheme uses that as its reconstruction too).  A
    gather scheme mean-reduces the dense per-worker reconstruction: the
    numbers of the gather path's decode-then-average, on a dense all-reduce
    (the fused engine's all-gather is the honest wire pattern).
    Uncompressed leaves are mean-reduced as they are.  The fused
    :func:`run_step` matches this path bit for bit on a simulated mesh."""
    lead = ctx.lead
    bits, results = 0, []
    for path, g, q, spec in collect_leaves(deltas, state, specs):
        enc = comp.encode_leaf(path, g, q, spec, lead, seed)
        if enc is None:
            bits += matrixize.uncompressed_floats(tuple(g.shape[len(lead):])) * 32
            results.append((ctx.pmean_data(g), g, None))
            continue
        bits += enc.bits
        if comp.wire_mode == "reduce":
            agg = comp.decode_leaf(
                enc, tuple(ctx.pmean_data(a) for a in enc.payload), ())
            recon = (agg if comp.recon_is_agg
                     else comp.decode_leaf(enc, enc.payload, lead))
        else:
            recon = comp.decode_leaf(enc, enc.payload, lead)
            agg = ctx.pmean_data(recon)
        results.append((agg, recon, None))
    agg, recon, _ = scatter_tree(deltas, results)
    return CompressOut(agg=agg, recon=recon, state=None, bits_per_worker=bits)
