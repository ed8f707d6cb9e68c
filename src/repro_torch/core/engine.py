"""The compressed-collective transport engine (port of
``repro.core.engine``).

* :class:`Transport` — the fused all-reduce and all-gather bound to a
  context and a wire policy, and the receiver-side mean over gathered
  decodes.
* :class:`MatrixPayloads` — a tree's compressed leaves as zero-padded
  ``(B, n, m)`` bucket slabs, and the scatter of results back to the tree.
* :func:`run_step` — the generic step of single-round schemes (Top-K).
  A compressor declares per leaf what travels (``encode_leaf`` →
  :class:`Encoded`) and how to rebuild a leaf from a payload
  (``decode_leaf``); ``wire_mode`` says how it travels: ``"reduce"``
  all-reduces the fused payloads and decodes once, ``"gather"`` all-gathers
  them, decodes every worker's payload and averages the W decodes.
  Uncompressed leaves ride one fused all-reduce.

Under a simulated data-parallel context the per-worker tensors carry the
worker dims ``ctx.lead``: ``encode_leaf(path, g, q, spec, lead)`` gets a
``lead + shape`` delta and returns payloads with the same leading dims,
and ``decode_leaf(enc, payload, lead)`` rebuilds ``lead + shape`` from
payloads that carry ``lead`` (the worker's own payload, or the gathered
``(W,)`` stack).  Under a ``torch.distributed`` context ``lead`` is ``()``.

Not ported yet: ``StatePartition`` (ROADMAP queue A, item 14),
``PipelinedTransport`` (item 12), weighted combines (item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.core import matrixize
from repro_torch.core.dist import SINGLE, MeshCtx


@dataclasses.dataclass
class CompressOut:
    """What one compress+aggregate step hands back to error feedback."""

    agg: Any              # tree: aggregated update, worker-identical, held once
    recon: Any            # tree: reconstruction used for the error update
    state: Any            # tree: new compressor state (warm-start Q)
    bits_per_worker: int  # payload bits sent per step per worker


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

    def reduce_mean(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Fused all-reduce-mean (one collective per wire chunk)."""
        return self.ctx.pmean_flat(parts, wire_dtype=self.wire_dtype,
                                   max_chunk_bytes=self.max_chunk_bytes)

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Fused all-gather (one collective per wire chunk); every part comes
        back with a leading worker dim of ``ctx.data_size()``."""
        return self.ctx.allgather_flat(parts, wire_dtype=self.wire_dtype,
                                       max_chunk_bytes=self.max_chunk_bytes)

    @staticmethod
    def combine_mean(stacked: torch.Tensor,
                     weights: Optional[torch.Tensor]) -> torch.Tensor:
        """Average W per-worker decodes over the leading gathered dim."""
        if weights is not None:
            raise NotImplementedError(
                "weighted gather combines are not ported yet (ROADMAP queue "
                "A, item 6)")
        return stacked.mean(dim=0)


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

    @classmethod
    def build(cls, deltas, state, specs, *, dtype=torch.float32,
              tolerance: float = 0.25, lead: Tuple[int, ...] = (),
              resample: Optional[torch.Generator] = None) -> "MatrixPayloads":
        """``resample`` replaces every warm-start factor with a fresh
        standard-normal draw from that generator (cold start), in leaf
        order."""
        leaves = collect_leaves(deltas, state, specs)
        nl = len(lead)
        mats, qs, plan_shapes, lshapes, unc_ids = [], [], [], [], []
        ranks = {}
        floats = 0
        for i, (_, g, q, spec) in enumerate(leaves):
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
                q = torch.randn(q.shape, generator=resample, dtype=dtype,
                                device=q.device)
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
        return cls(
            deltas=deltas, leaves=leaves, plan=plan,
            m_bufs=[matrixize.pack_matrices(b, mats, lead=nl)
                    for b in plan.buckets],
            q_bufs=[matrixize.pack_factors(b, qs) for b in plan.buckets],
            lshapes=lshapes, unc_ids=unc_ids, bucket_ranks=bucket_ranks,
            bits=floats * 32, lead=tuple(lead))

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


def run_step(comp, deltas, state, specs, ctx: MeshCtx = SINGLE, *,
             wire_dtype: str = "auto",
             max_chunk_bytes: Optional[int] = None) -> CompressOut:
    """One compress+aggregate step of a stateless single-round scheme
    through the fused transport (stateful PowerSGD runs its own phases).

    Encodes every leaf, fuses all payloads into one collective per wire
    chunk (reduce or gather by ``comp.wire_mode``), decodes and scatters
    back to the tree.  Leaves the scheme leaves uncompressed
    (``encode_leaf`` → ``None``) ride a fused all-reduce: for a gather
    scheme that is one reduce beside the payload gathers.  ``agg`` is held
    once; ``recon`` (the worker's own decode) carries ``ctx.lead``.
    """
    transport = Transport(ctx=ctx, wire_dtype=wire_dtype,
                          max_chunk_bytes=max_chunk_bytes)
    lead = ctx.lead
    leaves = collect_leaves(deltas, state, specs)

    encs, bits = [], 0
    for path, g, q, spec in leaves:
        enc = comp.encode_leaf(path, g, q, spec, lead)
        encs.append(enc)
        bits += (matrixize.uncompressed_floats(tuple(g.shape[len(lead):])) * 32
                 if enc is None else enc.bits)
    unc_ids = [i for i, e in enumerate(encs) if e is None]
    enc_ids = [i for i, e in enumerate(encs) if e is not None]
    payload_parts, slices = [], {}
    for i in enc_ids:
        slices[i] = (len(payload_parts), len(payload_parts) + len(encs[i].payload))
        payload_parts.extend(encs[i].payload)

    def local_recon(i):
        return comp.decode_leaf(encs[i], encs[i].payload, lead)

    results: dict = {}
    if comp.wire_mode == "reduce":
        reduced = transport.reduce_mean(
            payload_parts + [leaves[i][1] for i in unc_ids])
        for i in enc_ids:
            lo, hi = slices[i]
            agg = comp.decode_leaf(encs[i], tuple(reduced[lo:hi]), ())
            results[i] = (agg, local_recon(i), None)
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
            results[i] = (agg, local_recon(i), None)

    agg, recon, _ = scatter_tree(deltas, [results[i] for i in range(len(leaves))])
    return CompressOut(agg=agg, recon=recon, state=None, bits_per_worker=bits)
