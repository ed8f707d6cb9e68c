"""The compressed-collective transport engine, as far as PowerSGD's bucketed
step needs it (port of ``repro.core.engine``).

* :class:`Transport` — the fused all-reduce bound to a context and a wire
  policy.
* :class:`MatrixPayloads` — a tree's compressed leaves as zero-padded
  ``(B, n, m)`` bucket slabs, and the scatter of results back to the tree.

The generic single-round step (``run_step``) and the gather path wait for
the rest of the compressor zoo (ROADMAP queue A, items 6 and 15).
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
class Transport:
    """Fused data-axis transport bound to a context and a wire policy."""

    ctx: MeshCtx = SINGLE
    wire_dtype: str = "auto"
    max_chunk_bytes: Optional[int] = None

    def reduce_mean(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Fused all-reduce-mean (one collective per wire chunk)."""
        return self.ctx.pmean_flat(parts, wire_dtype=self.wire_dtype,
                                   max_chunk_bytes=self.max_chunk_bytes)


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
