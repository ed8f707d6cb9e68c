"""Rank-r PowerSGD compression (paper Algorithm 1), bucketed engine (port of
``repro.core.powersgd``).

One warm-started subspace-iteration step per optimization step:

    P  ← M Q                 (lowrank_project kernel, per worker)
    P  ← all-reduce-mean(P)  (one fused collective for every bucket)
    P̂  ← orthogonalize(P)
    Q  ← Mᵀ P̂                (lowrank_backproject kernel, per worker)
    Q  ← all-reduce-mean(Q)  (one fused collective)
    Δ' ← P̂ Qᵀ                (decompress, once: P̂ and Q are worker-identical)

:class:`~repro_torch.core.engine.MatrixPayloads` stacks the tree's matrices
into shape-bucket slabs; the two products run as one kernel launch per
bucket, covering every simulated worker; uncompressed vector leaves ride the
first fused reduce.  Zero padding is exact.  The products go through
:mod:`repro_torch.kernels.ops`: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors.

Not ported yet: the per-leaf path (``bucketing="off"``, ROADMAP queue A,
item 7), rank schedules and residual tracking (item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.orthogonalize import get_orthogonalizer
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 2                          # rank of the initial factors
    orthogonalizer: str = "gram_schmidt"
    warm_start: bool = True                # §4.2
    num_iters: int = 1                     # >1 ⇒ Appendix G.7 best-approximation
    error_mode: str = "global"             # "global" | "local" (Alg. 2 literal)
    dtype: torch.dtype = torch.float32
    bucketing: str = "auto"                # "auto"/"on": the bucketed engine
    bucket_pad_tolerance: float = 0.25     # max relative padding waste per bucket
    wire_dtype: str = "auto"               # fused-collective wire policy
    max_chunk_bytes: Optional[int] = None  # cap per fused wire buffer
    track_residual: bool = False

    def __post_init__(self):
        if self.bucketing == "off":
            raise NotImplementedError(
                "bucketing='off' (the per-leaf path) is not ported yet "
                "(ROADMAP queue A, item 7)")
        if self.bucketing not in ("auto", "on"):
            raise ValueError(f"unknown bucketing mode {self.bucketing!r}")
        if self.track_residual:
            raise NotImplementedError(
                "track_residual is not ported yet (ROADMAP queue A, item 14)")
        if self.error_mode not in ("global", "local"):
            raise ValueError(f"unknown error_mode {self.error_mode!r}")
        if self.num_iters < 1:
            raise ValueError(f"num_iters must be ≥ 1, got {self.num_iters}")
        matrixize.check_wire_dtype(self.wire_dtype)
        get_orthogonalizer(self.orthogonalizer)


def init_state(cfg: PowerSGDConfig, shapes, specs,
               generator: Optional[torch.Generator] = None,
               device=None):
    """Q ∈ R^{m×r} per matrix leaf, i.i.d. standard normal (Alg. 1 line 1),
    drawn from ``generator`` in leaf order.  ``shapes`` is a tree of
    anything with ``.shape`` (tensors, meta tensors)."""
    def init_leaf(shape_leaf, spec):
        ms = matrixize.matrix_shape(tuple(shape_leaf.shape), spec)
        if ms is None:
            return None
        batch_shape, _, m = ms
        return torch.randn(batch_shape + (m, cfg.rank), generator=generator,
                           dtype=cfg.dtype, device=device)

    return tree.map(init_leaf, shapes, specs)


def compress_aggregate(cfg: PowerSGDConfig, deltas, state, specs,
                       ctx: MeshCtx = SINGLE,
                       generator: Optional[torch.Generator] = None
                       ) -> engine.CompressOut:
    """Batched power iteration over shape buckets, 2 collectives per iter.

    ``deltas`` carry ``ctx.lead`` worker dims; ``state`` (the Q factors) is
    worker-identical and held once.  ``generator`` is needed only without
    warm start (fresh factors every step).  Returns ``agg`` held once and,
    under ``error_mode="local"``, a per-worker ``recon``.
    """
    if not cfg.warm_start and generator is None:
        raise ValueError("warm_start=False draws fresh factors: pass a generator")
    orth = get_orthogonalizer(cfg.orthogonalizer)
    payloads = engine.MatrixPayloads.build(
        deltas, state, specs, dtype=cfg.dtype,
        tolerance=cfg.bucket_pad_tolerance, lead=ctx.lead,
        resample=None if cfg.warm_start else generator)
    transport = engine.Transport(ctx=ctx, wire_dtype=cfg.wire_dtype,
                                 max_chunk_bytes=cfg.max_chunk_bytes)
    m_bufs, q_bufs = payloads.m_bufs, payloads.q_bufs

    unc_agg = payloads.unc_values
    p_hats = q_locals = []
    for it in range(cfg.num_iters):
        p_locals = [ops.lowrank_project(mb, ctx.per_worker(qb))
                    for mb, qb in zip(m_bufs, q_bufs)]
        extra = unc_agg if it == 0 else []
        reduced = transport.reduce_mean(p_locals + extra)
        p_bufs = reduced[:len(p_locals)]
        if it == 0:
            unc_agg = reduced[len(p_locals):]
        p_hats = [orth(p) for p in p_bufs]
        q_locals = [ops.lowrank_backproject(mb, ctx.per_worker(ph))
                    for mb, ph in zip(m_bufs, p_hats)]
        q_bufs = transport.reduce_mean(q_locals)

    agg_bufs = [ref.decompress(ph, qb) for ph, qb in zip(p_hats, q_bufs)]
    if cfg.error_mode == "local":
        recon_bufs = [ref.decompress(ctx.per_worker(ph), ql)
                      for ph, ql in zip(p_hats, q_locals)]
        recon_lead = ctx.lead
    else:
        recon_bufs, recon_lead = agg_bufs, ()

    agg, recon, new_state = payloads.scatter(agg_bufs, recon_bufs, q_bufs,
                                             unc_agg, recon_lead=recon_lead)
    return engine.CompressOut(agg=agg, recon=recon, state=new_state,
                              bits_per_worker=payloads.bits)


def compressed_floats_total(shapes, specs, rank: int) -> int:
    """Analytic floats per step at a static rank (paper Tables 3/10/11)."""
    return sum(matrixize.compressed_floats(tuple(s.shape), spec, rank)
               for s, spec in zip(tree.leaves(shapes), tree.leaves(specs)))
