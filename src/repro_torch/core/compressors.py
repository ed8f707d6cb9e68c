"""Compressor interface and PowerSGD at a fixed rank (port of the parts of
``repro.core.compressors`` the training step uses).

    init(params, specs, generator)                 -> state
    step(deltas, state, specs, ctx, generator)     -> CompressOut

``CompressOut.agg`` is the aggregated decompressed update (mean over the
data axes) and ``CompressOut.recon`` the reconstruction error feedback
subtracts.  ``bits_per_worker`` counts the payload (r·(n+m) floats per
matrix, full size for uncompressed leaves) at 32 bits per float.

The rest of the zoo, rank schedules and the engine protocol wait (ROADMAP
queue A, items 9, 14 and 15).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize, powersgd
from repro_torch.core.dist import SINGLE, MeshCtx


class Compressor:
    """Base class; subclasses implement ``init`` and ``step``."""

    def __init__(self, wire_dtype: str = "auto",
                 max_chunk_bytes: Optional[int] = None):
        matrixize.check_wire_dtype(wire_dtype)
        self.wire_dtype = wire_dtype
        self.max_chunk_bytes = max_chunk_bytes

    def declared_budget(self) -> tuple:
        """``(total, reduce, gather)`` fused data-axis collectives per step."""
        return (1, 1, 0)

    def init(self, params, specs, generator: Optional[torch.Generator] = None):
        return None

    def step(self, deltas, state, specs, ctx: MeshCtx = SINGLE,
             generator: Optional[torch.Generator] = None) -> engine.CompressOut:
        raise NotImplementedError


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD (Alg. 1) on the bucketed engine: 2 fused all-reduces
    per power iteration, whatever the number of weight matrices."""

    def __init__(self, rank=2, orthogonalizer="gram_schmidt", warm_start=True,
                 num_iters=1, error_mode="global", bucket_pad_tolerance=0.25,
                 wire_dtype="auto", max_chunk_bytes=None):
        super().__init__(wire_dtype=wire_dtype, max_chunk_bytes=max_chunk_bytes)
        self.cfg = powersgd.PowerSGDConfig(
            rank=rank, orthogonalizer=orthogonalizer, warm_start=warm_start,
            num_iters=num_iters, error_mode=error_mode,
            bucket_pad_tolerance=bucket_pad_tolerance, wire_dtype=wire_dtype,
            max_chunk_bytes=max_chunk_bytes)

    def declared_budget(self) -> tuple:
        n = 2 * self.cfg.num_iters
        return (n, n, 0)

    def init(self, params, specs, generator=None):
        device = next((p.device for p in tree.leaves(params)), None)
        return powersgd.init_state(self.cfg, params, specs, generator,
                                   device=device)

    def step(self, deltas, state, specs, ctx=SINGLE, generator=None):
        return powersgd.compress_aggregate(self.cfg, deltas, state, specs,
                                           ctx, generator)

