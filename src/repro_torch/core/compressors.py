"""Compressor interface, PowerSGD at a fixed rank and the Top-K sparsifier
(port of the parts of ``repro.core.compressors`` the training steps use).

    init(params, specs, generator)                 -> state
    step(deltas, state, specs, ctx, generator)     -> CompressOut

``CompressOut.agg`` is the aggregated decompressed update (mean over the
data axes) and ``CompressOut.recon`` the reconstruction error feedback
subtracts.  ``bits_per_worker`` counts the payload each worker sends per
step (paper Tables 3/10/11): r·(n+m) floats per matrix for PowerSGD, a
32-bit value and a 32-bit index per selected coordinate for Top-K, full
size for uncompressed leaves, at 32 bits per float.

Stateless single-round schemes (Top-K) declare per leaf what travels
(``encode_leaf`` / ``decode_leaf``) and run through
:func:`repro_torch.core.engine.run_step`; ``wire_mode`` follows the
``allreduce`` flag: linear schemes all-reduce their payloads, the others
all-gather them.

Not ported yet: the rest of the zoo and the per-leaf reference transport
(ROADMAP queue A, item 15), rank schedules (item 14).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize, powersgd
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.engine import Encoded


class Compressor:
    """Base class; subclasses set ``allreduce`` and either override
    ``step`` (stateful schemes) or implement the engine protocol
    (``encode_leaf`` / ``decode_leaf``; error feedback subtracts the
    worker's own decode)."""

    allreduce: bool = True
    #: dtype census of one leaf's payload parts: ``"float"`` follows the
    #: gradient dtype, concrete names are integer side channels
    payload_dtypes: tuple = ("float",)

    def __init__(self, wire_dtype: str = "auto",
                 max_chunk_bytes: Optional[int] = None):
        matrixize.check_wire_dtype(wire_dtype)
        self.wire_dtype = wire_dtype
        self.max_chunk_bytes = max_chunk_bytes

    @property
    def wire_mode(self) -> str:
        return "reduce" if self.allreduce else "gather"

    def payload_wire_chunks(self) -> int:
        """Wire chunks :func:`matrixize.plan_flat` fuses the payload census
        into: one per integer dtype plus one for the float parts, or one in
        all when a float wire dtype casts every part."""
        if self.wire_dtype == "float32":
            return 1
        census = self.payload_dtypes
        return len({d for d in census if d != "float"}) + ("float" in census)

    def declared_budget(self) -> tuple:
        """``(total, reduce, gather)`` fused data-axis collectives per step on
        a gradient tree whose float leaves share one dtype."""
        if self.wire_mode == "reduce":
            return (1, 1, 0)
        n = self.payload_wire_chunks()
        return (1 + n, 1, n)

    def init(self, params, specs, generator: Optional[torch.Generator] = None):
        return None

    def step(self, deltas, state, specs, ctx: MeshCtx = SINGLE,
             generator: Optional[torch.Generator] = None) -> engine.CompressOut:
        return engine.run_step(self, deltas, state, specs, ctx,
                               wire_dtype=self.wire_dtype,
                               max_chunk_bytes=self.max_chunk_bytes)

    def encode_leaf(self, path, g, q, spec, lead) -> Optional[Encoded]:
        """What travels for one ``lead + shape`` leaf; ``None`` sends it
        uncompressed."""
        raise NotImplementedError

    def decode_leaf(self, enc: Encoded, payload, lead) -> torch.Tensor:
        """``lead + shape`` reconstruction from payloads carrying ``lead``."""
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


def _budget(shape, spec, rank) -> int:
    """Sparsifier budget b = (n+m)·r per matrix (paper Appendix G)."""
    batch_shape, n, m = matrixize.matrix_shape(shape, spec)
    return math.prod(batch_shape) * (n + m) * rank


class _FlatSparsifier(Compressor):
    """Compress each leaf as one flat vector per worker with budget
    b = (n+m)·r, the rank-equivalent of PowerSGD (paper Appendix G).
    Subclasses declare the payload (``_encode_flat`` / ``_decode_flat``)."""

    def __init__(self, rank=2, transport="fused", **kw):
        if transport != "fused":
            raise NotImplementedError(
                f"transport={transport!r} (the per-leaf reference path) is not "
                f"ported yet (ROADMAP queue A, item 15)")
        super().__init__(**kw)
        self.rank = rank

    def _encode_flat(self, flat, b):
        """``lead + (n,)`` → (payload tuple with the same leading dims, aux,
        bits per worker)."""
        raise NotImplementedError

    def _decode_flat(self, aux, payload, n):
        """→ ``leading + (n,)`` reconstruction, ``leading`` the payloads'."""
        raise NotImplementedError

    def encode_leaf(self, path, g, q, spec, lead):
        if not spec.is_compressed():
            return None
        shape = tuple(g.shape[len(lead):])
        b = min(_budget(shape, spec, self.rank), math.prod(shape))
        flat = g.reshape(tuple(lead) + (-1,))
        payload, aux, bits = self._encode_flat(flat, b)
        return Encoded(payload=payload, aux=(aux, shape), bits=bits)

    def decode_leaf(self, enc, payload, lead):
        aux, shape = enc.aux
        flat = self._decode_flat(aux, payload, math.prod(shape))
        return flat.reshape(tuple(lead) + shape)


class TopK(_FlatSparsifier):
    """Alg. 6: each worker's b largest-|.| coordinates.  Not linear, so the
    payloads are all-gathered.

    bits_per_worker: ``(32 + 32) · b``, a value and an int32 index per
    selected coordinate.  Selection is ``torch.topk`` over each worker's
    row, sorted by magnitude as ``lax.top_k`` is; among coordinates of equal
    magnitude it may pick others than the JAX package does.
    """

    allreduce = False
    payload_dtypes = ("float", "int32")

    def _encode_flat(self, flat, b):
        # one worker at a time: |Δ| and torch.topk's working buffers then
        # hold one row (2.1 GB for Llama-3-8B's embedding), not W rows
        rows = flat.reshape(-1, flat.shape[-1])
        idx = torch.stack([torch.topk(r.abs(), b, sorted=True).indices
                           for r in rows]).reshape(flat.shape[:-1] + (b,))
        return (flat.gather(-1, idx), idx.to(torch.int32)), None, b * (32 + 32)

    def _decode_flat(self, aux, payload, n):
        picked, idx = payload
        out = torch.zeros(picked.shape[:-1] + (n,), dtype=picked.dtype,
                          device=picked.device)
        return out.scatter_(-1, idx.long(), picked)


def make_compressor(name: str, rank: int = 2, **kw) -> Compressor:
    """The port's compressors by registry name."""
    registry = {"powersgd": PowerSGDCompressor, "top_k": TopK}
    if name not in registry:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP queue A, item "
            f"15); ported: {sorted(registry)}")
    return registry[name](rank=rank, **kw)
