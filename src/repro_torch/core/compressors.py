"""The compressor zoo the paper benchmarks against (port of
``repro.core.compressors``): the identity baseline, PowerSGD and its
ablations, Unbiased Rank-K, the sparsifiers (Random Block, Random K,
Sign+Norm, Top-K), Spectral Atomo and the exact rank-r oracle.

    init(params, specs, generator)             -> state
    step(deltas, state, specs, ctx, seed)      -> CompressOut

``CompressOut.agg`` is the aggregated decompressed update (mean over the
data axes) and ``CompressOut.recon`` the reconstruction error feedback
subtracts.  ``bits_per_worker`` counts the payload each worker sends per
step (paper Tables 3/10/11), at 32 bits per float: each scheme's docstring
gives its rule; uncompressed leaves count at full size, shared-seed draws
(Random Block's offset, Random K's indices, Unbiased Rank-K's U) count
nothing.

Single-round schemes declare per leaf what travels (``encode_leaf`` /
``decode_leaf``) and run through :func:`repro_torch.core.engine.run_step`
(``transport="fused"``, the default) or the per-leaf reference path
:func:`repro_torch.core.engine.run_step_per_leaf` (``transport="per_leaf"``);
PowerSGD has the same switch as ``bucketing="auto"|"off"``.  ``wire_mode``
follows the ``allreduce`` flag (linear schemes all-reduce their payloads,
the others all-gather them); the exact oracle reduces the dense gradient
and decodes after the mean.

``seed`` is the step's seed (:func:`repro_torch.core.engine.step_seed`).
Every shared-seed draw goes through :meth:`Compressor.draw`, which seeds a
fresh CPU generator from the seed and the leaf's path
(:func:`repro_torch.core.engine.leaf_generator`), so every worker draws the
same values on any device; a caller may override it to feed in other
draws.  torch cannot reproduce the JAX package's key draws, so the two
packages agree only when fed the same draws.

PowerSGD takes a rank schedule (``rank_schedule=``, see
:func:`repro_torch.core.powersgd.parse_schedule`), driven from the training
loop by :meth:`PowerSGDCompressor.controller`, and reports its residual
ratios under ``track_residual=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize, powersgd
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.engine import Encoded

TRANSPORTS = ("fused", "per_leaf")


class Compressor:
    """Base class; subclasses set ``allreduce`` and either override
    ``step`` (stateful schemes) or implement the engine protocol
    (``encode_leaf`` / ``decode_leaf``; error feedback subtracts the
    worker's own decode, or the aggregate where ``recon_is_agg``)."""

    name: str = "base"
    stateful: bool = False   # carries per-matrix state (warm-start Q)
    allreduce: bool = True
    recon_is_agg: bool = False
    #: dtype census of one leaf's payload parts: ``"float"`` follows the
    #: gradient dtype, concrete names are integer side channels
    payload_dtypes: tuple = ("float",)

    def __init__(self, transport: str = "fused", wire_dtype: str = "auto",
                 max_chunk_bytes: Optional[int] = None):
        if transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {transport!r}; use one of {TRANSPORTS}")
        matrixize.check_wire_dtype(wire_dtype)
        self.transport = transport
        self.wire_dtype = wire_dtype
        self.max_chunk_bytes = max_chunk_bytes

    @property
    def wire_mode(self) -> str:
        return "reduce" if self.allreduce else "gather"

    def payload_wire_chunks(self) -> int:
        """Wire chunks :func:`matrixize.plan_flat` fuses the payload census
        into: one per integer dtype plus one for the float parts, under
        every wire dtype (integer parts are never cast; see
        :func:`matrixize.plan_flat` for this divergence from the JAX
        package)."""
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

    def state_partition(self, param_pspecs, mspecs):
        """Per-leaf :class:`~repro_torch.core.engine.StatePartition` tree of
        this compressor's state (shaped like :meth:`init`'s), from the
        parameters' specs; ``None`` for a stateless compressor."""
        return None

    def step(self, deltas, state, specs, ctx: MeshCtx = SINGLE,
             seed: Optional[int] = None) -> engine.CompressOut:
        if self.transport == "per_leaf":
            return engine.run_step_per_leaf(self, deltas, state, specs, ctx,
                                            seed)
        return engine.run_step(self, deltas, state, specs, ctx, seed,
                               wire_dtype=self.wire_dtype,
                               max_chunk_bytes=self.max_chunk_bytes)

    def draw(self, kind: str, path, seed: Optional[int], **kw) -> torch.Tensor:
        """A shared-seed draw for the leaf at ``path``, on the CPU, from a
        fresh generator seeded by ``(seed, path)``:

        * ``"normal"`` (``shape``): standard normal float32;
        * ``"uniform"`` (``shape``): uniform float32 on [0, 1);
        * ``"start"`` (``high``): one int64 in [0, high);
        * ``"choice"`` (``n``, ``b``): b distinct int64 indices of
          ``range(n)`` in draw order, uniform without replacement.
        """
        if seed is None:
            raise ValueError(f"{self.name} makes shared-seed draws: pass the "
                             f"step's seed")
        gen = engine.leaf_generator(seed, path)
        if kind == "normal":
            return torch.randn(kw["shape"], generator=gen)
        if kind == "uniform":
            return torch.rand(kw["shape"], generator=gen)
        if kind == "start":
            return torch.randint(kw["high"], (), generator=gen)
        if kind == "choice":
            return _choice(gen, kw["n"], kw["b"])
        raise ValueError(f"unknown draw kind {kind!r}")

    def encode_leaf(self, path, g, q, spec, lead, seed) -> Optional[Encoded]:
        """What travels for one ``lead + shape`` leaf; ``None`` sends it
        uncompressed."""
        raise NotImplementedError

    def decode_leaf(self, enc: Encoded, payload, lead) -> torch.Tensor:
        """``lead + shape`` reconstruction from payloads carrying ``lead``."""
        raise NotImplementedError


def _choice(gen: torch.Generator, n: int, b: int) -> torch.Tensor:
    """b distinct indices of ``range(n)``, uniform without replacement.
    Where b is a small share of n (the embedding of Llama-3-8B: 264,704 of
    525 M), draw with replacement and keep each value's first occurrence
    until b are distinct, which costs O(b log b) instead of a permutation
    of n."""
    if 2 * b > n:
        return torch.randperm(n, generator=gen)[:b]
    picked = torch.empty(0, dtype=torch.long)
    while picked.numel() < b:
        cand = torch.cat([picked, torch.randint(
            n, (2 * (b - picked.numel()) + 16,), generator=gen)])
        uniq, inv = torch.unique(cand, return_inverse=True)
        first = torch.full((uniq.numel(),), cand.numel()).scatter_reduce_(
            0, inv, torch.arange(cand.numel()), "amin")
        picked = cand[first.sort().values]
    return picked[:b]


class IdentityCompressor(Compressor):
    """Full-precision baseline: the SGD data path every compressor is
    compared against.

    bits_per_worker: ``32 · numel`` for every leaf (nothing is
    compressed).  Every leaf is its own payload, so the fused engine
    reduces the whole gradient in one flat collective per step: budget
    (1, 1, 0); ``transport="per_leaf"`` reduces one leaf at a time.
    """

    name = "identity"
    allreduce = True

    def encode_leaf(self, path, g, q, spec, lead, seed):
        shape = tuple(g.shape[len(lead):])
        return Encoded(payload=(g,),
                       bits=matrixize.uncompressed_floats(shape) * 32)

    def decode_leaf(self, enc, payload, lead):
        return payload[0]


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD (Alg. 1).  ``bucketing="auto"`` runs the bucketed
    engine, 2 fused all-reduces per power iteration whatever the number of
    weight matrices; ``bucketing="off"`` the per-leaf reference path, 2
    per matrix leaf and iteration.  ``warm_start=False`` draws every
    leaf's Q afresh each step (``draw("normal", ...)``, the same draw on
    both paths).

    bits_per_worker: ``32 · r · (n + m)`` per weight matrix (the P and Q
    factors) plus ``32 · numel`` per uncompressed leaf, at each factor's
    rank; bucket padding is not payload.

    ``rank_schedule`` (any form :func:`powersgd.parse_schedule` takes) sets
    the initial rank to the schedule's, and a residual schedule turns
    ``track_residual`` on; :meth:`controller` drives it between steps.
    ``pipeline=True`` runs the bucketed engine's reduces on
    :class:`~repro_torch.core.engine.PipelinedTransport` (bit for bit the
    same; the per-leaf path ignores it)."""

    name = "powersgd"
    stateful = True

    def __init__(self, rank=2, orthogonalizer="gram_schmidt", warm_start=True,
                 num_iters=1, error_mode="global", bucketing="auto",
                 bucket_pad_tolerance=0.25, wire_dtype="auto",
                 max_chunk_bytes=None, rank_schedule=None,
                 track_residual=False, pipeline=False):
        super().__init__(
            transport="per_leaf" if bucketing == "off" else "fused",
            wire_dtype=wire_dtype, max_chunk_bytes=max_chunk_bytes)
        self.rank_schedule = (None if rank_schedule is None
                              else powersgd.parse_schedule(rank_schedule))
        if self.rank_schedule is not None:
            rank = self.rank_schedule.initial_rank()
            track_residual = track_residual or self.rank_schedule.needs_residual
        self.cfg = powersgd.PowerSGDConfig(
            rank=rank, orthogonalizer=orthogonalizer, warm_start=warm_start,
            num_iters=num_iters, error_mode=error_mode, bucketing=bucketing,
            bucket_pad_tolerance=bucket_pad_tolerance, wire_dtype=wire_dtype,
            max_chunk_bytes=max_chunk_bytes, track_residual=track_residual,
            pipeline=pipeline)
        if num_iters > 1:
            self.name = f"powersgd_best_approx_{num_iters}it"
        elif not warm_start:
            self.name = "powersgd_cold"

    def declared_budget(self) -> tuple:
        n = 2 * self.cfg.num_iters
        return (n, n, 0)

    def controller(self, seed=None) -> "powersgd.RankController":
        """A fresh host-side controller of this compressor's rank schedule
        (:class:`FixedRank` at ``cfg.rank`` without one)."""
        schedule = self.rank_schedule or powersgd.FixedRank(self.cfg.rank)
        return powersgd.RankController(schedule, seed)

    def init(self, params, specs, generator=None):
        device = next((p.device for p in tree.leaves(params)), None)
        return powersgd.init_state(self.cfg, params, specs, generator,
                                   device=device)

    def state_partition(self, param_pspecs, mspecs):
        """The Q factors' partition (:func:`powersgd.factor_partition`): a
        row-parallel weight's Q is model-LOCAL."""
        return powersgd.state_partition(param_pspecs, mspecs)

    def bind_state_partition(self, partition):
        """Hand ``partition`` (a :meth:`state_partition` tree) to every later
        :meth:`step`'s bucketed engine; returns it."""
        self._state_partition = partition
        return partition

    def step(self, deltas, state, specs, ctx=SINGLE, seed=None):
        draw = None
        if not self.cfg.warm_start:
            def draw(path, shape):
                return self.draw("normal", path, seed, shape=shape)
        return powersgd.compress_aggregate(
            self.cfg, deltas, state, specs, ctx, draw,
            partition=getattr(self, "_state_partition", None))


def _matrices(g, spec, lead):
    """``lead + batch + (n, m)`` matrices of a leaf, and ``(batch_shape, n,
    m)``; ``None`` for an uncompressed leaf."""
    ms = matrixize.matrix_shape(tuple(g.shape[len(lead):]), spec)
    if ms is None:
        return None
    batch_shape, n, m = ms
    return g.reshape(tuple(lead) + batch_shape + (n, m)), ms


class UnbiasedRankK(Compressor):
    """§4.1: a shared-seed U (m × r, entries N(0, 1/r), so E[UUᵀ] = I), one
    U for every matrix of the leaf and every worker; sends M U and decodes
    (M U) Uᵀ.  Linear, so the payloads are all-reduced.

    bits_per_worker: ``32 · n · r`` per matrix (only M U travels).
    """

    name = "unbiased_rank_k"
    allreduce = True

    def __init__(self, rank=2, **kw):
        super().__init__(**kw)
        self.rank = rank

    def encode_leaf(self, path, g, q, spec, lead, seed):
        found = _matrices(g, spec, lead)
        if found is None:
            return None
        mat, (batch_shape, n, m) = found
        u = self.draw("normal", path, seed, shape=(m, self.rank))
        u = u.to(device=g.device, dtype=g.dtype) / math.sqrt(self.rank)
        return Encoded(payload=(mat @ u,),
                       aux=(u, tuple(g.shape[len(lead):])),
                       bits=math.prod(batch_shape) * n * self.rank * 32)

    def decode_leaf(self, enc, payload, lead):
        u, shape = enc.aux
        return (payload[0] @ u.T).reshape(tuple(lead) + shape)


def _budget(shape, spec, rank) -> int:
    """Sparsifier budget b = (n+m)·r per matrix (paper Appendix G)."""
    batch_shape, n, m = matrixize.matrix_shape(shape, spec)
    return math.prod(batch_shape) * (n + m) * rank


class _FlatSparsifier(Compressor):
    """Compress each leaf as one flat vector per worker with budget
    b = (n+m)·r, the rank-equivalent of PowerSGD (paper Appendix G).
    Subclasses declare the payload (``_encode_flat`` / ``_decode_flat``)."""

    def __init__(self, rank=2, **kw):
        super().__init__(**kw)
        self.rank = rank

    def _encode_flat(self, flat, b, path, seed):
        """``lead + (n,)`` → (payload tuple with the same leading dims, aux,
        bits per worker)."""
        raise NotImplementedError

    def _decode_flat(self, aux, payload, n):
        """→ ``leading + (n,)`` reconstruction, ``leading`` the payloads'."""
        raise NotImplementedError

    def encode_leaf(self, path, g, q, spec, lead, seed):
        if not spec.is_compressed():
            return None
        shape = tuple(g.shape[len(lead):])
        b = min(_budget(shape, spec, self.rank), math.prod(shape))
        flat = g.reshape(tuple(lead) + (-1,))
        payload, aux, bits = self._encode_flat(flat, b, path, seed)
        return Encoded(payload=payload, aux=(aux, shape), bits=bits)

    def decode_leaf(self, enc, payload, lead):
        aux, shape = enc.aux
        flat = self._decode_flat(aux, payload, math.prod(shape))
        return flat.reshape(tuple(lead) + shape)


class RandomBlock(_FlatSparsifier):
    """Alg. 3: a contiguous block of b coordinates at a shared-seed offset
    in [0, max(n − b, 1)).  Linear, so the payloads are all-reduced.

    bits_per_worker: ``32 · b`` (the offset comes from the shared seed).
    """

    name = "random_block"
    allreduce = True

    def _encode_flat(self, flat, b, path, seed):
        n = flat.shape[-1]
        start = int(self.draw("start", path, seed, high=max(n - b, 1)))
        return (flat[..., start:start + b],), start, b * 32

    def _decode_flat(self, aux, payload, n):
        block = payload[0]
        out = block.new_zeros(block.shape[:-1] + (n,))
        out[..., aux:aux + block.shape[-1]] = block
        return out


class RandomK(_FlatSparsifier):
    """Alg. 4: b shared-seed coordinates drawn without replacement.  Linear,
    so the payloads are all-reduced; the decode writes each value at its
    index (the indices are distinct).

    bits_per_worker: ``32 · b`` (the indices come from the shared seed).
    """

    name = "random_k"
    allreduce = True

    def _encode_flat(self, flat, b, path, seed):
        idx = self.draw("choice", path, seed, n=flat.shape[-1], b=b)
        idx = idx.to(flat.device)
        return (flat.index_select(-1, idx),), idx, b * 32

    def _decode_flat(self, aux, payload, n):
        picked = payload[0]
        out = picked.new_zeros(picked.shape[:-1] + (n,))
        return out.index_copy_(-1, aux, picked)


class SignNorm(_FlatSparsifier):
    """Alg. 5: sign(M)·‖M‖₁/nm.  Not linear, so the payloads are
    all-gathered: int8 signs (``sign(0) = 0``) and one float norm,
    ``mean(|x|)``, per worker and leaf.

    bits_per_worker: ``1 · numel + 32`` per leaf (a sign bit per coordinate
    and the norm).  On the wire the signs travel as an int8 chunk.
    """

    name = "sign_norm"
    allreduce = False
    payload_dtypes = ("int8", "float")

    def _encode_flat(self, flat, b, path, seed):
        scale = flat.abs().mean(dim=-1, keepdim=True)
        signs = torch.sign(flat).to(torch.int8)
        return (signs, scale), flat.dtype, flat.shape[-1] + 32

    def _decode_flat(self, aux, payload, n):
        signs, scale = payload
        return signs.to(aux) * scale.to(aux)


class TopK(_FlatSparsifier):
    """Alg. 6: each worker's b largest-|.| coordinates.  Not linear, so the
    payloads are all-gathered.

    bits_per_worker: ``(32 + 32) · b``, a value and an int32 index per
    selected coordinate.  Selection is ``torch.topk`` over each worker's
    row, sorted by magnitude as ``lax.top_k`` is; among coordinates of equal
    magnitude it may pick others than the JAX package does.
    """

    name = "top_k"
    allreduce = False
    payload_dtypes = ("float", "int32")

    def _encode_flat(self, flat, b, path, seed):
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


class SpectralAtomo(Compressor):
    """Atomo on the singular values (Wang et al., 2018; Appendix G.6):
    each matrix's SVD, r components importance-sampled with water-filling
    probabilities, sent as the triplets ``P = U_S diag(s_S / p_S)`` and
    ``V_S`` and decoded as ``P Vᵀ``.  Unbiased and not linear, so the
    payloads are all-gathered.

    Sampling follows the JAX package: ``attempts`` rounds of Bernoulli
    draws (``draw("uniform", ...)``, separate for each matrix of the leaf,
    shared by the workers); the first round that selects exactly r
    components wins, else the top r.  The selected components are taken in
    index order by a stable sort of the selection mask (a fixed-size
    selection, no host sync); when fewer than r exist (min(n, m) < r) the
    fill slots get weight 0.  The SVD is ``torch.linalg.svd``; singular
    vectors have arbitrary signs, so P and V may differ from the JAX
    package's by a sign per column, while ``P Vᵀ`` does not.

    bits_per_worker: ``32 · r · (n + m)`` per matrix.
    """

    name = "spectral_atomo"
    allreduce = False

    def __init__(self, rank=2, attempts=8, **kw):
        super().__init__(**kw)
        self.rank = rank
        self.attempts = attempts

    def _probs(self, s):
        """Water-filling p_i = min(1, s_i/τ) with Σ p_i = r (12 fixed-point
        iterations), over the last dim."""
        r = self.rank
        p = torch.clamp(s * r / (s.sum(-1, keepdim=True) + 1e-12), max=1.0)
        for _ in range(12):
            clipped = p >= 1.0
            mass = r - clipped.to(s.dtype).sum(-1, keepdim=True)
            rest = torch.where(clipped, 0.0, s).sum(-1, keepdim=True)
            p = torch.where(clipped, 1.0,
                            s * torch.clamp(mass, min=0.0) / (rest + 1e-12))
            p = torch.clamp(p, max=1.0)
        return p

    def encode_leaf(self, path, g, q, spec, lead, seed):
        found = _matrices(g, spec, lead)
        if found is None:
            return None
        mat, (batch_shape, n, m) = found
        count, k, r = math.prod(batch_shape), min(n, m), self.rank
        mat = mat.reshape(tuple(lead) + (count, n, m))
        u, s, vt = torch.linalg.svd(mat, full_matrices=False)
        p = self._probs(s)                                   # lead + (count, k)
        draws = self.draw("uniform", path, seed,
                          shape=(count, self.attempts, k)).to(s.device)
        sels = draws < p.unsqueeze(-2)                       # (…, attempts, k)
        ok = sels.sum(-1) == r
        first = ok.to(torch.int8).argmax(-1)                 # first round with r
        sel = sels.gather(-2, first[..., None, None].expand(
            first.shape + (1, k))).squeeze(-2)
        sel = torch.where(ok.any(-1, keepdim=True), sel,
                          torch.arange(k, device=s.device) < r)
        w = torch.where(sel, s / torch.clamp(p, min=1e-12), 0.0)
        idx = torch.sort((~sel).to(torch.int8), dim=-1, stable=True).indices
        idx = torch.nn.functional.pad(idx[..., :r], (0, max(r - k, 0)))
        valid = torch.arange(r, device=s.device) < sel.sum(-1, keepdim=True)
        wsel = torch.where(valid, w.gather(-1, idx), 0.0)
        pfac = u.gather(-1, idx.unsqueeze(-2).expand(idx.shape[:-1] + (n, r)))
        pfac = pfac * wsel.unsqueeze(-2)                     # (…, n, r)
        vfac = vt.gather(-2, idx.unsqueeze(-1).expand(idx.shape + (m,)))
        vfac = vfac.transpose(-1, -2).contiguous()           # (…, m, r)
        return Encoded(payload=(pfac, vfac),
                       aux=tuple(g.shape[len(lead):]),
                       bits=count * r * (n + m) * 32)

    def decode_leaf(self, enc, payload, lead):
        pfac, vfac = payload
        return (pfac @ vfac.transpose(-1, -2)).reshape(tuple(lead) + enc.aux)


class ExactRankK(Compressor):
    """The best rank-r approximation, by SVD of the *aggregated* gradient:
    the dense gradient is all-reduced (``wire_mode`` "reduce", although the
    scheme is not linear) and truncated after the mean; the
    reconstruction is the aggregate (``recon_is_agg``).  An oracle, not a
    communicable scheme.

    bits_per_worker: ``32 · r · (n + m)`` per matrix (nominal).
    """

    name = "exact_rank_k"
    allreduce = False
    recon_is_agg = True

    def __init__(self, rank=2, **kw):
        super().__init__(**kw)
        self.rank = rank

    @property
    def wire_mode(self) -> str:
        return "reduce"

    def encode_leaf(self, path, g, q, spec, lead, seed):
        found = _matrices(g, spec, lead)
        if found is None:
            return None
        _, (batch_shape, n, m) = found
        return Encoded(payload=(g,), aux=(tuple(g.shape[len(lead):]), spec),
                       bits=math.prod(batch_shape) * self.rank * (n + m) * 32)

    def decode_leaf(self, enc, payload, lead):
        shape, spec = enc.aux
        _, n, m = matrixize.matrix_shape(shape, spec)
        mat = payload[0].reshape(tuple(lead) + (-1, n, m))
        u, s, vt = torch.linalg.svd(mat, full_matrices=False)
        s = torch.where(torch.arange(s.shape[-1], device=s.device) < self.rank,
                        s, 0.0)
        return ((u * s.unsqueeze(-2)) @ vt).reshape(tuple(lead) + shape)


def make_compressor(name: str, rank: int = 2, **kw) -> Compressor:
    """The zoo by registry name (the JAX package's twelve names)."""
    registry = {
        "identity": lambda: IdentityCompressor(**kw),
        "powersgd": lambda: PowerSGDCompressor(rank=rank, **kw),
        "powersgd_cold": lambda: PowerSGDCompressor(rank=rank,
                                                    warm_start=False, **kw),
        "powersgd_best_approx": lambda: PowerSGDCompressor(
            rank=rank, warm_start=False, num_iters=4, **kw),
        "powersgd_per_leaf": lambda: PowerSGDCompressor(
            rank=rank, bucketing="off", **kw),
        "unbiased_rank_k": lambda: UnbiasedRankK(rank=rank, **kw),
        "random_block": lambda: RandomBlock(rank=rank, **kw),
        "random_k": lambda: RandomK(rank=rank, **kw),
        "sign_norm": lambda: SignNorm(rank=rank, **kw),
        "top_k": lambda: TopK(rank=rank, **kw),
        "spectral_atomo": lambda: SpectralAtomo(rank=rank, **kw),
        "exact_rank_k": lambda: ExactRankK(rank=rank, **kw),
    }
    if name not in registry:
        raise ValueError(f"unknown compressor {name!r}; available: "
                         f"{sorted(registry)}")
    return registry[name]()
