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
first fused reduce.  Zero padding is exact.  ``bucketing="off"`` is the
per-leaf reference path: the same math leaf by leaf, one kernel launch of
each product and two collectives per matrix leaf and power iteration, one
collective per vector leaf.  The products go through
:mod:`repro_torch.kernels.ops`: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors.

Adaptive rank.  A leaf's rank is its factor's last dim, read off the state
each step, so a rank switch is a change of the state between steps, made
on the host:

* :class:`RankSchedule` is the policy: :class:`FixedRank`,
  :class:`StaircaseRank` (a rank per step milestone) and
  :class:`ResidualEnergyRank` (driven by the measured residual
  ‖M − P̂Qᵀ‖_F / ‖M‖_F, tracked under ``cfg.track_residual``);
  :func:`parse_schedule` takes the spec strings of ``TrainHyper``.
* :func:`transition_factor` / :func:`transition_state` keep the warm start:
  a decrease keeps the leading columns bit for bit, an increase keeps every
  column and appends fresh standard-normal columns.  Error buffers and
  momentum are full-shape trees that a switch does not touch.
* :class:`RankController` drives a schedule from the training loop.  It
  draws the fresh columns of each switch from its base seed, on the CPU,
  per leaf path (the shared-seed manner of
  :func:`repro_torch.core.engine.leaf_generator`), so every worker and
  every device draws the same columns.  torch cannot make the JAX
  package's key draws: the two packages' growths agree only when fed the
  same columns (:meth:`RankController.draw`).

Under a model axis each rank compresses its local shards with data-axis
collectives only.  :func:`factor_partition` / :func:`state_partition`
classify each Q factor against the model axis: a column-parallel weight's
Q is model-sharded on its m dim, a row-parallel weight's is model-LOCAL
(``Q = Mᵀ P̂`` from the rank's own n-rows, behind a replicated-shaped
spec).

Residual tracking is per worker: each worker's ratio comes from its own M,
as under the reference's ``vmap``, formed one worker's slab at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core import engine, matrixize
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.orthogonalize import get_orthogonalizer
from repro_torch.kernels import ops, ref
from repro_torch.sharding import P, mentions as _mentions

StatePartition = engine.StatePartition
MODEL_REPLICATED = engine.MODEL_REPLICATED
MODEL_SHARDED = engine.MODEL_SHARDED
MODEL_LOCAL = engine.MODEL_LOCAL


def factor_partition(param_spec, mspec, model_axis: str = "model"):
    """:class:`~repro_torch.core.engine.StatePartition` of one Q factor
    (``None`` for an uncompressed leaf).  Q has shape ``batch_shape + (m,
    r)``: batch dims keep the parameter's entries, the m dim carries the
    model axis iff one of the parameter's trailing (m) dims does.  Where
    the n dim is model-sharded (row-parallel weights: the embedding, the
    attention out projection, the MLP down projection), each rank's Q is
    computed from its own n-rows, so the leaf is model-LOCAL though no dim
    carries the axis."""
    if not mspec.is_compressed():
        return None
    b = mspec.batch_dims
    entries = tuple(param_spec) + (None,) * 16
    n_sharded = _mentions(entries[b], model_axis)
    m_sharded = any(_mentions(e, model_axis) for e in entries[b + 1:b + 16])
    if n_sharded and m_sharded:
        raise ValueError(
            "a weight matrixized with both n and m dims model-sharded has no "
            f"single-axis TP layout: {param_spec} with {mspec}")
    spec = P(*(entries[:b] + (model_axis if m_sharded else None, None)))
    if n_sharded:
        model = MODEL_LOCAL
    elif m_sharded or any(_mentions(e, model_axis) for e in entries[:b]):
        model = MODEL_SHARDED
    else:
        model = MODEL_REPLICATED
    return StatePartition(spec=spec, model=model)


def state_partition(param_pspecs, mspecs, model_axis: str = "model"):
    """Tree of :func:`factor_partition` records shaped like the state
    :func:`init_state` builds (``None`` at uncompressed leaves)."""
    return tree.map(lambda s, ms: factor_partition(s, ms, model_axis),
                    param_pspecs, mspecs)


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 2                          # rank of the initial factors
    orthogonalizer: str = "gram_schmidt"
    warm_start: bool = True                # §4.2
    num_iters: int = 1                     # >1 ⇒ Appendix G.7 best-approximation
    error_mode: str = "global"             # "global" | "local" (Alg. 2 literal)
    dtype: torch.dtype = torch.float32
    bucketing: str = "auto"                # "auto"/"on": bucketed, "off": per leaf
    bucket_pad_tolerance: float = 0.25     # max relative padding waste per bucket
    wire_dtype: str = "auto"               # fused-collective wire policy
    max_chunk_bytes: Optional[int] = None  # cap per fused wire buffer
    track_residual: bool = False           # CompressOut.metrics: ‖M − P̂Qᵀ‖/‖M‖
    pipeline: bool = False                 # engine.PipelinedTransport: issue
    #                                        chunk b's reduce before unpacking
    #                                        b−1 (bit-identical; bucketed path)

    def __post_init__(self):
        if self.bucketing not in ("auto", "on", "off"):
            raise ValueError(f"unknown bucketing mode {self.bucketing!r}")
        if self.error_mode not in ("global", "local"):
            raise ValueError(f"unknown error_mode {self.error_mode!r}")
        if self.num_iters < 1:
            raise ValueError(f"num_iters must be ≥ 1, got {self.num_iters}")
        matrixize.check_wire_dtype(self.wire_dtype)
        get_orthogonalizer(self.orthogonalizer)


# ---------------------------------------------------------------------------
# Rank schedules: fixed / staircase / residual-energy-driven
# ---------------------------------------------------------------------------


class RankSchedule:
    """Policy deciding the active rank over training, asked by the host
    before each step.  ``next_rank`` is deterministic in its arguments, so
    every worker (and a resumed run) takes the same switch at the same
    step."""

    def initial_rank(self) -> int:
        raise NotImplementedError

    def next_rank(self, step: int, current: int,
                  residual: Optional[float] = None) -> int:
        """Active rank for step ``step``; ``residual`` is the controller's
        smoothed residual ratio (None when none was measured)."""
        raise NotImplementedError

    @property
    def needs_residual(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class FixedRank(RankSchedule):
    """The paper's setting: one rank for the whole run."""

    rank: int = 2

    def initial_rank(self) -> int:
        return self.rank

    def next_rank(self, step, current, residual=None) -> int:
        return self.rank


@dataclasses.dataclass(frozen=True)
class StaircaseRank(RankSchedule):
    """``milestones``: sorted ``(step, rank)`` pairs; step t runs at the rank
    of the last milestone with ``step <= t`` (e.g. ``"1@0,2@50,4@100"``)."""

    milestones: Tuple[Tuple[int, int], ...] = ((0, 2),)

    def __post_init__(self):
        assert self.milestones and self.milestones[0][0] == 0, (
            "first milestone must cover step 0", self.milestones)
        steps = [s for s, _ in self.milestones]
        assert steps == sorted(steps), ("milestones must be sorted",
                                        self.milestones)
        assert all(r >= 1 for _, r in self.milestones), self.milestones

    def initial_rank(self) -> int:
        return self.milestones[0][1]

    def next_rank(self, step, current, residual=None) -> int:
        rank = self.milestones[0][1]
        for s, r in self.milestones:
            if step >= s:
                rank = r
        return rank


@dataclasses.dataclass(frozen=True)
class ResidualEnergyRank(RankSchedule):
    """Rank driven by the residual ratio ρ = ‖M − P̂Qᵀ‖_F / ‖M‖_F.  Every
    ``every`` steps the smoothed ρ̄ (an EMA with weight ``ema`` on the past,
    kept by :class:`RankController`) is held against a hysteresis band:
    ρ̄ > ``grow_above`` doubles the rank toward ``max_rank``, ρ̄ <
    ``shrink_below`` halves it toward ``min_rank``."""

    min_rank: int = 1
    max_rank: int = 8
    init_rank: int = 4
    shrink_below: float = 0.35
    grow_above: float = 0.7
    every: int = 10
    ema: float = 0.8

    def __post_init__(self):
        assert 1 <= self.min_rank <= self.init_rank <= self.max_rank
        assert 0.0 <= self.shrink_below < self.grow_above

    def initial_rank(self) -> int:
        return self.init_rank

    @property
    def needs_residual(self) -> bool:
        return True

    def next_rank(self, step, current, residual=None) -> int:
        if residual is None or step == 0 or step % self.every:
            return current
        if residual > self.grow_above:
            return min(current * 2, self.max_rank)
        if residual < self.shrink_below:
            return max(current // 2, self.min_rank)
        return current


_RESIDUAL_KEYS = {"min": "min_rank", "max": "max_rank", "init": "init_rank",
                  "shrink": "shrink_below", "grow": "grow_above",
                  "every": "every", "ema": "ema"}


def parse_schedule(spec) -> RankSchedule:
    """A :class:`RankSchedule` from a ``RankSchedule`` (returned as is), an
    int or ``"4"`` (:class:`FixedRank`), ``(step, rank)`` pairs or
    ``"4@0,2@60,1@120"`` (``rank@step``, :class:`StaircaseRank`), or
    ``"residual:min=1,max=8,init=4,shrink=…,grow=…,every=…,ema=…"`` (every
    key optional, :class:`ResidualEnergyRank`).  Anything else raises
    ``TypeError``."""
    if isinstance(spec, RankSchedule):
        return spec
    if isinstance(spec, int):
        return FixedRank(rank=spec)
    if isinstance(spec, (tuple, list)):
        return StaircaseRank(milestones=tuple((int(s), int(r)) for s, r in spec))
    if not isinstance(spec, str):
        raise TypeError(f"cannot parse rank schedule from {spec!r}")
    s = spec.strip()
    if s.startswith("residual"):
        kw = {}
        if ":" in s:
            for item in s.split(":", 1)[1].split(","):
                k, v = item.split("=")
                field = _RESIDUAL_KEYS[k.strip()]
                kw[field] = (float(v) if field in
                             ("shrink_below", "grow_above", "ema") else int(v))
        return ResidualEnergyRank(**kw)
    if "@" in s:
        pairs = []
        for item in s.split(","):
            r, at = item.split("@")
            pairs.append((int(at), int(r)))
        return StaircaseRank(milestones=tuple(sorted(pairs)))
    return FixedRank(rank=int(s))


# ---------------------------------------------------------------------------
# Warm-start-preserving rank transitions
# ---------------------------------------------------------------------------


def transition_factor(q: torch.Tensor, new_rank: int,
                      draw: Optional[Callable] = None,
                      path=()) -> torch.Tensor:
    """One warm-start factor ``(..., m, r)`` moved to ``(..., m, new_rank)``.

    The retained columns are the old ones bit for bit, under any
    orthogonalizer: a decrease keeps the leading ``new_rank`` columns (every
    orthogonalizer takes the columns in order, P̂'s column j in the span of
    P's first j + 1, so these carry the dominant directions), as a new
    dense tensor, so the kernels see a dense factor and the old storage can
    go.  Under ``cholesky_qr`` the jitter scales with trace(PᵀP)/r, so the
    P̂ a rank-r step makes does not begin with the P̂ a rank-k step would
    make, as in the JAX package (ROADMAP C3); an increase
    appends ``draw(path, (m, new_rank − r))``, fresh standard-normal
    columns drawn once and broadcast over any batch dims.  The same rank
    returns ``q`` itself."""
    r = q.shape[-1]
    if new_rank == r:
        return q
    if new_rank < r:
        return q[..., :new_rank].contiguous()
    if draw is None:
        raise ValueError("growing a factor draws fresh columns: pass a draw")
    m = q.shape[-2]
    cols = draw(path, (m, new_rank - r)).to(device=q.device, dtype=q.dtype)
    return torch.cat([q, cols.expand(tuple(q.shape[:-2]) + (m, new_rank - r))],
                     dim=-1)


def transition_state(state, new_rank, draw: Optional[Callable] = None):
    """:func:`transition_factor` over a state tree (``None`` leaves pass
    through).  ``new_rank`` is an int (a uniform switch) or a tree of
    per-leaf ints or ``None`` aligned with ``state`` (``None`` leaves that
    factor as it is).  ``draw(path, shape)`` gives a leaf's fresh
    columns."""
    items = list(tree.items(state))
    ranks = ([new_rank] * len(items) if isinstance(new_rank, int)
             else tree.leaves(new_rank))
    if len(ranks) != len(items):
        raise ValueError("the rank tree does not align with the state")
    out = []
    for (path, q), r in zip(items, ranks):
        out.append(q if q is None or r is None
                   else transition_factor(q, int(r), draw, path))
    return tree.unflatten(state, out)


class RankController:
    """Runs a :class:`RankSchedule` on the host.

    Call :meth:`update` once per step, before the step, with the step's
    index (and the previous step's residual ratio for a residual
    schedule); it returns the compressor state, transitioned when the
    policy switches, and whether it did.  The controller keeps the one
    piece of mutable policy state, the residual EMA.

    Switch n draws its fresh columns from ``engine.step_seed(seed, n)``
    (:meth:`draw`), where the JAX package splits a key per switch; so a
    restored controller (:meth:`load_state_dict`) replays the rest of a
    schedule, columns included.
    """

    def __init__(self, schedule, seed: Optional[int] = None):
        self.schedule = parse_schedule(schedule)
        self.seed = 17 if seed is None else int(seed)
        self.switches = 0
        self.rank = self.schedule.initial_rank()
        self._ema: Optional[float] = None
        self.history: list = [(0, self.rank)]   # (step, rank) switch log

    def draw(self, switch: int, path, shape) -> torch.Tensor:
        """The fresh columns of switch ``switch`` for the leaf at ``path``:
        standard normal float32, on the CPU, from a generator seeded by the
        switch's seed and the path.  A caller may override it to feed in
        other columns."""
        gen = engine.leaf_generator(engine.step_seed(self.seed, switch), path)
        return torch.randn(shape, generator=gen)

    def observe(self, residual: Optional[float]) -> Optional[float]:
        if residual is None:
            return self._ema
        lam = getattr(self.schedule, "ema", 0.0)
        self._ema = (float(residual) if self._ema is None
                     else lam * self._ema + (1 - lam) * float(residual))
        return self._ema

    def update(self, comp_state, step: int, residual: Optional[float] = None):
        """-> ``(comp_state, changed)``."""
        ema = self.observe(residual)
        new = int(self.schedule.next_rank(step, self.rank, ema))
        if new == self.rank:
            return comp_state, False
        n = self.switches
        comp_state = transition_state(
            comp_state, new, lambda path, shape: self.draw(n, path, shape))
        self.switches += 1
        self.rank = new
        self.history.append((step, new))
        return comp_state, True

    def state_dict(self) -> dict:
        """A snapshot of plain Python values: ``rank``, ``ema`` and
        ``history`` as the JAX package's, the port's ``seed`` and
        ``switches``, and ``key_data``/``key_dtype`` as the JAX package
        writes them for ``jax.random.key(seed)`` (the words ``[seed >> 32,
        seed & 0xFFFFFFFF]``), so that its ``load_state_dict`` takes the
        snapshot too."""
        return {"rank": int(self.rank),
                "ema": None if self._ema is None else float(self._ema),
                "history": [[int(s), int(r)] for s, r in self.history],
                "key_data": [(self.seed >> 32) & 0xFFFFFFFF,
                             self.seed & 0xFFFFFFFF],
                "key_dtype": "key<fry>",
                "seed": int(self.seed), "switches": int(self.switches)}

    def load_state_dict(self, d: dict) -> "RankController":
        """Restore a :meth:`state_dict` snapshot (the schedule comes from
        the constructor), the port's or the JAX package's.

        ``rank``, ``ema`` and ``history`` are taken as they are.  A JAX
        package snapshot holds a split key where the port keeps ``seed``
        and ``switches``; this controller then keeps its own seed and
        counts the switches already taken, ``len(history) − 1``, so its
        next growth draws the columns a port run from the start would
        draw at that switch.  Declared divergence: neither package can
        continue the other's column stream, so the columns of a growth
        after a restore across packages differ (a truncation keeps the
        retained columns, bit for bit, in both)."""
        self.rank = int(d["rank"])
        self._ema = None if d["ema"] is None else float(d["ema"])
        self.history = [(int(s), int(r)) for s, r in d["history"]]
        if "seed" in d:
            self.seed = int(d["seed"])
            self.switches = int(d["switches"])
        else:
            self.switches = len(self.history) - 1
        return self


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
                       draw: Optional[Callable] = None,
                       partition=None) -> engine.CompressOut:
    """One PowerSGD step: bucketed (2 collectives per power iteration) or,
    under ``bucketing="off"``, per leaf.

    ``deltas`` carry ``ctx.lead`` worker dims; ``state`` (the Q factors) is
    worker-identical and held once.  ``draw(path, shape)`` → a fresh
    standard-normal factor for that leaf, needed only without warm start
    (both paths draw the same factor for a leaf).  ``partition``, a
    :func:`state_partition` tree, marks the bucket slabs that hold
    model-sharded or model-local factors (``MatrixPayloads.
    bucket_model_sharded``).  Returns ``agg`` held once and, under
    ``error_mode="local"``, a per-worker ``recon``.
    """
    if not cfg.warm_start and draw is None:
        raise ValueError("warm_start=False draws fresh factors: pass a draw "
                         "(the compressor's step takes a seed)")
    if cfg.bucketing == "off":
        return _compress_aggregate_per_leaf(cfg, deltas, state, specs, ctx,
                                            draw)
    orth = get_orthogonalizer(cfg.orthogonalizer)
    payloads = engine.MatrixPayloads.build(
        deltas, state, specs, dtype=cfg.dtype,
        tolerance=cfg.bucket_pad_tolerance, lead=ctx.lead,
        resample=None if cfg.warm_start else draw, partition=partition)
    transport_cls = (engine.PipelinedTransport if cfg.pipeline
                     else engine.Transport)
    transport = transport_cls(ctx=ctx, wire_dtype=cfg.wire_dtype,
                              max_chunk_bytes=cfg.max_chunk_bytes)
    m_bufs, q_bufs = payloads.m_bufs, payloads.q_bufs

    # Under sync_mode="broadcast" the phase reduces take the canonical order
    # and defer the replica sync (sync=False) to one fused rank-0 broadcast
    # of what the update and the next step are built from: P̂, Q and the
    # uncompressed aggregates (2 reduces + 1 broadcast a step)
    unc_agg = payloads.unc_values
    p_hats = q_locals = []
    for it in range(cfg.num_iters):
        p_locals = [ops.lowrank_project(mb, ctx.per_worker(qb))
                    for mb, qb in zip(m_bufs, q_bufs)]
        extra = unc_agg if it == 0 else []
        reduced = transport.reduce_mean(p_locals + extra, sync=False)
        p_bufs = reduced[:len(p_locals)]
        if it == 0:
            unc_agg = reduced[len(p_locals):]
        p_hats = [orth(p) for p in p_bufs]
        q_locals = [ops.lowrank_backproject(mb, ctx.per_worker(ph))
                    for mb, ph in zip(m_bufs, p_hats)]
        q_bufs = transport.reduce_mean(q_locals, sync=False)

    if ctx.sync_mode == "broadcast" and ctx.data_axes:
        flat = transport.broadcast(p_hats + q_bufs + unc_agg)
        p_hats = flat[:len(p_hats)]
        q_bufs = flat[len(p_hats):len(p_hats) + len(q_bufs)]
        unc_agg = flat[len(p_hats) + len(q_bufs):]

    agg_bufs = [ref.decompress(ph, qb) for ph, qb in zip(p_hats, q_bufs)]
    if cfg.error_mode == "local":
        recon_bufs = [ref.decompress(ctx.per_worker(ph), ql)
                      for ph, ql in zip(p_hats, q_locals)]
        recon_lead = ctx.lead
    else:
        recon_bufs, recon_lead = agg_bufs, ()

    metrics = None
    if cfg.track_residual and m_bufs:
        # per bucket and worker; padding adds exact zeros to both norms
        norms = [_sq_norms(mb, ab, len(ctx.lead)) for mb, ab in zip(m_bufs, agg_bufs)]
        nums = torch.stack([n for n, _ in norms], dim=-1)   # lead + (buckets,)
        dens = torch.stack([d for _, d in norms], dim=-1)
        metrics = {"residual_ratio": _residual_ratio(sum(n for n, _ in norms),
                                                     sum(d for _, d in norms)),
                   "bucket_residual_ratio": _residual_ratio(nums, dens)}

    agg, recon, new_state = payloads.scatter(agg_bufs, recon_bufs, q_bufs,
                                             unc_agg, recon_lead=recon_lead)
    return engine.CompressOut(agg=agg, recon=recon, state=new_state,
                              bits_per_worker=payloads.bits, metrics=metrics)


def _sq_norms(mat: torch.Tensor, agg: torch.Tensor, nl: int):
    """``(Σ(M − agg)², ΣM²)`` per worker, each of shape ``mat.shape[:nl]``:
    ``mat`` carries ``nl`` worker dims, ``agg`` none.  One worker at a time,
    so the difference never takes more than one worker's slab."""
    lead = tuple(mat.shape[:nl])
    flat = mat.reshape((-1,) + tuple(mat.shape[nl:]))
    nums, dens = [], []
    for w in range(flat.shape[0]):
        nums.append(torch.linalg.vector_norm(flat[w] - agg).square())
        dens.append(torch.linalg.vector_norm(flat[w]).square())
    return torch.stack(nums).reshape(lead), torch.stack(dens).reshape(lead)


def _residual_ratio(num_sq, den_sq):
    """sqrt(Σ‖M − P̂Qᵀ‖² / Σ‖M‖²), the denominator held at float32's
    smallest normal."""
    return torch.sqrt(num_sq / torch.clamp(den_sq, min=torch.finfo(torch.float32).tiny))


def _compress_aggregate_per_leaf(cfg: PowerSGDConfig, deltas, state, specs,
                                 ctx: MeshCtx, draw) -> engine.CompressOut:
    """The per-leaf reference path: each matrix leaf's ``lead + batch +
    (n, m)`` matrices go through one project and one backproject launch and
    two ``pmean_data`` calls per power iteration; each vector leaf through
    one ``pmean_data`` of its own."""
    orth = get_orthogonalizer(cfg.orthogonalizer)
    lead = ctx.lead
    floats, results, norms = 0, [], []
    for path, g, q, spec in engine.collect_leaves(deltas, state, specs):
        shape = tuple(g.shape[len(lead):])
        if q is None:
            floats += matrixize.uncompressed_floats(shape)
            results.append((ctx.pmean_data(g), g, None))
            continue
        batch_shape, n, m = matrixize.matrix_shape(shape, spec)
        mat = g.to(cfg.dtype).reshape(tuple(lead) + batch_shape + (n, m))
        if not cfg.warm_start:
            q = draw(path, tuple(q.shape)).to(q.device)
        q = q.to(cfg.dtype)
        for _ in range(cfg.num_iters):
            p_hat = orth(ctx.pmean_data(
                ops.lowrank_project(mat, ctx.per_worker(q))))
            q_local = ops.lowrank_backproject(mat, ctx.per_worker(p_hat))
            q = ctx.pmean_data(q_local)
        agg = ref.decompress(p_hat, q)
        if cfg.error_mode == "local":
            recon = ref.decompress(ctx.per_worker(p_hat), q_local)
            recon = recon.reshape(tuple(lead) + shape)
        else:
            recon = agg.reshape(shape)
        floats += matrixize.compressed_floats(shape, spec, q.shape[-1])
        if cfg.track_residual:
            norms.append(_sq_norms(mat, agg, len(lead)))
        results.append((agg.reshape(shape).to(g.dtype), recon.to(g.dtype), q))
    metrics = None
    if norms:
        metrics = {"residual_ratio": _residual_ratio(sum(n for n, _ in norms),
                                                     sum(d for _, d in norms))}
    agg, recon, new_state = engine.scatter_tree(deltas, results)
    return engine.CompressOut(agg=agg, recon=recon, state=new_state,
                              bits_per_worker=floats * 32, metrics=metrics)


def compressed_floats_total(shapes, specs, rank) -> int:
    """Analytic floats per step (paper Tables 3/10/11).  ``rank`` is an int
    (a static rank) or a compressor state tree aligned with ``shapes``, whose
    leaves are charged at their own factor's rank (``None``: uncompressed)."""
    leaves = tree.leaves(shapes)
    ranks = ([rank] * len(leaves) if isinstance(rank, int)
             else [0 if q is None else q.shape[-1] for q in tree.leaves(rank)])
    return sum(matrixize.compressed_floats(tuple(s.shape), spec, r)
               for s, spec, r in zip(leaves, tree.leaves(specs), ranks))
