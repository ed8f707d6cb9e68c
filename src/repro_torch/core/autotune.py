"""α-β autotuner for PowerSGD's fused-collective transport (port of
``repro.core.autotune``): host-side arithmetic over shapes, no tensors.

    shapes/specs ──► bucket plan (matrixize.plan_buckets, the plan the
                     engine executes)
    HardwareModel (α latency, β bandwidth) ──► modeled exchange time
    bits budget ──► per-bucket rank, global (wire_dtype, max_chunk_bytes)

:func:`autotune` returns a :class:`TunePlan`, field for field the JAX
package's for the same inputs (the same operations in the same order, so
``predicted_comm_s`` is the same Python float).  :func:`make_tuned_compressor`
builds the PowerSGD compressor the plan describes and :func:`apply_plan`
installs its per-bucket ranks into a compressor state with the
warm-start-preserving transitions of
:func:`repro_torch.core.powersgd.transition_state`.

The wire dtype is chosen for the whole plan (per-bucket wire dtypes would
split the fused chunk into one collective per dtype), and ranks per shape
bucket, never per leaf (leaves sharing a bucket share a ``(B, m, r)``
factor slab).  The greedy walk-down of :func:`autotune` starts every bucket
at its largest candidate rank and shrinks, one step at a time, the bucket
that saves the most bits per unit of modeled quality loss
(``(r − r')/min(n, m) · Σ count·n·m``, optionally scaled by a measured
per-bucket residual ratio), until the bits budget holds.

Declared divergence: the JAX package's :meth:`HardwareModel.from_roofline`,
and with it ``autotune(hw=None)``, prices the links of a TPU.  The port
carries no TPU figure: both raise ``NotImplementedError`` (ROADMAP queue
A, item 16, where the card's roofline figures belong); pass a
:class:`HardwareModel`, e.g. ``HardwareModel.from_backend("nccl_10gbit")``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch import tree
from repro_torch.core import matrixize, powersgd
from repro_torch.core.compressors import PowerSGDCompressor

# α-β parameters of the paper's Appendix B cluster (10 Gbit/s Ethernet):
# backend -> (latency in seconds, bandwidth in bytes/s); the one copy, which
# repro_torch.bench.common.BW / LATENCY read
BACKENDS = {
    "nccl_10gbit": (30e-6, 10e9 / 8),
    "gloo_10gbit": (150e-6, 2.5e9 / 8),
}

# budget bits one payload float costs under each wire dtype: the float
# wires keep the paper's 32-bit accounting, the quantized wires re-price
# the budget at their real width
_WIRE_BUDGET_BITS = {"float32": 32, "bfloat16": 32, "int8": 8, "int4": 4}
# bytes one payload element occupies on the wire (α-β pricing)
_WIRE_ITEMSIZE = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """α-β link model: one collective costs α·(#rounds) + β·(bytes moved).

    ``alpha`` is the per-round launch latency in seconds, ``bw`` the
    per-link bandwidth in bytes/s (β = 1/bw).
    """

    alpha: float
    bw: float

    @classmethod
    def from_roofline(cls, alpha: float = 20e-6) -> "HardwareModel":
        """The JAX package's roofline link is a TPU's; the port has no
        roofline figures yet."""
        raise NotImplementedError(
            "HardwareModel.from_roofline needs the card's link figures, which "
            "are not ported yet (ROADMAP queue A, item 16); pass a "
            "HardwareModel, e.g. HardwareModel.from_backend('nccl_10gbit')")

    @classmethod
    def from_backend(cls, name: str) -> "HardwareModel":
        """The paper's Ethernet backends (``nccl_10gbit``/``gloo_10gbit``)."""
        alpha, bw = BACKENDS[name]
        return cls(alpha=alpha, bw=bw)

    def collective_time(self, wire_bytes: float, workers: int,
                        kind: str = "reduce") -> float:
        """Modeled seconds for one fused collective among ``workers``:
        ``"reduce"`` a ring all-reduce, ``"broadcast"`` scatter plus
        all-gather (half the reduce's bandwidth term, the same depth), any
        other kind an all-gather."""
        if workers <= 1:
            return 0.0
        if kind == "reduce":
            rounds = math.ceil(math.log2(workers))
            return (self.alpha * rounds
                    + 2 * (workers - 1) / workers * wire_bytes / self.bw)
        if kind == "broadcast":
            rounds = math.ceil(math.log2(workers))
            return (self.alpha * rounds
                    + (workers - 1) / workers * wire_bytes / self.bw)
        return (self.alpha + wire_bytes / self.bw) * (workers - 1)


def comm_time_from_stats(stats, workers: int, hw: HardwareModel, *,
                         overlap_compute_s: float = 0.0) -> float:
    """α-β time of one recorded step (a
    :class:`~repro_torch.core.dist.CollectiveStats`): each collective at its
    recorded size, itemsize, kind and sidecar bytes.  Compare with
    ``TunePlan.predicted_comm_s``.  ``overlap_compute_s`` is compute that
    hides communication: only ``max(0, comm − compute)`` is returned."""
    total = 0.0
    for size, itemsize, kind, overhead in zip(stats.sizes, stats.itemsizes,
                                              stats.kinds, stats.overheads):
        total += hw.collective_time(size * itemsize + overhead, workers, kind)
    return max(0.0, total - overlap_compute_s)


# ---------------------------------------------------------------------------
# plan data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketDecision:
    """The tuner's verdict for one shape bucket."""

    bucket: int                # index into the BucketPlan's buckets
    n: int                     # bucket (padded) rows
    m: int                     # bucket (padded) cols
    count: int                 # stacked matrices in the bucket
    rank: int                  # assigned rank
    payload_floats: int        # Σ_leaves count·r·(n_leaf + m_leaf), unpadded
    wire_floats: int           # count·r·(n + m) at bucket dims (what travels)


@dataclasses.dataclass(frozen=True)
class TunePlan:
    """Per-bucket ranks and a global wire policy, under a bits budget."""

    decisions: Tuple[BucketDecision, ...]
    wire_dtype: str
    max_chunk_bytes: Optional[int]
    tolerance: float           # bucket_pad_tolerance the plan was built at:
    #                            the engine must plan with the same value
    payload_floats: int        # compressed floats per step (bits metric)
    uncompressed_floats: int   # vector leaves riding the first reduce
    bits_per_step: int         # (payload + uncompressed) × 32, the paper's
    #                            Tables 3/10/11 convention
    wire_bits_per_step: int    # on-the-wire bits: payload at the wire
    #                            dtype's width (16/8/4) + scale sidecars
    predicted_comm_s: float    # α-β modeled gradient exchange per step
    workers: int
    leaf_ranks: Tuple[Optional[int], ...]  # per planner leaf, tree order

    def rank_tree(self, shapes, specs):
        """Per-leaf rank tree shaped like ``shapes`` (``None``: uncompressed),
        the form :func:`repro_torch.core.powersgd.transition_state` takes."""
        if len(tree.leaves(specs)) != len(self.leaf_ranks):
            raise ValueError("the plan's leaves do not align with the tree")
        return tree.unflatten(shapes, list(self.leaf_ranks))


def _collect(shapes, specs):
    """(shape, spec) pairs in tree order: the leaf order of
    :func:`repro_torch.core.engine.collect_leaves`, so planner indices line
    up with the engine's buckets."""
    return [(tuple(s.shape), sp)
            for s, sp in zip(tree.leaves(shapes), tree.leaves(specs))]


def _phase_time(wire_floats: Sequence[int], unc_floats: int, itemsize: float,
                workers: int, hw: HardwareModel,
                max_chunk_bytes: Optional[int],
                overhead_bytes: float = 0.0) -> float:
    """Modeled time of the two fused reduce phases of one PowerSGD step:
    phase 1 carries every bucket's P slab plus the uncompressed leaves,
    phase 2 the Q slabs, each modeled at half the factors' floats.
    ``overhead_bytes`` (quantization scales) is split over the phases."""
    total = 0.0
    for phase_floats in (sum(wire_floats) / 2 + unc_floats,
                         sum(wire_floats) / 2):
        nbytes = phase_floats * itemsize + overhead_bytes / 2
        chunks = (1 if not max_chunk_bytes
                  else max(1, math.ceil(nbytes / max_chunk_bytes)))
        per_chunk = nbytes / chunks
        total += sum(hw.collective_time(per_chunk, workers, "reduce")
                     for _ in range(chunks))
    return total


def autotune(shapes, specs, *, bits_budget: int, workers: int,
             hw: Optional[HardwareModel] = None,
             ranks: Sequence[int] = (1, 2, 4, 8),
             wire_dtypes: Sequence[str] = ("float32", "bfloat16"),
             max_chunk_bytes_options: Sequence[Optional[int]] = (None,),
             tolerance: float = 0.25,
             bucket_residuals: Optional[Sequence[float]] = None,
             overlap_compute_s: float = 0.0) -> TunePlan:
    """Select per-bucket ``rank`` and a global ``(wire_dtype,
    max_chunk_bytes)``.

    ``shapes`` is a tree of anything with ``.shape`` (tensors, meta
    tensors) aligned with ``specs``.  ``bits_budget`` bounds the payload
    bits per step per worker: 32 bits per float on the float wires (the
    uncompressed leaves are a fixed cost), the quantized wires' real width
    on int8/int4.  The walk-down runs once per wire candidate; the
    candidate keeping the most payload floats wins, ties broken by the α-β
    modeled exchange time over ``max_chunk_bytes_options`` (float32 and
    bfloat16 always tie on floats, so bfloat16 wins on time), then by
    candidate order.  ``bucket_residuals`` (one per bucket, e.g. a step's
    ``bucket_residual_ratio``) scales each bucket's quality loss;
    ``overlap_compute_s`` prices candidates by exposed time ``max(0,
    modeled − overlap_compute_s)``.  ``hw`` is required (see the module's
    declared divergence).  Deterministic: same inputs, same plan.
    """
    hw = hw or HardwareModel.from_roofline()   # raises: no TPU figures here
    ranks = sorted(set(int(r) for r in ranks))
    assert ranks and ranks[0] >= 1, ranks

    leaves = _collect(shapes, specs)
    plan_shapes, unc_floats = [], 0
    for shape, spec in leaves:
        ms = matrixize.matrix_shape(shape, spec)
        if ms is None:
            plan_shapes.append(None)
            unc_floats += matrixize.uncompressed_floats(shape)
        else:
            batch_shape, n, m = ms
            plan_shapes.append((math.prod(batch_shape) if batch_shape else 1,
                                n, m))
    plan = matrixize.plan_buckets(plan_shapes, tolerance=tolerance)
    if bucket_residuals is not None:
        assert len(bucket_residuals) == len(plan.buckets), (
            len(bucket_residuals), len(plan.buckets))

    # per bucket: payload floats per rank unit (leaf dims), wire floats per
    # rank unit (padded bucket dims) and the quality-proxy weight
    pay_unit = [sum(e.count * (e.n + e.m) for e in b.entries)
                for b in plan.buckets]
    wire_unit = [b.count * (b.n + b.m) for b in plan.buckets]
    elems = [sum(e.count * e.n * e.m for e in b.entries)
             for b in plan.buckets]
    min_nm = [min(b.n, b.m) for b in plan.buckets]
    # a rank compresses only while r·(n+m) < n·m and r ≤ min(n, m): cap each
    # bucket's candidates there, per its smallest member
    rank_cap = [max(1, min(min(e.n, e.m, e.n * e.m // (e.n + e.m))
                           for e in b.entries))
                for b in plan.buckets]

    def top_index(cap: int) -> int:
        """Largest candidate ≤ cap (index 0 if even ranks[0] exceeds it)."""
        return max([i for i, r in enumerate(ranks) if r <= cap] or [0])

    def payload_floats(cur) -> int:
        return sum(pay_unit[b] * ranks[i] for b, i in cur.items())

    def walk_down(budget_floats: int) -> dict:
        """Every bucket at its top candidate, then shrink the best
        bits-saved-per-quality-loss bucket until the budget holds."""
        cur = {b: top_index(rank_cap[b]) for b in range(len(plan.buckets))}
        while payload_floats(cur) > budget_floats:
            best, best_score = None, None
            for b, i in cur.items():
                if i == 0:
                    continue
                saved = pay_unit[b] * (ranks[i] - ranks[i - 1])
                loss = (ranks[i] - ranks[i - 1]) / max(min_nm[b], 1) * elems[b]
                if bucket_residuals is not None:
                    loss *= max(float(bucket_residuals[b]), 1e-3)
                score = saved / max(loss, 1e-12)
                if best_score is None or score > best_score:
                    best, best_score = b, score
            if best is None:
                break  # every bucket at its smallest rank: infeasible budget
            cur[best] -= 1
        return cur

    n_unc_leaves = sum(1 for ps in plan_shapes if ps is None)
    best_cfg = best_cur = best_time = best_pay = None
    for wd in wire_dtypes:
        if wd not in matrixize.WIRE_DTYPES or wd == "auto":
            raise ValueError(
                f"wire_dtype candidate {wd!r} must be an explicit dtype "
                f"(one of {[d for d in matrixize.WIRE_DTYPES if d != 'auto']})")
        budget_floats = max(
            0, bits_budget // _WIRE_BUDGET_BITS[wd] - unc_floats)
        cur = walk_down(budget_floats)
        pay = payload_floats(cur)
        wire_floats = [wire_unit[b] * ranks[i] for b, i in cur.items()]
        quant = wd in matrixize.QUANT_WIRE_DTYPES
        # one float32 scale per quantized slot: a P and a Q slab per bucket,
        # and every uncompressed leaf on phase 1
        overhead = (matrixize.SCALE_BYTES
                    * (2 * len(plan.buckets) + n_unc_leaves) if quant else 0)
        for mcb in max_chunk_bytes_options:
            t = _phase_time(wire_floats, unc_floats, _WIRE_ITEMSIZE[wd],
                            workers, hw, mcb, overhead_bytes=overhead)
            t = max(0.0, t - overlap_compute_s)
            if (best_pay is None or pay > best_pay
                    or (pay == best_pay and t < best_time)):
                best_cfg, best_cur, best_time, best_pay = (wd, mcb), cur, t, pay

    cur = best_cur
    decisions = tuple(
        BucketDecision(
            bucket=b, n=bk.n, m=bk.m, count=bk.count, rank=ranks[cur[b]],
            payload_floats=pay_unit[b] * ranks[cur[b]],
            wire_floats=wire_unit[b] * ranks[cur[b]])
        for b, bk in enumerate(plan.buckets))

    leaf_ranks: List[Optional[int]] = []
    for i, ps in enumerate(plan_shapes):
        if ps is None:
            leaf_ranks.append(None)
        else:
            b_id, _ = plan.entry_for(i)
            leaf_ranks.append(decisions[b_id].rank)

    pay = sum(d.payload_floats for d in decisions)
    wd = best_cfg[0]
    wire_bits_per_step = int((pay + unc_floats) * _WIRE_ITEMSIZE[wd] * 8)
    if wd in matrixize.QUANT_WIRE_DTYPES:
        wire_bits_per_step += 8 * matrixize.SCALE_BYTES * (
            2 * len(plan.buckets) + n_unc_leaves)
    return TunePlan(
        decisions=decisions, wire_dtype=wd,
        max_chunk_bytes=best_cfg[1], tolerance=tolerance,
        payload_floats=pay, uncompressed_floats=unc_floats,
        bits_per_step=(pay + unc_floats) * 32,
        wire_bits_per_step=wire_bits_per_step,
        predicted_comm_s=best_time, workers=workers,
        leaf_ranks=tuple(leaf_ranks))


def apply_plan(plan: TunePlan, state, shapes, specs, draw=None):
    """Install the plan's per-bucket ranks into a compressor state with
    :func:`~repro_torch.core.powersgd.transition_state`: retained columns
    bit for bit.  On a fresh state of :func:`make_tuned_compressor` every
    factor only shrinks, so ``draw`` is not needed; a factor that grows
    appends ``draw(path, (m, k))`` (e.g. a :class:`~repro_torch.core.
    powersgd.RankController`'s or :meth:`Compressor.draw`'s columns).  The
    state is the unreplicated one the port holds; a factor with extra
    leading dims (a stacked worker dim) is transitioned alike in every
    copy, the same columns kept and appended."""
    return powersgd.transition_state(state, plan.rank_tree(shapes, specs),
                                     draw)


def make_tuned_compressor(plan: TunePlan, **kw):
    """A :class:`~repro_torch.core.compressors.PowerSGDCompressor` on the
    plan's wire dtype and chunk cap, planning its buckets at the plan's
    ``tolerance`` (another tolerance could put leaves of different ranks
    in one bucket).  ``init`` draws at the plan's largest rank; call
    :func:`apply_plan` on that state to install the per-bucket ranks."""
    rank = max((d.rank for d in plan.decisions), default=1)
    return PowerSGDCompressor(rank=rank, wire_dtype=plan.wire_dtype,
                              max_chunk_bytes=plan.max_chunk_bytes,
                              bucket_pad_tolerance=plan.tolerance, **kw)
