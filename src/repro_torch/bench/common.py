"""The benchmark LM every paper table trains, the paper's α-β
communication model and the checkpoint profile (port of ``LMSpec``,
``_make_cfg``, ``payload_floats``, ``train_lm``, ``resume_profile``,
``comm_time``, ``broadcast_time``, ``comm_time_from_stats``,
``measure_coding_time`` and ``bytes_per_epoch_mb`` of the JAX package's
``benchmarks/common.py``).

:func:`train_lm` trains a small dense transformer LM on order-1 Markov data
under error feedback and a compressor, with W simulated workers on one
device (:class:`~repro_torch.core.simmesh.SimMesh`): each worker's
gradient on its own batch shard, Δ = g + e, the compressor's fused step,
e ← Δ − recon, and the update ``m ← λm + agg``, ``x ← x − lr·(agg + m)`` at
a constant learning rate without weight decay (the error-feedback step of
:func:`repro_torch.core.error_feedback.apply_updates`).  Shared-seed
draws take the seed of each step from the base seed :data:`RUN_SEED` (the
JAX package's ``fold_in(key(123), step)``).

    from repro_torch.bench.common import LMSpec, train_lm
    from repro_torch.core.compressors import make_compressor
    train_lm(make_compressor("powersgd", rank=2), LMSpec(), device="cpu")

It runs on the CUDA card unless ``device`` says otherwise.  A
:class:`~repro_torch.core.powersgd.RankController` moves the rank between
steps; ``init_comp_transform`` rewrites the initial compressor state (how
:func:`repro_torch.core.autotune.apply_plan` installs a plan's per-bucket
ranks).

The α-β constants (:data:`BW`, :data:`LATENCY`, read from
:data:`repro_torch.core.autotune.BACKENDS`) model the paper's cluster
(Appendix B: 10 Gbit/s Ethernet, NCCL-like and GLOO-like backends); they
are not figures of any card the port runs on.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import (TrainState, canonicalize_sim, replicate_sim,
                                    restore_train_state, save_train_state)
from repro_torch.configs.base import LayerSlot, ModelConfig
from repro_torch.core import autotune, error_feedback, matrixize
from repro_torch.core.compressors import Compressor, PowerSGDCompressor
from repro_torch.core.dist import SINGLE
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.train import (TrainHyper, make_sim_train_step,
                                      resolve_device, worker_grads)
from repro_torch.models import model

Q_CHUNK = 32
EVAL_BATCH = 32
EVAL_STEP0 = 10_000   # eval batches are stream steps the training never reaches
RUN_SEED = 123        # base seed of the per-step shared-seed draws


@dataclasses.dataclass
class LMSpec:
    vocab: int = 256
    d_model: int = 128
    layers: int = 2
    heads: int = 4
    seq: int = 64
    batch_per_worker: int = 4
    workers: int = 4
    steps: int = 150
    lr: float = 0.1
    momentum: float = 0.9
    seed: int = 0
    # order-1 Markov with 8 token clusters: learnable within the step budget
    # and with genuinely low-rank gradients (the paper's premise, §2)
    order: int = 1
    clusters: int = 8


def _make_cfg(spec: LMSpec) -> ModelConfig:
    return ModelConfig(
        name="bench-lm", arch_type="dense", num_layers=spec.layers,
        d_model=spec.d_model, num_heads=spec.heads, num_kv_heads=spec.heads,
        head_dim=spec.d_model // spec.heads, d_ff=spec.d_model * 4,
        vocab_size=spec.vocab, rope_theta=10000.0,
        slots=(LayerSlot("attn", "dense"),))


def tree_buckets(params, specs):
    """The shape buckets the bucketed engine plans for the compressed leaves
    of ``params`` (each with its ``count``, ``n`` and ``m``); ``params`` may
    be meta tensors."""
    shapes = []
    for p, spec in zip(tree.leaves(params), tree.leaves(specs)):
        ms = matrixize.matrix_shape(tuple(p.shape), spec)
        shapes.append(None if ms is None else (math.prod(ms[0]), ms[1], ms[2]))
    return matrixize.plan_buckets(shapes).buckets


def model_buckets(cfg: ModelConfig):
    """:func:`tree_buckets` of ``cfg``'s LM, found on the meta device, so it
    allocates nothing at any width."""
    return tree_buckets(model.init(cfg, None, device="meta"), model.mspecs(cfg))


def payload_floats(params, specs, comp_state):
    """(compressed, uncompressed) floats one step sends per worker, at the
    ranks of the state's factors."""
    comp = unc = 0
    for p, sp, q in zip(tree.leaves(params), tree.leaves(specs),
                        tree.leaves(comp_state)):
        shape = tuple(p.shape)
        if q is None or matrixize.matrix_shape(shape, sp) is None:
            unc += matrixize.uncompressed_floats(shape)
        else:
            comp += matrixize.compressed_floats(shape, sp, q.shape[-1])
    return comp, unc


def _to(t, dev):
    """A copy of tree ``t`` on ``dev`` (the training updates it in place)."""
    return tree.map(lambda x: None if x is None else x.to(dev, copy=True), t)


def sync(dev: torch.device) -> None:
    """Wait for ``dev`` to finish its queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_data(spec: LMSpec) -> MarkovLM:
    return MarkovLM(vocab=spec.vocab, seed=spec.seed, order=spec.order,
                    clusters=spec.clusters)


def eval_set(data: MarkovLM, spec: LMSpec, batches: int, dev):
    """The held-out batches: stream steps the training never reaches."""
    out = []
    for i in range(batches):
        b = torch.tensor(data.sample(EVAL_BATCH, spec.seq, step=EVAL_STEP0 + i),
                         device=dev)
        out.append({"tokens": b[:, :-1], "labels": b[:, 1:]})
    return out


def eval_loss(params, cfg: ModelConfig, batches) -> float:
    """Mean loss of ``params`` over the held-out ``batches``."""
    with torch.no_grad():
        return float(np.mean([model.loss_fn(params, b, cfg, q_chunk=Q_CHUNK)[0].item()
                              for b in batches]))


def probe_bits(compressor: Compressor, params, specs, seed: int = 0) -> int:
    """``bits_per_worker`` of one step of ``compressor`` on zeros shaped like
    ``params``, on their device, from a state initialized with ``seed``
    (the bits depend on the shapes alone)."""
    zeros = tree.map(torch.zeros_like, params)
    dev = tree.leaves(zeros)[0].device
    state = compressor.init(zeros, specs, torch.Generator(dev).manual_seed(seed))
    return int(compressor.step(zeros, state, specs, ctx=SINGLE,
                               seed=RUN_SEED).bits_per_worker)


def train_lm(compressor: Compressor, spec: LMSpec = LMSpec(),
             eval_batches: int = 8, controller=None, init_comp_transform=None,
             *, device=None, params=None, comp_state=None, stats=None,
             return_params: bool = False):
    """Train the benchmark LM under EF + ``compressor`` with ``spec.workers``
    simulated workers.  Returns the JAX package's result dict (compressor,
    eval_loss, eval_ppl, bits_per_worker_per_step, allreduce, train_time_s,
    steps, workers, compressed_floats_total) plus ``step_ms``: the host
    time of every training step, each ending when the device has finished.

    ``params`` and ``comp_state`` (trees of tensors, copied) replace the
    random initial parameters and compressor state, which are otherwise
    drawn on the CPU from a generator seeded with ``spec.seed``.
    ``stats`` (a :class:`~repro_torch.core.dist.CollectiveStats`) records
    every training step's collectives.  ``return_params=True`` returns
    ``(result, params)``, the trained parameters on ``device``.

    ``init_comp_transform(comp_state) -> comp_state`` rewrites the initial
    compressor state (on the CPU, before training; e.g. ``lambda cs:
    autotune.apply_plan(plan, cs, shapes, specs)``); each step's payload
    is then counted at every leaf's own rank.

    ``controller`` (a :class:`~repro_torch.core.powersgd.RankController`)
    is asked before each step, with the previous step's residual ratio
    averaged over the workers (0 where the compressor reports none, None
    before the first step); on a switch the state's factors are replaced
    and the payload recounted.  The result then also holds
    ``rank_history`` and ``final_rank``.
    """
    dev = resolve_device(device)
    cfg = _make_cfg(spec)
    specs = model.mspecs(cfg)
    gen = torch.Generator().manual_seed(spec.seed)
    if params is None:
        params = model.init(cfg, gen, device="cpu")
    if comp_state is None:
        comp_state = compressor.init(_to(params, "cpu"), specs, gen)
    if init_comp_transform is not None:
        comp_state = init_comp_transform(comp_state)
    params = _to(params, dev)
    sim = SimMesh(spec.workers)
    ctx = sim.ctx(stats=stats)
    state = EFState(
        error=tree.map(lambda p: torch.zeros((spec.workers,) + tuple(p.shape),
                                             dtype=p.dtype, device=dev), params),
        momentum=tree.map(torch.zeros_like, params),
        comp=_to(comp_state, dev), step=0)

    data = lm_data(spec)
    it = data.batches(spec.batch_per_worker * spec.workers, spec.seq)
    eval_data = eval_set(data, spec, eval_batches, dev)

    t0 = time.time()
    bits = None
    # stateful schemes (PowerSGD's Q factors) send a fixed payload per step;
    # stateless ones fall back to the probe's bits below
    stateful = state.comp is not None
    step_floats = payload_floats(params, specs, state.comp) if stateful else (0, 0)
    floats_sent = 0
    step_ms = []
    residual = None
    for i in range(spec.steps):
        if controller is not None:
            new_comp, changed = controller.update(state.comp, i, residual)
            if changed:   # factor shapes moved: recount the payload
                state = error_feedback.replace_comp(state, new_comp)
                step_floats = payload_floats(params, specs, state.comp)
        floats_sent += step_floats[0]
        batch = sim.shard({k: torch.tensor(v, device=dev)
                           for k, v in next(it).items()})
        ts = time.perf_counter()
        grads, _ = worker_grads(cfg, params, batch, spec.workers,
                                q_chunk=Q_CHUNK, device=dev)
        params, state, aux = error_feedback.apply_updates(
            compressor, params, grads, state, specs, lr=spec.lr,
            momentum=spec.momentum, ctx=ctx, seed=RUN_SEED)
        sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if controller is not None:
            res = aux.get("residual_ratio")
            residual = 0.0 if res is None else float(res.mean())
        if bits is None:
            bits = probe_bits(compressor, params, specs, spec.seed)
    train_time = time.time() - t0

    ev = eval_loss(params, cfg, eval_data)
    result = {
        "compressor": compressor.name,
        "eval_loss": ev,
        "eval_ppl": float(np.exp(ev)),
        "bits_per_worker_per_step": int(bits),
        "allreduce": compressor.allreduce,
        "train_time_s": train_time,
        "steps": spec.steps,
        "workers": spec.workers,
        # cumulative compressed floats over the run; stateless schemes count
        # the probe's payload
        "compressed_floats_total": (int(floats_sent) if stateful
                                    else int(bits) // 32 * spec.steps),
        "step_ms": step_ms,
    }
    if controller is not None:
        result["rank_history"] = list(controller.history)
        result["final_rank"] = controller.rank
    return (result, params) if return_params else result


def sim_start(cfg: ModelConfig, sim: SimMesh, hyper: TrainHyper, dev, *,
              compressor: Compressor = None, seed: int = 0, params=None,
              comp_state=None):
    """``make_sim_train_step``'s initial ``(params, ef_state)`` on ``dev``,
    drawn on the CPU from a generator seeded with ``seed`` (so the card
    and the CPU start alike); ``params`` and ``comp_state`` (trees of
    tensors, copied) replace the drawn parameters and compressor state."""
    _, init = make_sim_train_step(cfg, sim, hyper, compressor=compressor,
                                  device="cpu")
    p, ef = init(torch.Generator().manual_seed(seed))
    if comp_state is not None:
        ef = dataclasses.replace(ef, comp=comp_state)
    return _to(p if params is None else params, dev), ef.to(dev)


# ---------------------------------------------------------------------------
# fault-tolerant resume: what a checkpoint costs, and what each state piece
# is worth
# ---------------------------------------------------------------------------

def resume_profile(spec: LMSpec, ckpt_dir: str, ckpt_every: int = 20, *,
                   device=None) -> list:
    """The checkpoint subsystem on the benchmark LM: ``spec.workers``
    simulated workers under rank-2 PowerSGD through
    :func:`~repro_torch.launch.train.make_sim_train_step` and
    :mod:`repro_torch.checkpoint`, the path the CLI's resume takes, on
    ``device`` (the CUDA card unless it says otherwise).  Rows, in the JAX
    package's keys and order:

    * ``uninterrupted``: the run to ``spec.steps``, saving every
      ``ckpt_every`` steps and at 80 % of the horizon (the kill point);
    * ``resume_full``: a new step and compressor restore the kill point's
      envelope from ``ckpt_dir`` and continue; its per-step losses must be
      bit-exact against the uninterrupted run's;
    * ``resume_drop_ef``: the same with the error buffers zeroed;
    * ``resume_drop_warm_start``: the same with the Q factors drawn anew
      (a fresh compressor seeded 999);
    * ``checkpoint_cost``: the envelope's MB, the mean save ms, the
      restore ms and the saves' share of the training's wall time (host
      clock, the device synchronized before each save).

    The initial state is drawn on the CPU from ``spec.seed``."""
    dev = resolve_device(device)
    cfg = _make_cfg(spec)
    specs = model.mspecs(cfg)
    sim = SimMesh(spec.workers)
    hyper = TrainHyper(lr=spec.lr, momentum=spec.momentum, q_chunk=Q_CHUNK,
                       warmup_steps=20, weight_decay=0.0)

    def build():
        """A new "process": a new compressor and step."""
        comp = PowerSGDCompressor(rank=2)
        step, _ = make_sim_train_step(cfg, sim, hyper, compressor=comp,
                                      device=dev)
        return step, comp

    data = lm_data(spec)
    eval_data = eval_set(data, spec, 8, dev)

    def batch_for(i):
        toks = torch.tensor(data.sample(spec.batch_per_worker * spec.workers,
                                        spec.seq, step=i), device=dev)
        return sim.shard({"tokens": toks[:, :-1], "labels": toks[:, 1:]})

    # kill at 80 % of the horizon: early enough to resume, late enough that
    # the degraded restores cannot wash out before the end
    steps, mid = spec.steps, (4 * spec.steps) // 5
    save_times, ckpt_bytes = [], 0

    def run(step_fn, params, ef, start, stop, save_every=0):
        nonlocal ckpt_bytes
        losses = []
        for i in range(start, stop):
            params, ef, met = step_fn(params, ef, batch_for(i), seed=spec.seed)
            losses.append(met["lm_loss"].item())
            if save_every and ((i + 1) % save_every == 0 or i + 1 == mid):
                sync(dev)
                t0 = time.perf_counter()
                p, e = canonicalize_sim(sim, params, ef)
                path = save_train_state(
                    ckpt_dir, TrainState(params=p, ef=e, seed=spec.seed,
                                         data_step=e.step), keep=1000)
                save_times.append(time.perf_counter() - t0)
                ckpt_bytes = os.path.getsize(path)
        return params, ef, losses

    step_fn, comp = build()
    params, ef = sim_start(cfg, sim, hyper, dev, compressor=comp, seed=spec.seed)
    t0 = time.perf_counter()
    params, ef, ref_losses = run(step_fn, params, ef, 0, steps,
                                 save_every=ckpt_every)
    train_wall = time.perf_counter() - t0
    ref_eval = eval_loss(params, cfg, eval_data)

    def resume(mutate=None):
        """A new "process" restores the step-``mid`` envelope, optionally
        degrades one piece of it, and continues to the horizon."""
        step_fn, comp = build()
        p0, e0 = sim_start(cfg, sim, hyper, dev, compressor=comp,
                           seed=spec.seed)
        template = TrainState(*canonicalize_sim(sim, p0, e0), seed=spec.seed)
        t0 = time.perf_counter()
        state, _ = restore_train_state(ckpt_dir, template, step=mid)
        restore_s = time.perf_counter() - t0
        ef = state.ef if mutate is None else mutate(state.ef)
        params, ef = replicate_sim(sim, state.params, ef)
        params, _, tail = run(step_fn, params, ef, mid, steps)
        return eval_loss(params, cfg, eval_data), tail, restore_s

    full_eval, full_tail, restore_s = resume()

    def drop_ef(ef):
        return dataclasses.replace(ef, error=tree.map(torch.zeros_like, ef.error))

    shapes = tree.map(lambda x: torch.zeros(x.shape, dtype=x.dtype), params)

    def drop_warm(ef):
        comp = PowerSGDCompressor(rank=2).init(
            shapes, specs, torch.Generator().manual_seed(999))
        return error_feedback.replace_comp(ef, _to(comp, dev))

    ef_eval, ef_tail, _ = resume(drop_ef)
    warm_eval, warm_tail, _ = resume(drop_warm)

    def spike(tail):
        """The worst excess of the first 5 resumed steps' losses over the
        full restore's: the re-absorption transient."""
        return round(max(a - b for a, b in zip(tail[:5], full_tail[:5])), 4)

    return [
        {"mode": "uninterrupted", "eval_loss": round(ref_eval, 4),
         "final_loss_hex": float(ref_losses[-1]).hex()},
        {"mode": "resume_full", "eval_loss": round(full_eval, 4),
         "bitexact_vs_uninterrupted": full_tail == ref_losses[mid:],
         "final_loss_hex": float(full_tail[-1]).hex()},
        {"mode": "resume_drop_ef", "eval_loss": round(ef_eval, 4),
         "loss_cost_vs_full": round(ef_eval - full_eval, 4),
         "post_resume_loss_spike": spike(ef_tail)},
        {"mode": "resume_drop_warm_start", "eval_loss": round(warm_eval, 4),
         "loss_cost_vs_full": round(warm_eval - full_eval, 4),
         "post_resume_loss_spike": spike(warm_tail)},
        {"mode": "checkpoint_cost",
         "workers": spec.workers, "steps": steps, "ckpt_every": ckpt_every,
         "ckpt_mb": round(ckpt_bytes / 1e6, 3),
         "save_ms_mean": round(1e3 * float(np.mean(save_times)), 2),
         "restore_ms": round(1e3 * restore_s, 2),
         "save_overhead_pct_of_train":
             round(100 * sum(save_times) / train_wall, 3)},
    ]


# ---------------------------------------------------------------------------
# communication model (the paper's Appendix B cluster: 10 Gbit/s Ethernet)
# ---------------------------------------------------------------------------

BW = {name: bw for name, (_, bw) in autotune.BACKENDS.items()}
LATENCY = {name: alpha for name, (alpha, _) in autotune.BACKENDS.items()}


def comm_time(bytes_per_worker: float, workers: int, allreduce: bool,
              backend: str = "nccl_10gbit") -> float:
    """Modeled seconds to aggregate one step's messages among ``workers``.

    ``bytes_per_worker`` is the payload one worker contributes.  An
    all-reduce costs ``2(W−1)/W · bytes / bw`` plus ``⌈log2 W⌉`` latencies;
    an all-gather ``(W−1) · bytes / bw`` plus ``W−1`` latencies, since every
    worker receives every other worker's payload.
    """
    bw = BW[backend]
    lat = LATENCY[backend]
    if workers <= 1:
        return 0.0
    if allreduce:
        rounds = math.ceil(math.log2(workers))
        return 2 * (workers - 1) / workers * bytes_per_worker / bw + lat * rounds
    return (workers - 1) * bytes_per_worker / bw + lat * (workers - 1)


def broadcast_time(bytes_root: float, workers: int,
                   backend: str = "nccl_10gbit") -> float:
    """Modeled seconds for rank 0 to broadcast ``bytes_root`` to W−1
    receivers (scatter + all-gather: half an all-reduce's bandwidth term,
    the same ``⌈log2 W⌉`` latencies)."""
    if workers <= 1:
        return 0.0
    rounds = math.ceil(math.log2(workers))
    return ((workers - 1) / workers * bytes_root / BW[backend]
            + LATENCY[backend] * rounds)


def comm_time_from_stats(stats, workers: int, backend: str = "nccl_10gbit", *,
                         overlap_compute_s: float = 0.0) -> float:
    """Modeled seconds of one recorded step's gradient exchange: the α-β
    model applied to each collective of a
    :class:`~repro_torch.core.dist.CollectiveStats` trace at its own wire
    bytes (``size · itemsize + overhead``: the fractional int4 itemsize and
    the scale sidecar included), :func:`broadcast_time` for a
    ``"broadcast"`` record and :func:`comm_time` otherwise (a reduce flat
    in W, a gather paying the (W−1)-fold receive traffic).

    ``overlap_compute_s`` models a pipelined (``staleness="one_step"``)
    step whose exchange runs beside the next step's compute: the result
    is then the exposed remainder, ``max(0, total − overlap)``."""
    total = 0.0
    for size, itemsize, kind, overhead in zip(stats.sizes, stats.itemsizes,
                                              stats.kinds, stats.overheads):
        nbytes = size * itemsize + overhead
        if kind == "broadcast":
            total += broadcast_time(nbytes, workers, backend)
        else:
            total += comm_time(nbytes, workers, kind == "reduce", backend)
    return max(0.0, total - overlap_compute_s)


def measure_coding_time(compressor: Compressor, params, specs,
                        iters: int = 5, *, device=None) -> float:
    """Measured seconds of one compress + aggregate + decompress step of
    ``compressor`` on ``params``' shapes (gradients of 0.01 everywhere), on
    ``device`` (the CUDA card unless it says otherwise): one warm-up call,
    then ``iters`` calls with seeds ``RUN_SEED + i`` on the host clock, the
    device synchronized before and after.  The calls run eagerly, so the
    time includes the host's work around each kernel."""
    dev = resolve_device(device)
    params = tree.map(lambda x: x.to(dev), params)
    state = compressor.init(params, specs, torch.Generator(dev).manual_seed(0))
    grads = tree.map(lambda p: torch.ones_like(p) * 0.01, params)
    compressor.step(grads, state, specs, seed=RUN_SEED)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        compressor.step(grads, state, specs, seed=RUN_SEED + i)
    sync(dev)
    return (time.perf_counter() - t0) / iters


def bytes_per_epoch_mb(bits_per_step: int, steps_per_epoch: int) -> float:
    return bits_per_step / 8 / 1e6 * steps_per_epoch
