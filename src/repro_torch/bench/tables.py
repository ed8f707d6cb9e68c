"""One driver per paper table and figure (port of Tables 1–7, Fig. 3,
Appendix D and the profiles ``adaptive_rank_profile``, ``resume_overhead``,
``comm_profile``, ``zoo_transport_profile``, ``sync_mode_profile`` and
``overlap_profile`` of the JAX package's ``benchmarks/tables.py``): the
benchmark LM, for Table 7 the paper's LSTM scaled down, and for the
profiles' measured arms reduced Llama-3-8B.

Each driver returns a list of row dicts with the JAX package's keys, in
its order.  The training drivers and ``resume_overhead`` take an
:class:`~repro_torch.bench.common.LMSpec` (Table 7 its number of steps);
Table 5, Fig. 3 and the other profiles take a parameter tree and its
matrix specs.
Every driver runs on the CUDA card unless ``device`` says otherwise.
The profiles' traces record one step of a compressor on that tree under
:class:`~repro_torch.core.dist.CollectiveStats`.

    from repro_torch.bench import tables
    from repro_torch.bench.common import LMSpec
    tables.table3_rank_sweep(LMSpec(steps=10), device="cpu")

``data_per_epoch_mb`` counts the payload of :data:`STEPS_PER_EPOCH` steps;
``modeled_comm_ms_w16`` and ``exchange_ms`` come from the α-β model of the
paper's 10 Gbit/s cluster (:func:`~repro_torch.bench.common.comm_time`), not
from a measurement.  ``coding_ms`` is measured on ``device``, eagerly.  A
scheme that diverges gives an ``eval_loss`` of NaN (Unbiased Rank-K on this
LM at lr 0.1), as in the JAX package.  ``sync_mode_profile``'s
``measured_step_ms_mesh4x1`` is the host time of a step of 4 gloo
processes on the CPU, never a time of the card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch import tree
from repro_torch.bench.common import (Q_CHUNK, LMSpec, _make_cfg, _to,
                                      bytes_per_epoch_mb, comm_time,
                                      comm_time_from_stats, eval_loss, eval_set,
                                      lm_data, measure_coding_time, probe_bits,
                                      resume_profile, sim_start, train_lm)
from repro_torch.configs.base import get_config
from repro_torch.core import autotune, error_feedback, powersgd
from repro_torch.core.compressors import PowerSGDCompressor, make_compressor
from repro_torch.core.dist import CollectiveStats, MeshCtx
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.train import (TrainHyper, grad_with_aux, local_grads,
                                      make_sim_train_step, resolve_device)
from repro_torch.models import lstm, model
from repro_torch.optim import sgd

STEPS_PER_EPOCH = 40  # epoch definition for the synthetic task
# Table 7's LSTM: the paper's, scaled down (tied embeddings need embed == hidden)
TABLE7_CFG = lstm.LSTMConfig(vocab=256, embed=64, hidden=64, layers=3,
                             init_scale=0.15)


def _fmt(result, rank=None, backend="nccl_10gbit", workers=16):
    mb = bytes_per_epoch_mb(result["bits_per_worker_per_step"], STEPS_PER_EPOCH)
    ct = comm_time(result["bits_per_worker_per_step"] / 8, workers,
                   result["allreduce"], backend)
    return {
        "algorithm": result["compressor"] + (f"_rank{rank}" if rank else ""),
        "eval_loss": round(result["eval_loss"], 4),
        "data_per_epoch_mb": round(mb, 3),
        "allreduce": result["allreduce"],
        "modeled_comm_ms_w16": round(ct * 1e3, 3),
    }


def table1_error_feedback(spec: LMSpec, *, device=None) -> list:
    """Table 1: biased rank-r + EF against the unbiased rank-r operator."""
    rows = [_fmt(train_lm(make_compressor("identity"), spec, device=device))]
    for r in (1, 2):
        rows.append(_fmt(train_lm(make_compressor("powersgd", rank=r), spec,
                                  device=device), r))
    for r in (1, 2):
        rows.append(_fmt(train_lm(make_compressor("unbiased_rank_k", rank=r),
                                  spec, device=device), r))
    return rows


def table2_warm_start(spec: LMSpec, *, device=None) -> list:
    """Table 2: warm start against cold start and the best rank-r
    approximation."""
    return [_fmt(train_lm(make_compressor(name, rank=2), spec, device=device), 2)
            for name in ("powersgd_best_approx", "powersgd", "powersgd_cold")]


def table3_rank_sweep(spec: LMSpec, *, device=None) -> list:
    """Table 3: quality against compression over the rank."""
    rows = [_fmt(train_lm(make_compressor("identity"), spec, device=device))]
    for r in (1, 2, 4):
        rows.append(_fmt(train_lm(make_compressor("powersgd", rank=r), spec,
                                  device=device), r))
    return rows


def table4_compressor_zoo(spec: LMSpec, *, device=None) -> list:
    """Table 4: the EF compressor zoo at medium (r = 7-equivalent budget)
    and high (r = 2) compression."""
    rows = [_fmt(train_lm(make_compressor("identity"), spec, device=device))]
    for regime, r in (("medium", 7), ("high", 2)):
        for name in ("powersgd", "random_block", "random_k", "sign_norm", "top_k"):
            # Sign+Norm has a fixed ~32× rate (the paper): medium regime only
            if name == "sign_norm" and regime == "high":
                continue
            row = _fmt(train_lm(make_compressor(name, rank=r), spec,
                                device=device), r)
            row["regime"] = regime
            rows.append(row)
    return rows


def table5_time_breakdown(params, specs, *, device=None) -> list:
    """Table 5: time per step against the number of workers.

    Coding time is measured once per compressor on ``device`` and scaled by
    W for the gather schemes (each worker decodes every payload); the
    gradient exchange is modeled (all-reduce against all-gather).  The
    paper's observation is the scaling shape: the all-gather's decode and
    exchange grow linearly in W, the all-reduce's stay flat."""
    dev = resolve_device(device)
    params = tree.map(lambda x: x.to(dev), params)
    rows = []
    for name, rank in (("identity", None), ("powersgd", 2), ("sign_norm", None)):
        comp = make_compressor(name, rank=rank or 2)
        coding = measure_coding_time(comp, params, specs, device=dev)
        bits = probe_bits(comp, params, specs)
        for w in (2, 4, 8, 16):
            exch = comm_time(bits / 8, w, comp.allreduce)
            decode_scale = 1 if comp.allreduce else w
            rows.append({
                "algorithm": name,
                "workers": w,
                "coding_ms": round(coding * 1e3 * decode_scale, 3),
                "exchange_ms": round(exch * 1e3, 3),
                "bits_per_worker": bits,
                "allreduce": comp.allreduce,
            })
    return rows


def table6_other_methods(spec: LMSpec, *, device=None) -> list:
    """Table 6: PowerSGD against Spectral Atomo and Signum."""
    rows = [_fmt(train_lm(make_compressor("identity"), spec, device=device))]
    rows.append(_fmt(train_lm(make_compressor("spectral_atomo", rank=2), spec,
                              device=device), 2))
    rows.append(_signum_row(spec, device=device))
    rows.append(_fmt(train_lm(make_compressor("powersgd", rank=2), spec,
                              device=device), 2))
    return rows


def _signum_row(spec: LMSpec, *, device=None, params=None) -> dict:
    """Signum is an optimizer, not an EF compressor: one device trains on
    the whole batch (every worker's sequences) at ``spec.lr · 1e-3``.
    ``params`` (a tree of tensors, copied) replaces the initial parameters
    :func:`~repro_torch.bench.common.train_lm` draws from ``spec.seed``."""
    dev = resolve_device(device)
    cfg = _make_cfg(spec)
    if params is None:
        params = model.init(cfg, torch.Generator().manual_seed(spec.seed),
                            device="cpu")
    params = _to(params, dev)
    st = sgd.signum_init(params)
    data = lm_data(spec)
    it = data.batches(spec.batch_per_worker * spec.workers, spec.seq)
    for _ in range(spec.steps):
        batch = {k: torch.tensor(v, device=dev) for k, v in next(it).items()}
        grads, _ = local_grads(cfg, params, batch, q_chunk=Q_CHUNK, device=dev)
        params, st = sgd.signum_apply(params, tree.unflatten(params, grads), st,
                                      lr=spec.lr * 1e-3)
    ev = eval_loss(params, cfg, eval_set(data, spec, 8, dev))
    bits = sum(p.numel() for p in tree.leaves(params))  # 1 bit per coordinate
    return {
        "algorithm": "signum",
        "eval_loss": round(ev, 4),
        "data_per_epoch_mb": round(bytes_per_epoch_mb(bits, STEPS_PER_EPOCH), 3),
        "allreduce": False,
        "modeled_comm_ms_w16": round(comm_time(bits / 8, 16, False) * 1e3, 3),
    }


def table7_lstm(spec_steps: int = 120, *, device=None) -> list:
    """Table 7: language modeling with the paper's LSTM, scaled down (vocab
    256, embedding and hidden 64, 3 layers) on order-1 Markov data with 8
    token clusters: one worker, 16 sequences of 48 tokens a step, lr 1.0,
    momentum 0.9, for identity and PowerSGD at ranks 1 and 4.  Each run
    starts from parameters and factors drawn on the CPU from seed 0; the
    perplexity is that of 6 held-out batches of 32."""
    dev = resolve_device(device)
    cfg = TABLE7_CFG
    data = MarkovLM(vocab=cfg.vocab, seed=0, order=1, clusters=8)
    grad = grad_with_aux(lstm.loss_fn)

    def run(comp_name, rank):
        gen = torch.Generator().manual_seed(0)
        params = lstm.init(cfg, gen, device="cpu")
        specs = lstm.mspecs(params)
        comp = make_compressor(comp_name, rank=rank)
        state = error_feedback.init_state(comp, params, specs,
                                          generator=gen).to(dev)
        params = _to(params, dev)
        it = data.batches(16, 48)
        for _ in range(spec_steps):
            batch = {k: torch.tensor(v, device=dev) for k, v in next(it).items()}
            grads, _ = grad(params, batch, cfg)
            params, state, aux = error_feedback.apply_updates(
                comp, params, grads, state, specs, lr=1.0, momentum=0.9, seed=0)
        evs = []
        with torch.no_grad():
            for i in range(6):
                b = torch.tensor(data.sample(32, 48, step=20_000 + i), device=dev)
                _, met = lstm.loss_fn(params, {"tokens": b[:, :-1],
                                               "labels": b[:, 1:]}, cfg)
                evs.append(met["loss"].item())
        ev = float(np.mean(evs))
        return {
            "algorithm": comp_name + (f"_rank{rank}" if comp_name != "identity"
                                      else ""),
            "eval_ppl": round(math.exp(ev), 2),
            "data_per_epoch_mb": round(
                bytes_per_epoch_mb(aux["bits_per_worker"], STEPS_PER_EPOCH), 3),
        }

    return [run("identity", 2), run("powersgd", 1), run("powersgd", 4)]


def fig3_scaling(params, specs, *, device=None) -> list:
    """Fig. 3: modeled time per step against the number of workers for both
    backends: a nominal 20 ms of forward and backward per batch plus the
    α-β exchange (PowerSGD ≈ flat, the gather-based schemes degrade).  Only
    PowerSGD's payload is probed on ``device``; the rest is shapes."""
    dev = resolve_device(device)
    total_bits = sum(p.numel() * 32 for p in tree.leaves(params))
    compute_ms = 20.0
    psgd_bits = probe_bits(make_compressor("powersgd", rank=2),
                           tree.map(lambda x: x.to(dev), params), specs)
    rows = []
    for backend in ("nccl_10gbit", "gloo_10gbit"):
        for name, bits, allreduce in (("sgd", total_bits, True),
                                      ("powersgd_rank2", psgd_bits, True),
                                      ("signum", total_bits // 32, False)):
            for w in (1, 2, 4, 8, 16, 32):
                t = compute_ms + comm_time(bits / 8, w, allreduce, backend) * 1e3
                rows.append({
                    "backend": backend, "algorithm": name, "workers": w,
                    "modeled_step_ms": round(t, 3),
                    "speedup_vs_1worker": round(w * compute_ms / t, 3),
                })
    return rows


def appendixD_transformer(spec: LMSpec, *, device=None) -> list:
    """Appendix D: the PowerSGD rank sweep on the benchmark transformer LM
    (the paper needed rank 32 on WikiText-103; the claim here is the
    monotone rank → quality trend and the compression ratios)."""
    rows = [_fmt(train_lm(make_compressor("identity"), spec, device=device))]
    for r in (4, 8, 16, 32):
        rows.append(_fmt(train_lm(make_compressor("powersgd", rank=r), spec,
                                  device=device), r))
    return rows


def adaptive_rank_profile(spec: LMSpec, *, device=None) -> list:
    """Beyond the paper: adaptive rank schedules against fixed ranks on the
    benchmark LM.  (a) Fixed ranks 1, 2 and 4; (b) the growth staircase
    1 → 2 → 4 and (c) the decay staircase 4 → 2 → 1, switching at a third
    and two thirds of the run; (d) the residual-energy schedule (ranks 1–8
    from 4, decided every eighth of the run); (e) the α-β autotuner's
    per-bucket ranks under half of rank 4's bits, priced on the paper's
    10 Gbit/s NCCL cluster (:func:`repro_torch.core.autotune.autotune`
    over the LM's parameter shapes, installed by ``apply_plan``).  Rows
    give ``eval_loss``, the cumulative compressed floats in millions, the
    rank history (``rank@step|…``), the savings against fixed rank 4 and,
    for (e), the plan's bucket ranks (``n x m:r…``), wire dtype and
    modeled exchange ms."""
    s = spec.steps

    def row(label, result, extra=None):
        r = {
            "schedule": label,
            "eval_loss": round(result["eval_loss"], 4),
            "compressed_mfloats_total":
                round(result["compressed_floats_total"] / 1e6, 4),
        }
        if "rank_history" in result:
            r["rank_history"] = "|".join(
                f"{rk}@{st}" for st, rk in result["rank_history"])
        r.update(extra or {})
        return r

    rows = []
    fixed = {}
    for r in (1, 2, 4):
        res = train_lm(make_compressor("powersgd", rank=r), spec, device=device)
        fixed[r] = res
        rows.append(row(f"fixed_rank{r}", res))
    base_floats = fixed[4]["compressed_floats_total"]

    def savings(res):
        return {"savings_vs_fixed_rank4": round(
            1 - res["compressed_floats_total"] / base_floats, 4)}

    for label, stair in (
            ("staircase_up_1_2_4", powersgd.StaircaseRank(
                milestones=((0, 1), (s // 3, 2), (2 * s // 3, 4)))),
            ("staircase_down_4_2_1", powersgd.StaircaseRank(
                milestones=((0, 4), (s // 3, 2), (2 * s // 3, 1))))):
        comp = PowerSGDCompressor(rank_schedule=stair)
        res = train_lm(comp, spec, controller=comp.controller(), device=device)
        rows.append(row(label, res, savings(res)))

    comp = PowerSGDCompressor(
        rank_schedule=f"residual:min=1,max=8,init=4,every={max(s // 8, 1)}")
    res = train_lm(comp, spec, controller=comp.controller(), device=device)
    rows.append(row("residual_energy", res, savings(res)))

    cfg = _make_cfg(spec)
    shapes, mspecs = model.init(cfg, None, device="meta"), model.mspecs(cfg)
    comp4 = powersgd.compressed_floats_total(shapes, mspecs, 4)
    plan = autotune.autotune(
        shapes, mspecs, bits_budget=comp4 * 32 // 2, workers=spec.workers,
        hw=autotune.HardwareModel.from_backend("nccl_10gbit"))
    comp = autotune.make_tuned_compressor(plan)
    res = train_lm(comp, spec, device=device, init_comp_transform=lambda cs:
                   autotune.apply_plan(plan, cs, shapes, mspecs))
    rows.append(row("autotuned_budget50", res, {
        **savings(res),
        "bucket_ranks": "|".join(
            f"{d.n}x{d.m}:r{d.rank}" for d in plan.decisions),
        "wire_dtype": plan.wire_dtype,
        "predicted_comm_ms": round(plan.predicted_comm_s * 1e3, 3)}))
    return rows


# ---------------------------------------------------------------------------
# the profiles of the beyond-paper features
# ---------------------------------------------------------------------------

def resume_overhead(spec: LMSpec, ckpt_every: int = 20, *, device=None) -> list:
    """Beyond the paper: what a full-state checkpoint costs (envelope MB,
    save and restore ms, the saves' share of the training at a
    ``ckpt_every`` cadence), that a full-state resume is bit-exact, and
    what dropping the error buffers or the warm-start factors on a restore
    costs in final loss: :func:`repro_torch.bench.common.resume_profile`
    on ``device``, its envelopes in a temporary directory."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        return resume_profile(spec, d, ckpt_every=ckpt_every, device=dev)


def _trace(comp, params, specs, grads, make_ctx=None):
    """One step of ``comp`` on ``grads`` from a fresh state (factors drawn
    from seed 0 on the parameters' device) under ``make_ctx(stats)``
    (default: a context without data axes); returns the step's output and
    the :class:`~repro_torch.core.dist.CollectiveStats` it recorded."""
    stats = CollectiveStats()
    dev = tree.leaves(params)[0].device
    ctx = MeshCtx(stats=stats) if make_ctx is None else make_ctx(stats)
    out = comp.step(grads, comp.init(params, specs,
                                     torch.Generator(dev).manual_seed(0)),
                    specs, ctx=ctx, seed=0)
    return out, stats


def _on(params, device):
    """``params`` on ``device`` (the CUDA card unless it says otherwise)."""
    dev = resolve_device(device)
    return tree.map(lambda x: x.to(dev), params)


def _grads(params):
    """Gradients of 0.01 shaped like ``params``, the profiles' traced
    input."""
    return tree.map(lambda p: torch.ones_like(p) * 0.01, params)


def comm_profile(params, specs, *, device=None) -> list:
    """Beyond the paper: the data-axis collectives one rank-2 PowerSGD step
    issues on ``params`` (zero gradients) and the bytes each carries, per
    leaf (``bucketing="off"``, 2 a weight matrix) against bucketed (2
    flat collectives a step): the latency-against-bandwidth trade of the
    bucketed engine."""
    params = _on(params, device)
    grads = tree.map(torch.zeros_like, params)
    rows = []
    for mode, label in (("off", "per_leaf"), ("auto", "bucketed")):
        _, stats = _trace(PowerSGDCompressor(rank=2, bucketing=mode), params,
                          specs, grads)
        sizes_b = stats.bytes_per_collective()
        rows.append({
            "engine": label,
            "collectives_per_step": stats.data_collectives,
            "total_mb_per_step": round(sum(sizes_b) / 2**20, 4),
            "mean_bytes_per_collective": int(np.mean(sizes_b)) if sizes_b else 0,
            "max_bytes_per_collective": max(sizes_b) if sizes_b else 0,
            "min_bytes_per_collective": min(sizes_b) if sizes_b else 0,
        })
    return rows


ZOO = ("identity", "powersgd", "powersgd_per_leaf", "unbiased_rank_k",
       "random_block", "random_k", "sign_norm", "top_k", "spectral_atomo",
       "exact_rank_k")
QUANT_ZOO = ("powersgd", "sign_norm", "top_k")   # traced on every QUANT_WIRES
QUANT_WIRES = ("float32", "int8", "int4")


def zoo_trace_rows(params, specs, workers: int = 16, *, device=None) -> list:
    """The trace arm of :func:`zoo_transport_profile`: one row a
    (compressor, wire), each step traced on ``params`` (gradients of 0.01)
    on ``device``: every registry name at ``wire_dtype="auto"``, then
    PowerSGD, Sign+Norm and Top-K on the float32, int8 and int4 wires with
    their wire bytes against float32's."""
    params = _on(params, device)
    grads = _grads(params)
    gather_kb = "gather_kb_per_step_w%d" % workers

    def trace_row(name: str, wire_dtype: str) -> dict:
        kw = {} if wire_dtype == "auto" else {"wire_dtype": wire_dtype}
        comp = make_compressor(name, rank=2, **kw)
        out, stats = _trace(comp, params, specs, grads)
        wire = list(zip(stats.sizes, stats.itemsizes, stats.kinds,
                        stats.overheads))
        reduce_b = sum(s * i + o for s, i, k, o in wire if k == "reduce")
        gather_b = sum(s * i + o for s, i, k, o in wire if k == "gather")
        return {
            "algorithm": name,
            "wire_dtype": wire_dtype,
            "wire_mode": comp.wire_mode,
            "collectives_per_step": stats.data_collectives,
            "reduce_collectives": stats.reduce_collectives,
            "gather_collectives": stats.gather_collectives,
            "reduce_kb_per_step": round(reduce_b / 1024, 2),
            gather_kb: round(gather_b * workers / 1024, 2),
            "payload_bits_per_worker": int(out.bits_per_worker),
            "modeled_comm_ms_w%d" % workers:
                round(comm_time_from_stats(stats, workers) * 1e3, 3),
        }

    rows = [trace_row(name, "auto") for name in ZOO]
    for name in QUANT_ZOO:
        base_kb = None
        for wd in QUANT_WIRES:
            row = trace_row(name, wd)
            wire_kb = row["reduce_kb_per_step"] + row[gather_kb]
            if wd == "float32":
                base_kb = wire_kb
            row["wire_bytes_ratio_vs_float32"] = round(base_kb / wire_kb, 2)
            rows.append(row)
    return rows


def zoo_transport_profile(params, specs, workers: int = 16, *,
                          device=None) -> list:
    """Beyond the paper: the transport of every compressor of the zoo.

    :func:`zoo_trace_rows`: for each registry name at
    ``wire_dtype="auto"``, the fused data-axis collectives one step issues
    (reduce against gather), the wire KB each pattern carries (a gather's
    times ``workers``, what a worker's link receives) and the modeled
    exchange ms at ``workers``
    (:func:`~repro_torch.bench.common.comm_time_from_stats`); then
    PowerSGD, Sign+Norm and Top-K on the float32, int8 and int4 wires,
    each wire's bytes against float32's and, for PowerSGD, the mean loss
    of the last 5 of 60 steps of reduced Llama-3-8B at W = 4
    (:func:`_wire_loss_run`) on ``device``.

    Declared divergence (ROADMAP C1): the port keeps Top-K's and
    Sign+Norm's integer parts in exact chunks of their own, so on the
    float32 wire both send one more gather than the JAX package's (which
    casts the integers to float32), and Sign+Norm's signs travel as int8."""
    dev = resolve_device(device)
    rows = zoo_trace_rows(params, specs, workers, device=dev)
    loss_steps = 60
    for row in rows[len(ZOO):]:
        if row["algorithm"] == "powersgd":
            losses = _wire_loss_run(row["wire_dtype"], workers=4,
                                    steps=loss_steps, device=dev)
            row["loss_workers"] = 4
            row["loss_steps"] = loss_steps
            row["final5_loss"] = round(float(np.mean(losses[-5:])), 4)
    return rows


def _sim_losses(hyper: TrainHyper, workers: int, steps: int, dev,
                weights_for_step=None, params=None, comp_state=None) -> list:
    """Each step's ``lm_loss`` of ``steps`` steps of
    :func:`~repro_torch.launch.train.make_sim_train_step` on reduced
    Llama-3-8B at ``workers`` workers (batches of 8 × 64 ``MarkovLM``
    tokens), from the state :func:`~repro_torch.bench.common.sim_start`
    draws from seed 0 (``params``/``comp_state`` replace its parts)."""
    cfg = get_config("llama3-8b", reduced=True)
    sim = SimMesh(workers)
    step_fn, _ = make_sim_train_step(cfg, sim, hyper, device=dev)
    params, ef = sim_start(cfg, sim, hyper, dev, params=params,
                           comp_state=comp_state)
    it = MarkovLM(vocab=cfg.vocab_size, seed=0, order=1, clusters=8).batches(8, 64)
    losses = []
    for i in range(steps):
        b = sim.shard({k: torch.tensor(v, device=dev) for k, v in next(it).items()})
        w = weights_for_step(i) if weights_for_step is not None else None
        params, ef, met = step_fn(params, ef, b, seed=0, weights=w)
        losses.append(met["lm_loss"].item())
    return losses


def _wire_loss_run(wire_dtype: str, workers: int, steps: int, *, device=None,
                   params=None, comp_state=None) -> list:
    """The measured arm of :func:`zoo_transport_profile`: each step's
    ``lm_loss`` under the default rank-2 PowerSGD on the ``wire_dtype``
    wire (lr 0.05, 5 warm-up steps, momentum 0.9, weight decay 1e-4)."""
    hyper = TrainHyper(lr=0.05, q_chunk=32, warmup_steps=5,
                       wire_dtype=wire_dtype)
    return _sim_losses(hyper, workers, steps, resolve_device(device),
                       params=params, comp_state=comp_state)


SYNC_MEASURE_TIMEOUT_S = 900


def _sync_measure(steps: int = 10) -> dict:
    """``{sync_mode: mean step seconds}`` of :mod:`repro_torch.bench.
    sync_measure` (4 gloo processes on the CPU), run in a subprocess; empty,
    with the reason on stderr, where it fails."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": src + (os.pathsep + path if path else "")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.sync_measure",
         "--steps", str(steps)],
        capture_output=True, text=True, timeout=SYNC_MEASURE_TIMEOUT_S, env=env)
    measured = {}
    for line in proc.stdout.splitlines():
        if line.startswith("SYNC_MEASURE_JSON="):
            measured = json.loads(line.split("=", 1)[1])
    if not measured:
        print(f"sync_mode_profile: gloo measurement failed\n{proc.stderr}",
              file=sys.stderr)
    return measured


def sync_mode_profile(params, specs, workers: int = 16, *, device=None) -> list:
    """Beyond the paper: what replica-deterministic aggregation costs.

    For each ``sync_mode`` (:func:`sync_mode_rows`), the rank-2 PowerSGD
    step's trace on a ``SimMesh(4)`` on ``device`` (reduce and broadcast
    collectives and their KB), the modeled exchange ms at ``workers`` and
    its overhead over the allreduce mode, and ``measured_step_ms_mesh4x1``:
    the mean host ms of steps 3–9 of
    :func:`~repro_torch.launch.train.make_train_step` on reduced
    Llama-3-8B, 4 gloo processes on the CPU (:func:`_sync_measure`; the JAX
    package measures a (4, 1) mesh of CPU devices).  That column is a CPU
    time, never a time of the card; ``None`` where the measurement
    fails."""
    dev = resolve_device(device)
    return sync_mode_rows(params, specs, _sync_measure(), workers, device=dev)


def sync_mode_rows(params, specs, measured: dict, workers: int = 16, *,
                   device=None) -> list:
    """:func:`sync_mode_profile`'s rows with ``measured`` (``{mode:
    seconds}``; a missing mode gives ``None``) as the measured column."""
    params = _on(params, device)
    grads = _grads(params)
    sim = SimMesh(4)
    stacked = tree.map(lambda g: sim.replicate(g).contiguous(), grads)
    rows = []
    for mode in ("allreduce", "broadcast"):
        _, stats = _trace(make_compressor("powersgd", rank=2), params, specs,
                          stacked, lambda st: sim.ctx(stats=st, sync_mode=mode))
        wire = list(zip(stats.sizes, stats.itemsizes, stats.kinds))
        rows.append({
            "sync_mode": mode,
            "reduce_collectives": stats.reduce_collectives,
            "broadcast_collectives": stats.broadcast_collectives,
            "reduce_kb_per_step": round(
                sum(s * i for s, i, k in wire if k == "reduce") / 1024, 2),
            "broadcast_kb_per_step": round(
                sum(s * i for s, i, k in wire if k == "broadcast") / 1024, 2),
            "modeled_comm_ms_w%d" % workers:
                round(comm_time_from_stats(stats, workers) * 1e3, 3),
            "measured_step_ms_mesh4x1":
                round(measured[mode] * 1e3, 2) if mode in measured else None,
        })
    base = rows[0]["modeled_comm_ms_w%d" % workers]
    for row in rows:
        row["modeled_overhead_pct_w%d" % workers] = round(
            100.0 * (row["modeled_comm_ms_w%d" % workers] - base) / base, 2)
    return rows


def _stale_loss_run(staleness: str, workers: int, steps: int,
                    weights_for_step=None, *, device=None, params=None,
                    comp_state=None) -> list:
    """The measured arm of :func:`overlap_profile`: each step's ``lm_loss``
    under ``staleness`` and the scenario weights ``weights_for_step(i)``.
    Both arms train at one operating point where both are stable: a
    one-step delay halves the heavy ball's stability region, so lr 0.05
    without momentum or weight decay."""
    hyper = TrainHyper(lr=0.05, momentum=0.0, q_chunk=32, warmup_steps=5,
                       weight_decay=0.0, staleness=staleness)
    return _sim_losses(hyper, workers, steps, resolve_device(device),
                       weights_for_step, params, comp_state)


def overlap_modeled_rows(params, specs, *, device=None) -> list:
    """The modeled arm of :func:`overlap_profile`: the rank-2 PowerSGD
    wire trace (``pipeline=True``) on ``device``, priced by the α-β model
    for both backends at W = 1, 4, 8 beside a nominal 20 ms of compute."""
    params = _on(params, device)
    grads = _grads(params)
    _, stats = _trace(PowerSGDCompressor(rank=2, pipeline=True), params, specs,
                      grads)
    compute_ms = 20.0  # nominal constant forward and backward per batch
    rows = []
    for backend in ("nccl_10gbit", "gloo_10gbit"):
        for w in (1, 4, 8):
            comm_s = comm_time_from_stats(stats, w, backend)
            exposed_s = comm_time_from_stats(
                stats, w, backend, overlap_compute_s=compute_ms / 1e3)
            sync_ms = compute_ms + comm_s * 1e3
            stale_ms = compute_ms + exposed_s * 1e3
            rows.append({
                "arm": "modeled", "backend": backend, "workers": w,
                "modeled_comm_ms": round(comm_s * 1e3, 3),
                "exposed_comm_ms": round(exposed_s * 1e3, 3),
                "sync_step_ms": round(sync_ms, 3),
                "stale_step_ms": round(stale_ms, 3),
                "hidden_comm_pct": round(
                    100.0 * (comm_s - exposed_s) / comm_s, 2)
                    if comm_s > 0 else 100.0,
                "step_speedup_pct": round(
                    100.0 * (sync_ms - stale_ms) / sync_ms, 2),
            })
    return rows


OVERLAP_WORKERS = 4


def drop_rotating(step: int) -> np.ndarray:
    """Scenario weights of step ``step``: worker ``step mod W`` dropped."""
    w = np.ones((OVERLAP_WORKERS,), np.float32)
    w[step % OVERLAP_WORKERS] = 0.0
    return w


def straggler(step: int) -> np.ndarray:
    """Scenario weights of step ``step``: the last worker misses every
    other step."""
    w = np.ones((OVERLAP_WORKERS,), np.float32)
    if step % 2 == 1:
        w[-1] = 0.0
    return w


def overlap_profile(params, specs, steps: int = 80, *, device=None) -> list:
    """Beyond the paper: what the one-step-stale pipeline buys and costs.

    Modeled arm (:func:`overlap_modeled_rows`): the synchronous step
    serializes compute and exchange, the stale one hides the exchange
    behind the next step's compute (``hidden_comm_pct``).  Measured arm:
    the first and last 5 losses of ``steps`` steps of
    :func:`_stale_loss_run` on ``device``, stale against synchronous,
    clean, with a rotating dropped worker (:func:`drop_rotating`) and with
    a straggler every other step (:func:`straggler`)."""
    dev = resolve_device(device)
    rows = overlap_modeled_rows(params, specs, device=dev)
    for scenario, weights in (("clean", None), ("dropout", drop_rotating),
                              ("straggler", straggler)):
        final = {}
        for staleness in ("none", "one_step"):
            losses = _stale_loss_run(staleness, OVERLAP_WORKERS, steps, weights,
                                     device=dev)
            final[staleness] = float(np.mean(losses[-5:]))
            rows.append({
                "arm": "measured_simmesh", "scenario": scenario,
                "staleness": staleness, "workers": OVERLAP_WORKERS,
                "steps": steps,
                "first5_loss": round(float(np.mean(losses[:5])), 4),
                "final5_loss": round(final[staleness], 4),
            })
        rows[-1]["stale_minus_sync_final_loss"] = round(
            final["one_step"] - final["none"], 4)
    return rows
