"""One driver per paper table and figure (port of Tables 1–7, Fig. 3,
Appendix D and ``adaptive_rank_profile`` of the JAX package's
``benchmarks/tables.py``): the benchmark LM, and for Table 7 the paper's
LSTM scaled down.

Each driver returns a list of row dicts with the JAX package's keys, in
its order.  The training drivers take an :class:`~repro_torch.bench.common.
LMSpec` (Table 7 its number of steps); Table 5 and Fig. 3 take a parameter
tree and its matrix specs.
Every driver runs on the CUDA card unless ``device`` says otherwise.

    from repro_torch.bench import tables
    from repro_torch.bench.common import LMSpec
    tables.table3_rank_sweep(LMSpec(steps=10), device="cpu")

``data_per_epoch_mb`` counts the payload of :data:`STEPS_PER_EPOCH` steps;
``modeled_comm_ms_w16`` and ``exchange_ms`` come from the α-β model of the
paper's 10 Gbit/s cluster (:func:`~repro_torch.bench.common.comm_time`), not
from a measurement.  ``coding_ms`` is measured on ``device``, eagerly.  A
scheme that diverges gives an ``eval_loss`` of NaN (Unbiased Rank-K on this
LM at lr 0.1), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tree
from repro_torch.bench.common import (Q_CHUNK, LMSpec, _make_cfg, _to,
                                      bytes_per_epoch_mb, comm_time, eval_loss,
                                      eval_set, lm_data, measure_coding_time,
                                      probe_bits, train_lm)
from repro_torch.core import autotune, error_feedback, powersgd
from repro_torch.core.compressors import PowerSGDCompressor, make_compressor
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.train import grad_with_aux, local_grads, resolve_device
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
