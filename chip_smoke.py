#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build   — compile ``src/repro_torch/csrc/lowrank.cu`` with nvcc for
             sm_90a (into ``build/kernels/``) and load it.
2. kernels — at each of the six shape buckets of Llama-3-8B width with 2
             layers (2 simulated workers folded into the batch), hold
             ``lowrank_project`` and ``lowrank_backproject`` against their
             plain PyTorch versions and time kernel, plain version, one
             ``torch.bmm`` of the same product, and the memory-bandwidth
             bound.  Also ranks 1, 4, 32 at one shape and a ragged 2-D input.
3. parity  — 3 training steps of reduced Llama-3-8B on the card (kernels)
             against the same steps on the CPU (plain versions).
4. train   — 5 EF-PowerSGD steps of the full-width 2-layer Llama-3-8B with
             2 simulated workers (the port's main path); every kernel must
             launch once per bucket per step.
5. profile — one more step under ``torch.profiler``: device time by kernel
             class (GEMMs, the port's kernels, the rest) against the step.

Float32 products run in full float32: TF32 is switched off for matmuls and
cuDNN.  The last two lines of output are the ``{"kernels": [...]}`` summary
and ``{"ok": true, ...}``; the card's name and power limit come just before.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# per-element tolerance of a kernel against its plain version, both fp32
# with different summation orders over a reduction of length K:
#   |kernel − plain| ≤ ATOL + RTOL·|plain| + C_DOT·u·√K·√(Σ_k m_k² f_k²)
# (the last term is the probabilistic rounding-error bound of a length-K
# fp32 dot product; u = 2⁻²⁴)
ATOL, RTOL, C_DOT = 1e-4, 1e-5, 8.0
RANK = 2
WORKERS = 2
TRAIN_STEPS = 5
SEQ = 1024

# published peaks (NVIDIA data sheets): HBM bytes/s and fp32 (non-tensor) FLOP/s
CARDS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12)]


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, bw, flops in CARDS:
        if key in name:
            return key, bw, flops
    fail(f"no published peaks for {name!r}; add them to CARDS")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """(kernel<RP,VEC>, registers, spill line) per compiled kernel, from
    nvcc's -Xptxas -v output."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?"
                      r"(backproject_kernel|project_kernel|sum_splits_kernel)"
                      r"(?:ILi(\d+)ELi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)},{m.group(3)}>" if m.group(2) else "")
        elif "spill" in line:
            spills = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(torch, ref, got, plain, m, f, kind):
    """Kernel vs plain version under the stated tolerance; returns max |Δ|."""
    k = m.shape[-2] if kind == "backproject" else m.shape[-1]
    fn = ref.lowrank_backproject if kind == "backproject" else ref.lowrank_project
    spread = fn(m * m, f * f).sqrt()
    tol = ATOL + RTOL * plain.abs() + C_DOT * 2.0 ** -24 * math.sqrt(k) * spread
    err = (got - plain).abs()
    worst = (err / tol).max().item()
    if not torch.isfinite(got).all() or worst > 1.0:
        raise AssertionError(f"{kind} {tuple(m.shape)}: max |Δ| "
                             f"{err.max().item():.3e} exceeds the tolerance "
                             f"({worst:.2f}× of it)")
    return err.max().item(), worst


def kernel_phase(torch, lowrank, ref, shapes, peaks):
    """Hold both kernels against their plain versions at the main path's
    shapes and time them; returns per-kernel totals over the shapes."""
    _, bw, flops = peaks
    gen = torch.Generator("cuda").manual_seed(0)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "max_abs_err": 0.0, "bound_by": set()}
              for k in ("project", "backproject")}
    for b, n, m_ in shapes:
        m = torch.randn((b, n, m_), generator=gen, device="cuda")
        q = torch.randn((b, m_, RANK), generator=gen, device="cuda")
        p = torch.randn((b, n, RANK), generator=gen, device="cuda")
        cases = {
            "project": (lowrank.lowrank_project, ref.lowrank_project, q,
                        lambda: torch.bmm(m, q), (b, n, RANK)),
            "backproject": (lowrank.lowrank_backproject, ref.lowrank_backproject,
                            p, lambda: torch.bmm(m.transpose(1, 2), p),
                            (b, m_, RANK)),
        }
        iters = max(3, min(50, int(2e10 / (4 * b * n * m_))))
        for kind, (kern, plain_fn, f, lib_fn, out_shape) in cases.items():
            got, plain = kern(m, f), plain_fn(m, f)
            err, worst = check_close(torch, ref, got, plain, m, f, kind)
            truth = plain_fn(m.double(), f.double())
            err64 = (got.double() - truth).abs().max().item()
            plain64 = (plain.double() - truth).abs().max().item()
            del truth
            row = {
                "kernel": f"lowrank_{kind}", "shape": [b, n, m_], "rank": RANK,
                "max_abs_err": err, "worst_over_tol": worst,
                "err_vs_fp64": err64, "plain_err_vs_fp64": plain64,
                "kernel_ms": time_ms(torch, lambda: kern(m, f), iters),
                "plain_ms": time_ms(torch, lambda: plain_fn(m, f), iters),
                "library_ms": time_ms(torch, lib_fn, iters),
            }
            nbytes = 4 * (m.numel() + f.numel() + math.prod(out_shape))
            byte_ms = nbytes / bw * 1e3
            op_ms = 2 * m.numel() * RANK / flops * 1e3
            row["bound_ms"] = max(byte_ms, op_ms)
            row["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            print(json.dumps(row), flush=True)
            t = totals[kind]
            t["ms"] += row["kernel_ms"]
            for key in ("plain_ms", "library_ms", "bound_ms"):
                t[key] += row[key]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["bound_by"].add(row["bound_by"])
        del m, q, p, got, plain
        torch.cuda.empty_cache()

    # other ranks at one shape, and a ragged 2-D input (scalar load path)
    for shape, r in [((8, 4096, 4096), 1), ((8, 4096, 4096), 4),
                     ((8, 4096, 4096), 32), ((1000, 1023), 3)]:
        m = torch.randn(shape, generator=gen, device="cuda")
        q = torch.randn(shape[:-2] + (shape[-1], r), generator=gen, device="cuda")
        p = torch.randn(shape[:-2] + (shape[-2], r), generator=gen, device="cuda")
        e1, _ = check_close(torch, ref, lowrank.lowrank_project(m, q),
                            ref.lowrank_project(m, q), m, q, "project")
        e2, _ = check_close(torch, ref, lowrank.lowrank_backproject(m, p),
                            ref.lowrank_backproject(m, p), m, p, "backproject")
        print(json.dumps({"check": "rank", "shape": list(shape), "rank": r,
                          "project_max_abs_err": e1,
                          "backproject_max_abs_err": e2}), flush=True)
        totals["project"]["max_abs_err"] = max(totals["project"]["max_abs_err"], e1)
        totals["backproject"]["max_abs_err"] = max(
            totals["backproject"]["max_abs_err"], e2)
    torch.cuda.synchronize()
    return totals


def parity_phase(torch, mods):
    """Reduced Llama-3-8B, 3 steps, 2 workers: the card (kernels) against the
    CPU (plain versions), from identical parameters and factors."""
    train, llama3_8b, SimMesh, MarkovLM, tree = mods
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(2)
    hyper = train.TrainHyper(q_chunk=64, warmup_steps=2)
    _, init = train.make_sim_train_step(cfg, sim, hyper, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        step, _ = train.make_sim_train_step(cfg, sim, hyper, device=dev)
        params, ef = init(torch.Generator().manual_seed(0))
        move = lambda t: tree.map(lambda x: None if x is None else x.to(dev), t)
        params = move(params)
        ef = dataclasses.replace(ef, error=move(ef.error),
                                 momentum=move(ef.momentum), comp=move(ef.comp))
        data = MarkovLM(vocab=cfg.vocab_size, seed=0, order=1)
        losses = []
        for i in range(3):
            toks = torch.tensor(data.sample(4, 128, step=i), device=dev)
            batch = sim.shard({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            params, ef, metrics = step(params, ef, batch)
            losses.append(metrics["lm_loss"].item())
        runs[dev] = (losses, tree.map(lambda x: x.cpu(), params))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    dparam = max((a - b).abs().max().item()
                  for a, b in zip(tree.leaves(p_cpu), tree.leaves(p_gpu)))
    print(json.dumps({"check": "card_vs_cpu", "losses_cpu": l_cpu,
                      "losses_card": l_gpu, "max_rel_loss_diff": rel,
                      "max_abs_param_diff": dparam}), flush=True)
    if not rel <= 1e-4 or not dparam <= 1e-4:
        raise AssertionError(f"card and CPU disagree: loss rel {rel:.2e}, "
                             f"params {dparam:.2e} (limits 1e-4, 1e-4)")


def profile_phase(torch, step, params, ef, batch, step_ms):
    """One step under torch.profiler: where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, ef, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    classes = {"gemm": 0.0, "lowrank": 0.0, "copy": 0.0, "other": 0.0}
    for e in rows:
        name = e.key.lower()
        if "project_kernel" in name or "sum_splits" in name:
            classes["lowrank"] += dev_ms(e)
        elif "gemm" in name:
            classes["gemm"] += dev_ms(e)
        elif "memcpy" in name or "memset" in name:
            classes["copy"] += dev_ms(e)
        else:
            classes["other"] += dev_ms(e)
    busy = sum(classes.values())
    top = sorted(rows, key=dev_ms, reverse=True)[:8]
    print(json.dumps({
        "check": "profile", "device_busy_ms": busy, "step_ms": step_ms,
        "idle_share": max(0.0, 1.0 - busy / step_ms),
        "device_ms_by_class": classes,
        "top_kernels": [{"name": e.key[:90], "ms": dev_ms(e), "calls": e.count}
                        for e in top]}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isfile(os.path.join(src, "repro_torch", "csrc", "lowrank.cu")):
        fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, src)

    from repro_torch import tree
    from repro_torch.configs import llama3_8b
    from repro_torch.core import matrixize
    from repro_torch.core.simmesh import SimMesh
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build, lowrank, ref
    from repro_torch.launch import train
    from repro_torch.models import model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 products in full float32: TF32 off for matmul and cuDNN")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peaks = card_peaks(card)
    print(f"card: {card} ({smi}); bound uses {peaks[1] / 1e12:.2f} TB/s and "
          f"{peaks[2] / 1e12:.0f} TFLOP/s fp32 ({peaks[0]} data sheet)")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build("lowrank")
    lowrank.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s) "
          f"-> {os.path.relpath(info['path'], ROOT)}")
    for name, regs, spills in ptxas_summary(info["log"]):
        print(f"  {name}: {regs} registers, {spills}")

    # -- 2. kernels at the main path's shapes ---------------------------------
    cfg = dataclasses.replace(llama3_8b.config(), num_layers=2)
    meta = model.init(cfg, None, device="meta")
    shapes = []
    for p, spec in zip(tree.leaves(meta), tree.leaves(model.mspecs(cfg))):
        ms = matrixize.matrix_shape(tuple(p.shape), spec)
        shapes.append(None if ms is None else (math.prod(ms[0]), ms[1], ms[2]))
    buckets = matrixize.plan_buckets(shapes).buckets
    if len(buckets) != 6:
        raise AssertionError(f"expected 6 buckets, planned {len(buckets)}")
    slabs = [(WORKERS * bk.count, bk.n, bk.m) for bk in buckets]
    print(f"bucket slabs (workers folded into B): {slabs}")
    totals = kernel_phase(torch, lowrank, ref, slabs, peaks)

    # -- 3. card against CPU on a small model ---------------------------------
    parity_phase(torch, (train, llama3_8b, SimMesh, MarkovLM, tree))

    # -- 4. the main path: full-width 2-layer Llama-3-8B, 2 workers -----------
    sim = SimMesh(WORKERS)
    step, init = train.make_sim_train_step(cfg, sim, train.TrainHyper())
    params, ef = init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"train: {cfg.name}, {cfg.num_layers} layers, {n_params:,} params, "
          f"{WORKERS} simulated workers x 1 sequence x {SEQ} tokens; params, "
          f"momentum and Q factors are worker-identical and held once, error "
          f"buffers per worker")
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)
    batches = []
    for i in range(TRAIN_STEPS):
        toks = torch.tensor(data.sample(WORKERS, SEQ, step=i), device="cuda")
        batches.append(sim.shard({"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lowrank.reset_launches()
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, ef, metrics = step(params, ef, batch)
        loss = metrics["lm_loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        print(f"step {i} lm_loss={loss:.6f} step_ms={step_ms[-1]:.1f}", flush=True)
    launches = dict(lowrank.LAUNCHES)
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: {launches}")
    want = TRAIN_STEPS * len(buckets)
    if any(v != want for v in launches.values()):
        raise AssertionError(f"launches {launches}, want {want} per kernel "
                             f"({TRAIN_STEPS} steps x {len(buckets)} buckets)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name, t in (("params", params), ("error", ef.error),
                    ("momentum", ef.momentum), ("Q", ef.comp)):
        for path, x in tree.items(t):
            if x is not None and not torch.isfinite(x).all():
                raise AssertionError(f"non-finite {name} at {path}")
    if ef.step != TRAIN_STEPS:
        raise AssertionError(f"step counter {ef.step}")

    # -- 5. where the device time of a step goes ------------------------------
    profile_phase(torch, step, params, ef, batches[0], statistics.median(step_ms))

    summary = []
    for kind, replaces in (("project", "src/repro/kernels/lowrank.py:111"),
                           ("backproject", "src/repro/kernels/lowrank.py:144")):
        t = totals[kind]
        summary.append({
            "name": f"lowrank_{kind}", "route": "cuda",
            "source": "src/repro_torch/csrc/lowrank.cu", "replaces": replaces,
            "launches": launches[f"lowrank_{kind}"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bound_by"] == {"bytes"} else "operations",
            "library_ms": t["library_ms"]})
    print(f"kernel times are sums over the {len(buckets)} bucket slabs of one "
          f"step (rank {RANK}, {WORKERS} workers)")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
