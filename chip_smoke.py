#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build    — compile ``src/repro_torch/csrc/lowrank.cu`` and ``quant.cu``
              with nvcc for sm_90a (into ``build/kernels/``), both at once,
              and load them.
2. kernels  — at each of the six shape buckets of Llama-3-8B width with 2
              layers (2 simulated workers folded into the batch), hold
              ``lowrank_project`` and ``lowrank_backproject`` against their
              plain PyTorch versions and time kernel, plain version, one
              ``torch.bmm`` of the same product, and the memory-bandwidth
              bound.  Also ranks 1, 4, 32 at one shape and a ragged 2-D
              input.  Then hold ``nibble_pack`` and ``nibble_unpack`` bit
              for bit against their plain versions (every int8 code, every
              byte, odd, long, batched and unaligned shapes, and the int4
              chunk of the Top-K path) and time them at that chunk.
3. parity   — 3 training steps of reduced Llama-3-8B on the card (kernels)
              against the same steps on the CPU (plain versions), for
              PowerSGD and for Top-K on the int4 gather wire.
4. powersgd — 5 EF-PowerSGD steps of the full-width 2-layer Llama-3-8B with
              2 simulated workers; every low-rank kernel must launch once per
              bucket per step.  One more step under ``torch.profiler``:
              device time by kernel class against the step.
5. top_k    — 5 EF-Top-K steps of the same model on the int4 gather wire:
              1 reduce and 2 gathers per step, each nibble kernel launched
              once per step, no low-rank kernel.  One more step profiled.

Each main path runs with every launch count set to 0 just before it and
read just after.  Float32 products run in full float32: TF32 is switched
off for matmuls and cuDNN.  The last two lines of output are the
``{"kernels": [...]}`` summary and ``{"ok": true, ...}``; the card's name and
power limit come just before.
"""

import concurrent.futures
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
                      r"(backproject_kernel|project_kernel|sum_splits_kernel"
                      r"|unpack_kernel|pack_kernel)"
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


_CAPTURE_STREAM = []


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, timed by CUDA events, so the host's launch cost
    between calls drops out.  Every capture uses one side stream: cuBLAS
    keeps a workspace per stream for the life of the process, and the main
    paths' peak memory is read later."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


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
        row = {"check": "rank", "shape": list(shape), "rank": r,
               "project_max_abs_err": e1, "backproject_max_abs_err": e2}
        if m.ndim == 2:
            # the 2-D variants (B1a/B2a): device times beside one torch.mm
            # and the bound (each of M, the factor and the output moved once)
            dev = lambda fn: graph_ms(torch, fn, 50)
            row.update({
                "project_ms": dev(lambda: lowrank.lowrank_project(m, q)),
                "project_plain_ms": dev(lambda: ref.lowrank_project(m, q)),
                "project_library_ms": dev(lambda: torch.mm(m, q)),
                "backproject_ms": dev(lambda: lowrank.lowrank_backproject(m, p)),
                "backproject_plain_ms": dev(lambda: ref.lowrank_backproject(m, p)),
                "backproject_library_ms": dev(lambda: torch.mm(m.t(), p))})
            for kind, f, rows in (("project", q, shape[0]), ("backproject", p, shape[1])):
                byte_ms = 4 * (m.numel() + f.numel() + rows * r) / peaks[1] * 1e3
                op_ms = 2 * m.numel() * r / peaks[2] * 1e3
                row[f"{kind}_bound_ms"] = max(byte_ms, op_ms)
                row[f"{kind}_bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
        print(json.dumps(row), flush=True)
        totals["project"]["max_abs_err"] = max(totals["project"]["max_abs_err"], e1)
        totals["backproject"]["max_abs_err"] = max(
            totals["backproject"]["max_abs_err"], e2)
    torch.cuda.synchronize()
    return totals


def quant_phase(torch, quant, ref, chunk_shape, peaks):
    """Hold the nibble kernels bit for bit against their plain versions and
    time them at the int4 chunk of the Top-K path; returns per-kernel rows."""
    _, bw, _ = peaks
    gen = torch.Generator("cuda").manual_seed(1)

    def codes(shape):   # the whole int8 range: the kernels keep low nibbles
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    cases = [("every int8 code", torch.arange(-128, 128, device="cuda",
                                              dtype=torch.int8))]
    cases += [(f"n={n}", codes((n,))) for n in (1, 2, 3, 129, 2**20 + 1)]
    cases += [("(4, 1001)", codes((4, 1001))), ("(3, 31)", codes((3, 31))),
              ("(5, 66)", codes((5, 66))),
              (f"Top-K int4 chunk {chunk_shape}", codes(chunk_shape))]
    mismatches = {"nibble_pack": 0, "nibble_unpack": 0}
    for name, c in cases:
        n = c.shape[-1]
        packed = quant.nibble_pack(c)
        bad_pack = int((packed != ref.nibble_pack(c)).sum())
        bad_unpack = int((quant.nibble_unpack(packed, n)
                          != ref.nibble_unpack(packed, n)).sum())
        print(json.dumps({"check": "nibble", "case": name, "shape": list(c.shape),
                          "pack_mismatches": bad_pack,
                          "unpack_mismatches": bad_unpack}), flush=True)
        mismatches["nibble_pack"] += bad_pack
        mismatches["nibble_unpack"] += bad_unpack
    every_byte = torch.arange(256, device="cuda", dtype=torch.uint8)
    for n in (511, 512):
        bad = int((quant.nibble_unpack(every_byte, n)
                   != ref.nibble_unpack(every_byte, n)).sum())
        print(json.dumps({"check": "nibble", "case": f"every byte, n={n}",
                          "unpack_mismatches": bad}), flush=True)
        mismatches["nibble_unpack"] += bad
    if any(mismatches.values()):
        raise AssertionError(f"nibble kernels differ from their plain "
                             f"versions: {mismatches} elements")

    c = codes(chunk_shape)
    packed = ref.nibble_pack(c)
    n = chunk_shape[-1]
    nbytes = c.numel() + packed.numel()   # each input read, each output written once
    rows = {}
    for name, kern, plain in (
            ("nibble_pack", lambda: quant.nibble_pack(c), lambda: ref.nibble_pack(c)),
            ("nibble_unpack", lambda: quant.nibble_unpack(packed, n),
             lambda: ref.nibble_unpack(packed, n))):
        # device time per call, and the wall time per call of back-to-back
        # calls, which the host's launch cost sets at this size
        row = {"kernel": name, "shape": list(chunk_shape),
               "kernel_ms": graph_ms(torch, kern, 50),
               "plain_ms": graph_ms(torch, plain, 50),
               "kernel_call_ms": time_ms(torch, kern, 200),
               "plain_call_ms": time_ms(torch, plain, 200),
               "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
               "max_abs_err": 0.0}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        rows[name] = row
    torch.cuda.synchronize()
    return rows


def parity_phase(torch, mods, name, make_compressor, check):
    """Reduced Llama-3-8B, 3 steps, 2 workers: the card (kernels) against the
    CPU (plain versions), from identical parameters and compressor state.
    ``check(losses_cpu, losses_card, params_cpu, params_card)`` raises on
    disagreement."""
    train, llama3_8b, SimMesh, MarkovLM, tree = mods
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(2)
    hyper = train.TrainHyper(q_chunk=64, warmup_steps=2)
    _, init = train.make_sim_train_step(cfg, sim, hyper, device="cpu",
                                        compressor=make_compressor())
    runs = {}
    for dev in ("cpu", "cuda"):
        step, _ = train.make_sim_train_step(cfg, sim, hyper, device=dev,
                                            compressor=make_compressor())
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
    check(name, l_cpu, l_gpu, tree.leaves(p_cpu), tree.leaves(p_gpu))


def check_powersgd_parity(name, l_cpu, l_gpu, p_cpu, p_gpu):
    """Loss and parameters within 1e-4 (fp32 summation order only)."""
    rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    dparam = max((a - b).abs().max().item() for a, b in zip(p_cpu, p_gpu))
    print(json.dumps({"check": "card_vs_cpu", "path": name, "losses_cpu": l_cpu,
                      "losses_card": l_gpu, "max_rel_loss_diff": rel,
                      "max_abs_param_diff": dparam}), flush=True)
    if not rel <= 1e-4 or not dparam <= 1e-4:
        raise AssertionError(f"{name}: card and CPU disagree: loss rel "
                             f"{rel:.2e}, params {dparam:.2e} (limits 1e-4, 1e-4)")


# Top-K on the int4 wire, card against CPU: the card's gradients differ from
# the CPU's in float32 rounding, which can move a coordinate across the top-k
# boundary or an int4 code across a rounding boundary.  Each such flip moves
# one element of the update by up to lr·(1+λ+λ²) int4 steps (max|v|/7), far
# more than rounding.  So: losses within 1e-4 relative; all but a share of
# TOPK_FLIP_SHARE of the parameters within TOPK_ATOL (rounding), and none
# beyond TOPK_FLIP_ATOL (the size of a flip at this model's scales).
TOPK_ATOL, TOPK_FLIP_SHARE, TOPK_FLIP_ATOL = 1e-5, 1e-4, 1e-2


def check_topk_parity(name, l_cpu, l_gpu, p_cpu, p_gpu):
    rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    diffs = [(a - b).abs() for a, b in zip(p_cpu, p_gpu)]
    dparam = max(d.max().item() for d in diffs)
    beyond = sum(int((d > TOPK_ATOL).sum()) for d in diffs)
    total = sum(d.numel() for d in diffs)
    print(json.dumps({"check": "card_vs_cpu", "path": name, "losses_cpu": l_cpu,
                      "losses_card": l_gpu, "max_rel_loss_diff": rel,
                      "max_abs_param_diff": dparam,
                      "params_beyond_atol": beyond, "params": total}), flush=True)
    if not (rel <= 1e-4 and beyond <= TOPK_FLIP_SHARE * total
            and dparam <= TOPK_FLIP_ATOL):
        raise AssertionError(
            f"{name}: card and CPU disagree: loss rel {rel:.2e} (limit 1e-4), "
            f"{beyond} of {total} params beyond {TOPK_ATOL} (limit share "
            f"{TOPK_FLIP_SHARE}), max {dparam:.2e} (limit {TOPK_FLIP_ATOL})")


KERNEL_CLASSES = (("lowrank", ("project_kernel", "sum_splits")),
                  ("nibble", ("pack_kernel",)),
                  ("topk", ("topk", "sort", "radix", "select")),
                  ("gemm", ("gemm",)), ("copy", ("memcpy", "memset")))


def profile_phase(torch, path, step, params, ef, batch, step_ms):
    """One step under torch.profiler: where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, ef, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    classes = {k: 0.0 for k, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for e in rows:
        name = e.key.lower()
        cls = next((k for k, keys in KERNEL_CLASSES
                    if any(key in name for key in keys)), "other")
        classes[cls] += dev_ms(e)
    busy = sum(classes.values())
    top = sorted(rows, key=dev_ms, reverse=True)[:10]
    print(json.dumps({
        "check": "profile", "path": path, "device_busy_ms": busy,
        "step_ms": step_ms, "idle_share": max(0.0, 1.0 - busy / step_ms),
        "device_ms_by_class": classes,
        "top_kernels": [{"name": e.key[:90], "ms": dev_ms(e), "calls": e.count}
                        for e in top]}), flush=True)


def reset_all_launches(kernel_mods) -> None:
    for mod in kernel_mods:
        mod.reset_launches()


def read_all_launches(kernel_mods) -> dict:
    return {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()}


def train_phase(torch, mods, kernel_mods, cfg, path, compressor, stats=None,
                per_step_check=None):
    """TRAIN_STEPS steps of the full-width model on one path, with every
    launch count set to 0 just before and read just after; then one more
    step profiled.  Returns the launch counts."""
    train, tree, SimMesh, MarkovLM = mods
    sim = SimMesh(WORKERS)
    step, init = train.make_sim_train_step(cfg, sim, train.TrainHyper(),
                                           compressor=compressor, stats=stats)
    params, ef = init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"{path}: {cfg.name}, {cfg.num_layers} layers, {n_params:,} params, "
          f"{WORKERS} simulated workers x 1 sequence x {SEQ} tokens; params, "
          f"momentum and compressor state are worker-identical and held once, "
          f"error buffers per worker")
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)
    batches = []
    for i in range(TRAIN_STEPS):
        toks = torch.tensor(data.sample(WORKERS, SEQ, step=i), device="cuda")
        batches.append(sim.shard({"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    torch.cuda.synchronize()
    print(f"{path}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the first step")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches(kernel_mods)
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        if stats is not None:
            stats.reset()
        t0 = time.perf_counter()
        params, ef, metrics = step(params, ef, batch)
        loss = metrics["lm_loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        print(f"{path} step {i} lm_loss={loss:.6f} step_ms={step_ms[-1]:.1f}",
              flush=True)
        if per_step_check is not None:
            per_step_check(stats)
    launches = read_all_launches(kernel_mods)
    print(f"{path} max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{path} launches: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: non-finite loss: {losses}")
    for name, t in (("params", params), ("error", ef.error),
                    ("momentum", ef.momentum), ("compressor state", ef.comp)):
        for p, x in tree.items(t):
            if x is not None and not torch.isfinite(x).all():
                raise AssertionError(f"{path}: non-finite {name} at {p}")
    if ef.step != TRAIN_STEPS:
        raise AssertionError(f"{path}: step counter {ef.step}")
    if stats is not None:
        stats.reset()
    profile_phase(torch, path, step, params, ef, batches[0],
                  statistics.median(step_ms))
    return launches


def topk_chunk_shape(torch, cfg, model, matrixize, tree):
    """(W, codes) of the int4 chunk the Top-K path packs each step: every
    compressed leaf's budget b = r·(n+m) values per worker, each slot padded
    to an even code count."""
    meta = model.init(cfg, None, device="meta")
    parts = []
    for p, spec in zip(tree.leaves(meta), tree.leaves(model.mspecs(cfg))):
        ms = matrixize.matrix_shape(tuple(p.shape), spec)
        if ms is None:
            continue
        b = min(math.prod(ms[0]) * (ms[1] + ms[2]) * RANK, p.numel())
        parts += [torch.empty((WORKERS, b), device="meta"),
                  torch.empty((WORKERS, b), dtype=torch.int32, device="meta")]
    plan = matrixize.plan_flat(parts, wire_dtype="int4", lead=1)
    chunk = next(c for c in plan.chunks if c.quant)
    return (WORKERS, 2 * sum(matrixize.quant_slot_sizes(chunk)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(ROOT, "src")
    for name in ("lowrank", "quant"):
        if not os.path.isfile(os.path.join(src, "repro_torch", "csrc", f"{name}.cu")):
            fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, src)

    from repro_torch import tree
    from repro_torch.configs import llama3_8b
    from repro_torch.core import compressors, matrixize
    from repro_torch.core.dist import CollectiveStats
    from repro_torch.core.simmesh import SimMesh
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build, lowrank, quant, ref
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
    kernel_mods = (lowrank, quant)

    # -- 1. build: one nvcc per source, started together ----------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = dict(zip(("lowrank", "quant"),
                          pool.map(_build.build, ("lowrank", "quant"))))
    for mod in kernel_mods:
        mod.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, info in builds.items():
        print(f"  {name}: nvcc {info['seconds']:.1f} s -> "
              f"{os.path.relpath(info['path'], ROOT)}")
        for kname, regs, spills in ptxas_summary(info["log"]):
            print(f"    {kname}: {regs} registers, {spills}")

    # -- 2. kernels at the main paths' shapes ---------------------------------
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
    chunk_shape = topk_chunk_shape(torch, cfg, model, matrixize, tree)
    print(f"Top-K int4 chunk (workers x codes): {chunk_shape}")
    nibble_rows = quant_phase(torch, quant, ref, chunk_shape, peaks)

    # -- 3. card against CPU on a small model ---------------------------------
    pmods = (train, llama3_8b, SimMesh, MarkovLM, tree)
    parity_phase(torch, pmods, "powersgd",
                 lambda: compressors.make_compressor("powersgd", rank=RANK),
                 check_powersgd_parity)
    parity_phase(torch, pmods, "top_k_int4",
                 lambda: compressors.make_compressor("top_k", rank=RANK,
                                                     wire_dtype="int4"),
                 check_topk_parity)

    # -- 4. main path: EF-PowerSGD, full-width 2-layer Llama-3-8B -------------
    tmods = (train, tree, SimMesh, MarkovLM)
    psgd = train_phase(torch, tmods, kernel_mods, cfg, "powersgd",
                       compressors.make_compressor("powersgd", rank=RANK))
    want = {"lowrank_project": TRAIN_STEPS * len(buckets),
            "lowrank_backproject": TRAIN_STEPS * len(buckets),
            "nibble_pack": 0, "nibble_unpack": 0}
    if psgd != want:
        raise AssertionError(f"powersgd launches {psgd}, want {want} "
                             f"({TRAIN_STEPS} steps x {len(buckets)} buckets)")
    torch.cuda.empty_cache()

    # -- 5. main path: EF-Top-K on the int4 gather wire -----------------------
    def one_reduce_two_gathers(stats):
        print(json.dumps({"collectives": stats.kinds, "sizes": stats.sizes,
                          "itemsizes": stats.itemsizes, "fanouts": stats.fanouts,
                          "overheads": stats.overheads,
                          "bytes": stats.bytes_per_collective()}), flush=True)
        if (stats.reduce_collectives, stats.gather_collectives) != (1, 2):
            raise AssertionError(f"top_k: collectives {stats.kinds}, want 1 "
                                 f"reduce and 2 gathers per step")

    topk_comp = compressors.make_compressor("top_k", rank=RANK, wire_dtype="int4")
    if topk_comp.declared_budget() != (3, 1, 2):
        raise AssertionError(f"top_k budget {topk_comp.declared_budget()}")
    topk = train_phase(torch, tmods, kernel_mods, cfg, "top_k_int4", topk_comp,
                       stats=CollectiveStats(),
                       per_step_check=one_reduce_two_gathers)
    want = {"lowrank_project": 0, "lowrank_backproject": 0,
            "nibble_pack": TRAIN_STEPS, "nibble_unpack": TRAIN_STEPS}
    if topk != want:
        raise AssertionError(f"top_k launches {topk}, want {want} (one launch "
                             f"per kernel per step)")

    summary = []
    for kind, replaces in (("project", "src/repro/kernels/lowrank.py:111"),
                           ("backproject", "src/repro/kernels/lowrank.py:144")):
        t = totals[kind]
        summary.append({
            "name": f"lowrank_{kind}", "route": "cuda",
            "source": "src/repro_torch/csrc/lowrank.cu", "replaces": replaces,
            "launches": psgd[f"lowrank_{kind}"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bound_by"] == {"bytes"} else "operations",
            "library_ms": t["library_ms"]})
    for name, replaces in (("nibble_pack", "src/repro/kernels/quant.py:52"),
                           ("nibble_unpack", "src/repro/kernels/quant.py:77")):
        row = nibble_rows[name]
        per_step = topk[name] / TRAIN_STEPS
        summary.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/quant.cu", "replaces": replaces,
            "launches": topk[name], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"] * per_step,
            "plain_ms": row["plain_ms"] * per_step,
            "bound_ms": row["bound_ms"] * per_step, "bound_by": "bytes",
            "library_ms": None})
    print(f"kernel times are per training step: lowrank sums over the "
          f"{len(buckets)} bucket slabs (rank {RANK}, {WORKERS} workers), "
          f"nibble kernels at the Top-K int4 chunk {chunk_shape}")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
