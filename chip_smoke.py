#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build    — compile ``src/repro_torch/csrc/lowrank.cu``, ``quant.cu`` and
              ``ef_apply.cu`` with nvcc for sm_90a (into ``build/kernels/``),
              all at once, and load them.
2. kernels  — at each of the six shape buckets of Llama-3-8B width with 2
              layers (2 simulated workers folded into the batch), hold
              ``lowrank_project`` and ``lowrank_backproject`` against their
              plain PyTorch versions, check that a second call gives the
              same bits, and time kernel, plain version, one ``torch.bmm``
              of the same product (by CUDA events and by CUDA-graph replay)
              and the memory-bandwidth bound.  Then ranks 1, 3, 4, 17, 32,
              B = 1, an input one float past a 16-byte boundary, and the
              ragged 2-D input (1000, 1023) (timed by graph replay beside
              ``torch.mm``).  Then the same at the five bucket slabs of the
              benchmark LM (4 workers folded into the batch), timed by
              graph replay.  Then hold ``nibble_pack`` and ``nibble_unpack``
              bit for bit against their plain versions (every int8 code,
              every byte, odd, long, batched and unaligned shapes, and the
              int4 chunk of the Top-K path) and time them at that chunk.
              Then drive ``ops.ef_apply`` (the fused error-feedback apply,
              whose entry point is its main path) once at each of the six
              parameter slabs, hold every result against its plain version,
              time kernel, plain version and bound by CUDA-graph replay,
              and check a ragged set of shapes and ranks.
3. parity   — 3 training steps of reduced Llama-3-8B on the card (kernels)
              against the same steps on the CPU (plain versions), for
              PowerSGD and for Top-K on the int4 gather wire.
4. bench_lm — ``repro_torch.bench.common.train_lm``, the benchmark LM of the
              paper tables, at the full ``LMSpec`` (150 steps, 4 simulated
              workers) for identity, PowerSGD and Top-K: step time, eval
              loss, bits, collectives and kernel launches per step.  Then
              the same LM on the card against the CPU from one initial
              state.  It runs before any profiler does: the host-bound
              step is slower once ``torch.profiler`` has run.
5. dist     — the ``torch.distributed`` step (``make_train_step``) over a
              real NCCL process group of world size 1, at the full width of
              Llama-3-8B with 2 layers and 1 sequence of 1024 tokens: 3
              PowerSGD steps and 3 Top-K steps on the int4 gather wire,
              each against ``make_sim_train_step`` on ``SimMesh(1)`` from
              the same initial state under phase 3's rules (bit-equal
              expected; the largest difference is printed).  Step times,
              peak memory, collective
              records, real ``torch.distributed`` calls and kernel launches
              per path; the low-rank kernels must launch on the PowerSGD
              path, the nibble kernels on the Top-K path.  Then a profiler
              trace of one call of each low-rank kernel must hold exactly
              one kernel (the first profiler of the run).
6. powersgd — 5 EF-PowerSGD steps of the full-width 2-layer Llama-3-8B with
              2 simulated workers; every low-rank kernel must launch once per
              bucket per step.  One more step under ``torch.profiler``:
              device time by kernel class against the step.
7. top_k    — 5 EF-Top-K steps of the same model on the int4 gather wire:
              1 reduce and 2 gathers per step, each nibble kernel launched
              once per step, no low-rank kernel.  One more step profiled;
              every kernel class of the two profiles must match a kernel.

Each main path runs with every launch count set to 0 just before it and
read just after.  Float32 products run in full float32: TF32 is switched
off for matmuls and cuDNN.  The last two lines of output are the
``{"kernels": [...]}`` summary and ``{"ok": true, ...}``; the card's name and
power limit come just before.
"""

import concurrent.futures
import dataclasses
import datetime
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# per-element tolerance of a kernel against its plain version, both fp32
# with different summation orders over a reduction of length K:
#   |kernel − plain| ≤ ATOL + RTOL·|plain| + C_DOT·u·√K·√(Σ_k m_k² f_k²)
# (the last term is the probabilistic rounding-error bound of a length-K
# fp32 dot product; u = 2⁻²⁴)
ATOL, RTOL, C_DOT = 1e-4, 1e-5, 8.0
SOURCES = ("lowrank", "quant", "ef_apply")
RANK = 2
WORKERS = 2
TRAIN_STEPS = 5
DIST_STEPS = 3
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
    """(kernel<RP,VEC>, registers, spill line, shared-memory bytes) per
    compiled kernel, from nvcc's -Xptxas -v output."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?"
                      r"(backproject_kernel|project_kernel"
                      r"|unpack_kernel|pack_kernel|ef_apply_kernel)"
                      r"(?:ILi(\d+)ELi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)},{m.group(3)}>" if m.group(2) else "")
        elif "spill" in line:
            spills = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), spills, int(smem.group(1)) if smem else 0))
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


def lowrank_bound(m, f, out_numel, r, peaks):
    """(bound ms, "bytes" or "operations"): M, the factor and the output each
    moved once over the memory rate, or 2r flops per element of M over the
    fp32 rate, whichever is longer."""
    _, bw, flops = peaks
    byte_ms = 4 * (m.numel() + f.numel() + out_numel) / bw * 1e3
    op_ms = 2 * m.numel() * r / flops * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def slab_rows(torch, lowrank, ref, slabs, peaks, seed, events):
    """At each (B, n, m) slab, rank RANK: hold both kernels against their
    plain versions, check that a second call gives the same bits, and time
    kernel, plain version and one ``torch.bmm`` of the same product by
    CUDA-graph replay (``*_graph_ms``); with ``events``, also by CUDA events
    around back-to-back calls (``kernel_ms``, ``plain_ms``,
    ``library_ms``).  Returns one row per slab and kernel."""
    gen = torch.Generator("cuda").manual_seed(seed)
    rows = []
    for b, n, m_ in slabs:
        m = torch.randn((b, n, m_), generator=gen, device="cuda")
        q = torch.randn((b, m_, RANK), generator=gen, device="cuda")
        p = torch.randn((b, n, RANK), generator=gen, device="cuda")
        mt = m.transpose(1, 2)
        cases = {
            "project": (lowrank.lowrank_project, ref.lowrank_project, q,
                        lambda: torch.bmm(m, q), b * n * RANK),
            "backproject": (lowrank.lowrank_backproject, ref.lowrank_backproject,
                            p, lambda: torch.bmm(mt, p), b * m_ * RANK),
        }
        iters = max(3, min(50, int(2e10 / (4 * b * n * m_))))
        # both kernels timed before any check, after a round of calls whose
        # time is dropped: the first kernels after the float64 reference of
        # a 4 GB slab (this slab's or the last one's) run some 10 % slower
        time_ms(torch, lambda: lowrank.lowrank_project(m, q), iters)
        slab = {}
        for kind, (kern, plain_fn, f, lib_fn, out_numel) in cases.items():
            got = kern(m, f)
            if not torch.equal(got, kern(m, f)):
                raise AssertionError(f"{kind} {(b, n, m_)}: two calls on the same "
                                     f"inputs differ")
            plan = getattr(lowrank, f"plan_{kind}")(b, n, m_, RANK,
                                                    lowrank.sm_count(m.device))
            row = {"kernel": f"lowrank_{kind}", "shape": [b, n, m_], "rank": RANK,
                   "ctas": plan.ctas, "cluster": plan.cluster,
                   "repeat_bit_identical": True}
            if events:
                row.update({
                    "kernel_ms": time_ms(torch, lambda: kern(m, f), iters),
                    "plain_ms": time_ms(torch, lambda: plain_fn(m, f), iters),
                    "library_ms": time_ms(torch, lib_fn, iters)})
            row.update({
                "kernel_graph_ms": graph_ms(torch, lambda: kern(m, f), iters),
                "plain_graph_ms": graph_ms(torch, lambda: plain_fn(m, f), iters),
                "library_graph_ms": graph_ms(torch, lib_fn, iters)})
            row["bound_ms"], row["bound_by"] = lowrank_bound(m, f, out_numel, RANK,
                                                             peaks)
            row["bound_share"] = row["bound_ms"] / row["kernel_graph_ms"]
            slab[kind] = (row, got)
        for kind, (row, got) in slab.items():
            _, plain_fn, f, _, _ = cases[kind]
            plain = plain_fn(m, f)
            row["max_abs_err"], row["worst_over_tol"] = check_close(
                torch, ref, got, plain, m, f, kind)
            truth = plain_fn(m.double(), f.double())
            row["err_vs_fp64"] = (got.double() - truth).abs().max().item()
            row["plain_err_vs_fp64"] = (plain.double() - truth).abs().max().item()
            del truth, plain
            print(json.dumps(row), flush=True)
            rows.append(row)
        del m, q, p, mt, slab, got
        torch.cuda.empty_cache()
    return rows


def kernel_totals(rows, ms_key, plain_key, library_key):
    """Per-kernel sums of ``rows``' times, bounds and largest error."""
    totals = {}
    for kind in ("project", "backproject"):
        mine = [r for r in rows if r["kernel"] == f"lowrank_{kind}"]
        totals[kind] = {
            "ms": sum(r[ms_key] for r in mine),
            "plain_ms": sum(r[plain_key] for r in mine),
            "library_ms": sum(r[library_key] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "bound_by": {r["bound_by"] for r in mine}}
    return totals


# other ranks, B = 1, an input one float past a 16-byte boundary, and the
# ragged 2-D check (1000, 1023) whose rows are never 16-byte aligned
RANK_CHECKS = [((8, 4096, 4096), r, 0) for r in (1, 3, 4, 17, 32)] + [
    ((1, 4096, 4096), RANK, 0), ((8, 4096, 4096), RANK, 1), ((1000, 1023), 3, 0)]


def kernel_phase(torch, lowrank, ref, shapes, peaks, held):
    """Hold both kernels against their plain versions at the main path's
    shapes and time them; then the checks of ``RANK_CHECKS`` and, at rank
    RANK, at each slab of ``held`` (shapes another path gives the kernels,
    held without timing).  Returns per-kernel totals over the shapes."""
    rows = slab_rows(torch, lowrank, ref, shapes, peaks, seed=0, events=True)
    totals = kernel_totals(rows, "kernel_ms", "plain_ms", "library_ms")
    graph = kernel_totals(rows, "kernel_graph_ms", "plain_graph_ms",
                          "library_graph_ms")
    print(json.dumps({"check": "llama slabs, summed", **{
        f"{kind}_{key}": graph[kind][key]
        for kind in graph for key in ("ms", "plain_ms", "library_ms")},
        "reading": "graph replay; the kernels line gives the CUDA-event sums"}),
        flush=True)

    gen = torch.Generator("cuda").manual_seed(2)
    checks = [("rank", c) for c in RANK_CHECKS]
    checks += [("held slab", (shape, RANK, 0)) for shape in held]
    for what, (shape, r, offset) in checks:
        m = torch.empty(math.prod(shape) + offset, device="cuda")[offset:].view(shape)
        m.copy_(torch.randn(shape, generator=gen, device="cuda"))
        q = torch.randn(shape[:-2] + (shape[-1], r), generator=gen, device="cuda")
        p = torch.randn(shape[:-2] + (shape[-2], r), generator=gen, device="cuda")
        got_q, got_p = lowrank.lowrank_project(m, q), lowrank.lowrank_backproject(m, p)
        e1, _ = check_close(torch, ref, got_q, ref.lowrank_project(m, q), m, q,
                            "project")
        e2, _ = check_close(torch, ref, got_p, ref.lowrank_backproject(m, p), m, p,
                            "backproject")
        if not (torch.equal(got_q, lowrank.lowrank_project(m, q))
                and torch.equal(got_p, lowrank.lowrank_backproject(m, p))):
            raise AssertionError(f"{shape} r={r}: two calls on the same inputs differ")
        row = {"check": what, "shape": list(shape), "rank": r,
               "offset_floats": offset, "project_max_abs_err": e1,
               "backproject_max_abs_err": e2}
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
            for kind, f, rows_out in (("project", q, shape[0]),
                                      ("backproject", p, shape[1])):
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = lowrank_bound(
                    m, f, rows_out * r, r, peaks)
        print(json.dumps(row), flush=True)
        totals["project"]["max_abs_err"] = max(totals["project"]["max_abs_err"], e1)
        totals["backproject"]["max_abs_err"] = max(
            totals["backproject"]["max_abs_err"], e2)
        del m, q, p, got_q, got_p
    torch.cuda.synchronize()
    return totals


def lm_slab_phase(torch, lowrank, ref, slabs, peaks):
    """Both kernels at the benchmark LM's bucket slabs (its workers folded
    into B): held against the plain version, a second call bit for bit, and
    kernel, plain version, one ``torch.bmm`` and the bound by graph replay."""
    rows = slab_rows(torch, lowrank, ref, slabs, peaks, seed=4, events=False)
    t = kernel_totals(rows, "kernel_graph_ms", "plain_graph_ms", "library_graph_ms")
    print(json.dumps({"check": "lm slabs, summed", **{
        f"{kind}_{key}": t[kind][key] for kind in t
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}}),
        flush=True)
    return rows


def one_launch_per_call(torch, lowrank, slab):
    """A torch.profiler trace of one call of each kernel holds one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, n, m_ = slab
    m = torch.randn(slab, device="cuda")
    for kind, f in (("project", torch.randn(b, m_, RANK, device="cuda")),
                    ("backproject", torch.randn(b, n, RANK, device="cuda"))):
        call = getattr(lowrank, f"lowrank_{kind}")
        call(m, f)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(m, f)
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        print(json.dumps({"check": "one launch per call", "kernel": kind,
                          "shape": list(slab), "device_kernels": kernels}), flush=True)
        if len(kernels) != 1 or kernels[0][1] != 1 or f"{kind}_kernel" not in kernels[0][0]:
            raise AssertionError(f"lowrank_{kind}: one call ran {kernels}, want one "
                                 f"{kind}_kernel")


def quant_phase(torch, quant, ref, chunk_shape, peaks, held):
    """Hold the nibble kernels bit for bit against their plain versions and
    time them at the int4 chunk of the Top-K path; ``held`` are the chunk
    shapes other paths give them, held without timing.  Returns per-kernel
    rows."""
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
    cases += [(f"held chunk {shape}", codes(shape)) for shape in held]
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


# the fused EF apply against its plain version: unit-scale inputs, the
# tolerance tests/test_kernels.py holds the TPU kernel to
EF_LR, EF_LAM, EF_ATOL, EF_RTOL = 0.05, 0.9, 1e-4, 1e-4


def ef_apply_check(torch, ops, ef_kernel, ref, x, mom, p, q, what):
    """One call of the entry point on CUDA tensors: exactly one launch, and
    both outputs within the tolerance of the plain version on the same
    tensors.  Returns max |kernel − plain|."""
    before = ef_kernel.LAUNCHES["ef_apply"]
    got = ops.ef_apply(x, mom, p, q, EF_LR, EF_LAM)
    if ef_kernel.LAUNCHES["ef_apply"] != before + 1:
        raise AssertionError(f"ef_apply {what}: the entry point did not launch "
                             f"the kernel exactly once")
    plain = ref.ef_apply(x, mom, p, q, EF_LR, EF_LAM)
    err = 0.0
    for name, g, w in zip(("x", "mom"), got, plain):
        d = (g - w).abs()
        bad = int((d > EF_ATOL + EF_RTOL * w.abs()).sum())
        if bad or not torch.isfinite(g).all():
            raise AssertionError(
                f"ef_apply {what}: {bad} elements of {name}' beyond atol "
                f"{EF_ATOL} + rtol {EF_RTOL}, max |Δ| {d.max().item():.3e}")
        err = max(err, d.max().item())
        del d
    return err


def ef_apply_phase(torch, ops, ef_kernel, ref, slabs, peaks):
    """The fused EF apply through its entry point once at each of the six
    parameter slabs: its main path, with the launch count set to 0 just
    before and read just after.  Each result is held against the plain
    version.  Then, slab by slab again, device times of kernel and plain
    version by CUDA-graph replay beside the bound: x and mom read and x'
    and mom' written once, P̂ and Q read once; 2r + 5 fp32 flops per
    element.  Returns (per-slab rows, main-path launches)."""
    _, bw, flops = peaks

    def inputs(i, b, n, m):
        gen = torch.Generator("cuda").manual_seed(100 + i)
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        return randn(b, n, m), randn(b, n, m), randn(b, n, RANK), randn(b, m, RANK)

    rows = []
    ef_kernel.reset_launches()
    for i, (b, n, m) in enumerate(slabs):
        x, mom, p, q = inputs(i, b, n, m)
        rows.append({"kernel": "ef_apply", "shape": [b, n, m], "rank": RANK,
                     "max_abs_err": ef_apply_check(torch, ops, ef_kernel, ref, x,
                                                   mom, p, q, f"slab {(b, n, m)}")})
        del x, mom, p, q
        torch.cuda.empty_cache()
    launches = ef_kernel.LAUNCHES["ef_apply"]
    if launches != len(slabs):
        raise AssertionError(f"ef_apply launched {launches} times for "
                             f"{len(slabs)} slabs")

    for i, row in enumerate(rows):
        b, n, m = row["shape"]
        x, mom, p, q = inputs(i, b, n, m)
        iters = max(3, min(50, int(2e10 / (16 * b * n * m))))
        row["kernel_ms"] = graph_ms(
            torch, lambda: ops.ef_apply(x, mom, p, q, EF_LR, EF_LAM), iters)
        row["plain_ms"] = graph_ms(
            torch, lambda: ref.ef_apply(x, mom, p, q, EF_LR, EF_LAM), iters)
        byte_ms = 4 * (4 * x.numel() + p.numel() + q.numel()) / bw * 1e3
        op_ms = (2 * RANK + 5) * x.numel() / flops * 1e3
        row["bound_ms"] = max(byte_ms, op_ms)
        row["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        del x, mom, p, q
        torch.cuda.empty_cache()
    return rows, launches


def ef_apply_ragged(torch, ops, ef_kernel, ref):
    """Ragged n and m, one and two batch levels, r up to beyond 128, and a
    buffer 4 bytes past an aligned start; returns max |kernel − plain|."""
    gen = torch.Generator("cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sizes, ranks, err, cases = (1, 7, 255, 1000, 1023), (1, 2, 4, 32, 129), 0.0, 0
    for lead in ((), (3,)):
        for n in sizes:
            for m in sizes:
                for r in ranks:
                    x, mom = randn(*lead, n, m), randn(*lead, n, m)
                    p, q = randn(*lead, n, r), randn(*lead, m, r)
                    err = max(err, ef_apply_check(torch, ops, ef_kernel, ref, x, mom,
                                                  p, q, f"{lead + (n, m)} r={r}"))
                    cases += 1
    x = torch.empty(1000 * 1024 + 1, device="cuda")[1:].view(1000, 1024)
    x.copy_(randn(1000, 1024))
    err = max(err, ef_apply_check(torch, ops, ef_kernel, ref, x, randn(1000, 1024),
                                  randn(1000, 4), randn(1024, 4), "unaligned x"))
    print(json.dumps({"check": "ef_apply ragged", "cases": cases + 1,
                      "max_abs_err": err}), flush=True)
    return err


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


def check_powersgd_parity(name, l_cpu, l_gpu, p_cpu, p_gpu, loss_rtol=1e-4,
                          param_atol=1e-4, check="card_vs_cpu"):
    """Loss within ``loss_rtol`` relative and parameters within
    ``param_atol`` (``None``: reported, not held) — fp32 summation order
    only."""
    rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    dparam = max((a - b).abs().max().item() for a, b in zip(p_cpu, p_gpu))
    print(json.dumps({"check": check, "path": name, "losses_cpu": l_cpu,
                      "losses_card": l_gpu, "max_rel_loss_diff": rel,
                      "max_abs_param_diff": dparam}), flush=True)
    if not rel <= loss_rtol or (param_atol is not None and not dparam <= param_atol):
        raise AssertionError(f"{name}: card and CPU disagree: loss rel "
                             f"{rel:.2e}, params {dparam:.2e} (limits {loss_rtol}, "
                             f"{param_atol})")


# Top-K on the int4 wire, card against CPU: the card's gradients differ from
# the CPU's in float32 rounding, which can move a coordinate across the top-k
# boundary or an int4 code across a rounding boundary.  Each such flip moves
# one element of the update by up to lr·(1+λ+λ²) int4 steps (max|v|/7), far
# more than rounding.  So: losses within 1e-4 relative; all but a share of
# TOPK_FLIP_SHARE of the parameters within TOPK_ATOL (rounding), and none
# beyond TOPK_FLIP_ATOL (the size of a flip at this model's scales).
TOPK_ATOL, TOPK_FLIP_SHARE, TOPK_FLIP_ATOL = 1e-5, 1e-4, 1e-2


def check_topk_parity(name, l_cpu, l_gpu, p_cpu, p_gpu, check="card_vs_cpu"):
    rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    diffs = [(a - b).abs() for a, b in zip(p_cpu, p_gpu)]
    dparam = max(d.max().item() for d in diffs)
    beyond = sum(int((d > TOPK_ATOL).sum()) for d in diffs)
    total = sum(d.numel() for d in diffs)
    print(json.dumps({"check": check, "path": name, "losses_cpu": l_cpu,
                      "losses_card": l_gpu, "max_rel_loss_diff": rel,
                      "max_abs_param_diff": dparam,
                      "params_beyond_atol": beyond, "params": total}), flush=True)
    if not (rel <= 1e-4 and beyond <= TOPK_FLIP_SHARE * total
            and dparam <= TOPK_FLIP_ATOL):
        raise AssertionError(
            f"{name}: card and CPU disagree: loss rel {rel:.2e} (limit 1e-4), "
            f"{beyond} of {total} params beyond {TOPK_ATOL} (limit share "
            f"{TOPK_FLIP_SHARE}), max {dparam:.2e} (limit {TOPK_FLIP_ATOL})")


KERNEL_CLASSES = (("lowrank", ("project_kernel",)),
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
    return classes


def reset_all_launches(kernel_mods) -> None:
    for mod in kernel_mods:
        mod.reset_launches()


def read_all_launches(kernel_mods) -> dict:
    return {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()}


def train_phase(torch, mods, kernel_mods, cfg, path, compressor, stats=None,
                per_step_check=None):
    """TRAIN_STEPS steps of the full-width model on one path, with every
    launch count set to 0 just before and read just after; then one more
    step profiled.  Returns the launch counts and the profiled step's device
    ms by kernel class."""
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
    classes = profile_phase(torch, path, step, params, ef, batches[0],
                            statistics.median(step_ms))
    return launches, classes


LM_BUDGETS = {"identity": (1, 1, 0), "powersgd": (2, 2, 0), "top_k": (3, 1, 2)}


def bench_lm_phase(torch, bench, compressors, CollectiveStats, kernel_mods,
                   lm_buckets):
    """``train_lm`` at the full ``LMSpec`` on the card for each compressor,
    every launch count set to 0 just before and read just after.  Checks
    the collectives per step, that the low-rank kernels launch only under
    PowerSGD (once per bucket per step, and once more for the bits probe)
    and that nothing else launches (the wire is "auto"; the fused EF apply
    is on no training path).  Returns {compressor: launches}."""
    spec = bench.LMSpec()
    out = {}
    for name, budget in LM_BUDGETS.items():
        stats = CollectiveStats()
        reset_all_launches(kernel_mods)
        t0 = time.perf_counter()
        res = bench.train_lm(compressors.make_compressor(name, rank=RANK), spec,
                             stats=stats)
        seconds = time.perf_counter() - t0
        launches = read_all_launches(kernel_mods)
        per_step = tuple(c / spec.steps for c in (
            stats.data_collectives, stats.reduce_collectives,
            stats.gather_collectives))
        lowrank = (spec.steps + 1) * lm_buckets if name == "powersgd" else 0
        want = {k: 0 for k in launches}
        want.update(lowrank_project=lowrank, lowrank_backproject=lowrank)
        print(json.dumps({
            "check": "bench_lm", "compressor": name, "steps": spec.steps,
            "workers": spec.workers,
            "median_step_ms_from_step_5": statistics.median(res["step_ms"][5:]),
            "first_step_ms": res["step_ms"][0], "eval_loss": res["eval_loss"],
            "bits_per_worker_per_step": res["bits_per_worker_per_step"],
            "compressed_floats_total": res["compressed_floats_total"],
            "collectives_per_step": per_step, "launches": launches,
            "seconds": seconds}), flush=True)
        if per_step != budget:
            raise AssertionError(f"bench_lm {name}: collectives per step "
                                 f"{per_step}, want {budget}")
        if launches != want:
            raise AssertionError(f"bench_lm {name}: launches {launches}, want {want}")
        if not math.log(spec.vocab) > res["eval_loss"] > 0:
            raise AssertionError(f"bench_lm {name}: eval_loss {res['eval_loss']} "
                                 f"is not below the uniform {math.log(spec.vocab):.3f}")
        out[name] = launches
    return out


# Card against CPU on the benchmark LM, both from the initial state train_lm
# draws on the CPU from spec.seed.  Identity and PowerSGD: eval_loss within
# 1e-4 relative after 30 steps (CPU runs from parameters moved by one ulp
# differ by at most 1.6e-6).  Top-K is not smooth in its input: at every
# step its selection boundary sits within 1e-6 relative, so float32
# rounding flips a selection, and over 30 steps the flips cascade.  CPU runs
# from parameters moved by one ulp differ after 30 steps by up to 9.7e-5 in
# eval_loss and 1.3e-2 in parameters, and from another initial state (seed
# 7) by up to 5.6e-3 and 0.11; after 3 steps by 1.5e-8 and 4.8e-7
# (measured by ``python tests/test_torch_bench.py``).  So Top-K is held to
# the flip rule of check_topk_parity after 3 steps, where at most a few
# elements flip, and its 30-step eval_loss to 5e-2 relative.
LM_PARITY_STEPS, LM_SHORT_STEPS = 30, 3
LM_LOSS_RTOL, LM_TOPK_LOSS_RTOL = 1e-4, 5e-2


def bench_lm_parity(torch, bench, compressors, tree):
    """``train_lm`` on the card against the CPU from one initial state."""
    for name in LM_BUDGETS:
        horizons = (LM_PARITY_STEPS,) + ((LM_SHORT_STEPS,) if name == "top_k" else ())
        for steps in horizons:
            runs = {}
            for dev in ("cpu", "cuda"):
                res, params = bench.train_lm(
                    compressors.make_compressor(name, rank=RANK),
                    bench.LMSpec(steps=steps), device=dev, return_params=True)
                runs[dev] = ([res["eval_loss"]], [x.cpu() for x in tree.leaves(params)])
            (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
            path = f"bench_lm {name}, {steps} steps"
            if name == "top_k" and steps == LM_SHORT_STEPS:
                check_topk_parity(path, l_cpu, l_gpu, p_cpu, p_gpu)
            else:
                check_powersgd_parity(
                    path, l_cpu, l_gpu, p_cpu, p_gpu, param_atol=None,
                    loss_rtol=LM_TOPK_LOSS_RTOL if name == "top_k" else LM_LOSS_RTOL)


def dist_run(torch, mods, cfg, mode, compressor, stats, batches):
    """DIST_STEPS steps of one full-width path: ``mode`` "dist" through
    ``make_train_step`` on the process group, "sim" through
    ``make_sim_train_step`` on ``SimMesh(1)``, from the parameters and
    factors ``init_state`` draws from seed 0.  Returns losses, step ms,
    the run's peak GiB (above what was allocated before it) and the final
    parameters."""
    train, tree, SimMesh, _ = mods
    if mode == "dist":
        step, init = train.make_train_step(cfg, train.TrainHyper(),
                                           compressor=compressor, stats=stats)
    else:
        sim = SimMesh(1)
        step, init = train.make_sim_train_step(cfg, sim, train.TrainHyper(),
                                               compressor=compressor, stats=stats)
        batches = [sim.shard(b) for b in batches]
    base = torch.cuda.memory_allocated()
    params, ef = init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, ef, metrics = step(params, ef, batch)
        losses.append(metrics["lm_loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if ef.step != DIST_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dist {mode}: step {ef.step}, losses {losses}")
    return losses, step_ms, peak, params


def dist_phase(torch, mods, kernel_mods, cfg, compressors, CollectiveStats,
               pdist, n_buckets, smi):
    """``make_train_step`` over a real NCCL group of world size 1 against
    ``make_sim_train_step`` on ``SimMesh(1)``, for PowerSGD and Top-K on
    the int4 gather wire, held as the card is held against the CPU
    (``check_powersgd_parity``, ``check_topk_parity``: losses within 1e-4,
    PowerSGD parameters within 1e-4, Top-K parameters under the flip rule)
    with the simulated step in the CPU's place.  Every launch count and the
    count of ``torch.distributed`` calls are set to 0 just before the
    distributed run and read just after.  Returns {path: launches}."""
    import torch.distributed as tdist

    tree, MarkovLM = mods[1], mods[3]
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)
    batches = []
    for i in range(DIST_STEPS):
        toks = torch.tensor(data.sample(1, SEQ, step=i), device="cuda")
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    # path: (compressor, parity rule, kernel launches per step, (reduces,
    # gathers) recorded per step, torch.distributed calls per step: the
    # loss's all-reduce besides the compressor's, and a quantized gather's
    # scale sidecar in a call of its own)
    paths = {
        "powersgd": (lambda: compressors.make_compressor("powersgd", rank=RANK),
                     check_powersgd_parity,
                     {"lowrank_project": n_buckets, "lowrank_backproject": n_buckets},
                     (2, 0), {"all_reduce": 3, "all_gather": 0}),
        "top_k_int4": (lambda: compressors.make_compressor("top_k", rank=RANK,
                                                           wire_dtype="int4"),
                       check_topk_parity, {"nibble_pack": 1, "nibble_unpack": 1},
                       (1, 2), {"all_reduce": 2, "all_gather": 3}),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rdzv", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=60),
            device_id=torch.device("cuda", 0))
        try:
            print(f"dist: process group backend {tdist.get_backend()!r}, world "
                  f"size {tdist.get_world_size()}, torch {torch.__version__}, "
                  f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}",
                  flush=True)
            for path, (make, check, per_step, budget, calls) in paths.items():
                sim_stats, stats = CollectiveStats(), CollectiveStats()
                l_sim, ms_sim, peak_sim, p_sim = dist_run(
                    torch, mods, cfg, "sim", make(), sim_stats, batches)
                torch.cuda.empty_cache()
                reset_all_launches(kernel_mods)
                pdist.reset_calls()
                l_dist, ms_dist, peak_dist, p_dist = dist_run(
                    torch, mods, cfg, "dist", make(), stats, batches)
                launches = read_all_launches(kernel_mods)
                real_calls = dict(pdist.CALLS)
                p_sim, p_dist = tree.leaves(p_sim), tree.leaves(p_dist)
                check(path, l_sim, l_dist, p_sim, p_dist, check="dist_vs_sim")
                bit_equal = l_sim == l_dist and all(
                    torch.equal(a, b) for a, b in zip(p_sim, p_dist))
                del p_sim, p_dist
                torch.cuda.empty_cache()
                n = len(stats.kinds) // DIST_STEPS
                rec = {"kinds": stats.kinds[:n], "sizes": stats.sizes[:n],
                       "itemsizes": stats.itemsizes[:n],
                       "fanouts": stats.fanouts[:n],
                       "bytes": stats.bytes_per_collective()[:n]}
                print(json.dumps({
                    "check": "dist", "path": path, "card": smi,
                    "backend": tdist.get_backend(), "world_size": 1,
                    "steps": DIST_STEPS, "losses_dist": l_dist,
                    "losses_sim": l_sim, "bit_equal": bit_equal,
                    "step_ms_dist": ms_dist, "step_ms_sim": ms_sim,
                    "median_step_ms_dist": statistics.median(ms_dist),
                    "median_step_ms_sim": statistics.median(ms_sim),
                    "peak_gib_dist": peak_dist, "peak_gib_sim": peak_sim,
                    "collectives_per_step": rec,
                    "dist_calls_per_step": {k: v / DIST_STEPS
                                            for k, v in real_calls.items()},
                    "launches": launches}), flush=True)
                records = lambda st: (st.kinds, st.sizes, st.itemsizes,
                                      st.fanouts, st.overheads)
                if records(stats) != records(sim_stats):
                    raise AssertionError(f"dist {path}: collective records differ "
                                         f"from the simulated step's")
                got_budget = (stats.reduce_collectives / DIST_STEPS,
                              stats.gather_collectives / DIST_STEPS)
                if got_budget != budget:
                    raise AssertionError(f"dist {path}: (reduces, gathers) per "
                                         f"step {got_budget}, want {budget}")
                if real_calls != {k: v * DIST_STEPS for k, v in calls.items()}:
                    raise AssertionError(f"dist {path}: torch.distributed calls "
                                         f"{real_calls}, want {calls} per step")
                want = {k: 0 for k in launches}
                want.update({k: v * DIST_STEPS for k, v in per_step.items()})
                if launches != want:
                    raise AssertionError(f"dist {path}: launches {launches}, "
                                         f"want {want}")
                out[path] = launches
        finally:
            tdist.destroy_process_group()
    return out


def topk_chunk_shape(torch, cfg, model, matrixize, tree, workers):
    """(workers, codes) of the int4 chunk the Top-K path packs each step:
    every compressed leaf's budget b = r·(n+m) values per worker, each slot
    padded to an even code count."""
    meta = model.init(cfg, None, device="meta")
    parts = []
    for p, spec in zip(tree.leaves(meta), tree.leaves(model.mspecs(cfg))):
        ms = matrixize.matrix_shape(tuple(p.shape), spec)
        if ms is None:
            continue
        b = min(math.prod(ms[0]) * (ms[1] + ms[2]) * RANK, p.numel())
        parts += [torch.empty((workers, b), device="meta"),
                  torch.empty((workers, b), dtype=torch.int32, device="meta")]
    plan = matrixize.plan_flat(parts, wire_dtype="int4", lead=1)
    chunk = next(c for c in plan.chunks if c.quant)
    return (workers, 2 * sum(matrixize.quant_slot_sizes(chunk)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(ROOT, "src")
    for name in SOURCES:
        if not os.path.isfile(os.path.join(src, "repro_torch", "csrc", f"{name}.cu")):
            fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, src)

    from repro_torch import tree
    from repro_torch.bench import common as bench
    from repro_torch.configs import llama3_8b
    from repro_torch.core import compressors, matrixize
    from repro_torch.core import dist as pdist
    from repro_torch.core.dist import CollectiveStats
    from repro_torch.core.simmesh import SimMesh
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build, lowrank, ops, quant, ref
    from repro_torch.kernels import ef_apply as ef_kernel
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
    kernel_mods = (lowrank, quant, ef_kernel)

    # -- 1. build: one nvcc per source, started together ----------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for mod in kernel_mods:
        mod.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, info in builds.items():
        print(f"  {name}: nvcc {info['seconds']:.1f} s -> "
              f"{os.path.relpath(info['path'], ROOT)}")
        for kname, regs, spills, smem in ptxas_summary(info["log"]):
            print(f"    {kname}: {regs} registers, {smem} bytes static shared "
                  f"memory, {spills}")

    # -- 2. kernels at the main paths' shapes ---------------------------------
    cfg = dataclasses.replace(llama3_8b.config(), num_layers=2)
    buckets = bench.model_buckets(cfg)
    if len(buckets) != 6:
        raise AssertionError(f"expected 6 buckets, planned {len(buckets)}")
    slabs = [(WORKERS * bk.count, bk.n, bk.m) for bk in buckets]
    print(f"bucket slabs (workers folded into B): {slabs}")
    # one worker per process (phase 5) gives the kernels these slabs
    param_slabs = [(bk.count, bk.n, bk.m) for bk in buckets]
    print(f"parameter slabs (one worker, no worker dim): {param_slabs}")
    totals = kernel_phase(torch, lowrank, ref, slabs, peaks, held=param_slabs)
    lm_spec = bench.LMSpec()
    lm_buckets = bench.model_buckets(bench._make_cfg(lm_spec))
    lm_slabs = [(lm_spec.workers * bk.count, bk.n, bk.m) for bk in lm_buckets]
    print(f"benchmark-LM bucket slabs (workers folded into B): {lm_slabs}")
    lm_slab_phase(torch, lowrank, ref, lm_slabs, peaks)
    chunk_shape = topk_chunk_shape(torch, cfg, model, matrixize, tree, WORKERS)
    print(f"Top-K int4 chunk (workers x codes): {chunk_shape}")
    # phase 5 packs one worker's codes without a worker dim and unpacks the
    # gathered (1, bytes) payload
    one = topk_chunk_shape(torch, cfg, model, matrixize, tree, 1)
    nibble_rows = quant_phase(torch, quant, ref, chunk_shape, peaks,
                              held=[one[1:], one])
    t_ef = time.perf_counter()
    ef_rows, ef_launches = ef_apply_phase(torch, ops, ef_kernel, ref, param_slabs,
                                          peaks)
    ef_err = max([r["max_abs_err"] for r in ef_rows]
                 + [ef_apply_ragged(torch, ops, ef_kernel, ref)])
    ef_total = {k: sum(r[k] for r in ef_rows)
                for k in ("kernel_ms", "plain_ms", "bound_ms")}
    print(json.dumps({"check": "ef_apply slabs", "launches": ef_launches,
                      **ef_total, "bound_share": ef_total["bound_ms"]
                      / ef_total["kernel_ms"], "max_abs_err": ef_err,
                      "seconds": time.perf_counter() - t_ef}), flush=True)
    print("ef_apply library_ms: null (no single PyTorch call computes the fused "
          "update: P̂ Qᵀ, the momentum and the parameter update)")

    # -- 3. card against CPU on a small model ---------------------------------
    pmods = (train, llama3_8b, SimMesh, MarkovLM, tree)
    parity_phase(torch, pmods, "powersgd",
                 lambda: compressors.make_compressor("powersgd", rank=RANK),
                 check_powersgd_parity)
    parity_phase(torch, pmods, "top_k_int4",
                 lambda: compressors.make_compressor("top_k", rank=RANK,
                                                     wire_dtype="int4"),
                 check_topk_parity)

    # -- 4. the benchmark LM of the paper tables ------------------------------
    t_lm = time.perf_counter()
    bench_lm_phase(torch, bench, compressors, CollectiveStats, kernel_mods,
                   len(lm_buckets))
    bench_lm_parity(torch, bench, compressors, tree)
    print(f"bench_lm: {time.perf_counter() - t_lm:.1f} s")

    # -- 5. the torch.distributed step over a real NCCL group -----------------
    tmods = (train, tree, SimMesh, MarkovLM)
    t_dist = time.perf_counter()
    dist_launches = dist_phase(torch, tmods, kernel_mods, cfg, compressors,
                               CollectiveStats, pdist, len(buckets), smi)
    print(f"dist: launches on the distributed path {dist_launches}; "
          f"{time.perf_counter() - t_dist:.1f} s")
    # the first profiler of the run: after the host-bound LM phase and the
    # distributed phase
    one_launch_per_call(torch, lowrank, lm_slabs[1])

    # -- 6. main path: EF-PowerSGD, full-width 2-layer Llama-3-8B -------------
    psgd, psgd_classes = train_phase(torch, tmods, kernel_mods, cfg, "powersgd",
                                     compressors.make_compressor("powersgd",
                                                                 rank=RANK))
    want = {"lowrank_project": TRAIN_STEPS * len(buckets),
            "lowrank_backproject": TRAIN_STEPS * len(buckets),
            "nibble_pack": 0, "nibble_unpack": 0, "ef_apply": 0}
    if psgd != want:
        raise AssertionError(f"powersgd launches {psgd}, want {want} "
                             f"({TRAIN_STEPS} steps x {len(buckets)} buckets)")
    torch.cuda.empty_cache()

    # -- 7. main path: EF-Top-K on the int4 gather wire -----------------------
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
    topk, topk_classes = train_phase(torch, tmods, kernel_mods, cfg, "top_k_int4",
                                     topk_comp, stats=CollectiveStats(),
                                     per_step_check=one_reduce_two_gathers)
    want = {"lowrank_project": 0, "lowrank_backproject": 0,
            "nibble_pack": TRAIN_STEPS, "nibble_unpack": TRAIN_STEPS,
            "ef_apply": 0}
    if topk != want:
        raise AssertionError(f"top_k launches {topk}, want {want} (one launch "
                             f"per kernel per step)")
    idle = [k for k, _ in KERNEL_CLASSES if not psgd_classes[k] + topk_classes[k] > 0]
    if idle:
        raise AssertionError(f"kernel classes {idle} matched no kernel of the "
                             f"profiled steps: their names in KERNEL_CLASSES are stale")

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
    summary.append({
        "name": "ef_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/ef_apply.cu",
        "replaces": "src/repro/kernels/ef_apply.py:71", "launches": ef_launches,
        "max_abs_err": ef_err, "ms": ef_total["kernel_ms"],
        "plain_ms": ef_total["plain_ms"], "bound_ms": ef_total["bound_ms"],
        "bound_by": ("bytes" if {r["bound_by"] for r in ef_rows} == {"bytes"}
                     else "operations"),
        "library_ms": None})
    print(f"kernel times are per training step: lowrank sums over the "
          f"{len(buckets)} bucket slabs (rank {RANK}, {WORKERS} workers), "
          f"nibble kernels at the Top-K int4 chunk {chunk_shape}; ef_apply "
          f"sums one call at each of the {len(param_slabs)} parameter slabs")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
