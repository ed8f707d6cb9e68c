"""The nibble kernels of ``csrc/quant.cu`` (B4a ``nibble_pack``, B4b
``nibble_unpack``) against another build of them, on one CUDA card, in one
process.

    mkdir -p build/nibble_ab/old
    git show REV:src/repro_torch/csrc/quant.cu > build/nibble_ab/old/quant.cu
    git show REV:src/repro_torch/kernels/quant.py > build/nibble_ab/old/quant.py
    PYTHONPATH=src python -m repro_torch.bench.nibble_ab \\
        --old build/nibble_ab/old --out build/nibble_ab/result.json

Builds with nvcc (``_build.NVCC_FLAGS``, all at once, into
``build/nibble_ab/``) the old source, the tree's, the tree's launched
without the PDL attribute, and an empty kernel on the tree's grid and
launch path; each build is bound through a copy of its own wrapper module
and held bit for bit against the plain version.  Then, by CUDA-graph
replay, at the Top-K int4 chunk of Llama-3-8B at W = 2 (L2-hot, as the
caller has just written it) and at 16 rows of it (L2-cold: inputs rotated,
outputs kept):

* every build, in the order old, no PDL, tree, tree, no PDL, old,
  ``REPEATS`` readings per visit: back to back, each after a PyTorch
  ``copy_`` that writes its input (as on the training path, where B4
  follows PyTorch's kernels; that copy's own replay subtracted), and cold;
* the empty kernel with and without PDL, and a ``copy_`` of the int8 codes
  (the floors);
* ``quant_pack_flat`` / ``quant_unpack_flat`` through a copy of
  ``core/matrixize.py`` bound to the old wrapper and one bound to the
  tree's (old, tree, tree, old, twice);
* the wall time per call of ``CALLS`` back-to-back wrapper calls (the
  host's cost per call), old against tree.

Prints one JSON line per reading and a summary, and writes both to
``--out``.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import importlib.util
import itertools
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import types

import torch

from repro_torch import tree
from repro_torch.configs import llama3_8b
from repro_torch.core import matrixize
from repro_torch.kernels import _build, ref
from repro_torch.models import model

SOURCE = _build.CSRC / "quant.cu"
WRAPPER = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "quant.py"
OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "nibble_ab"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM5 80GB HBM3, NVIDIA data sheet
REPEATS = 3
CALLS = 1000   # back-to-back wrapper calls per host-clock reading
WORKERS, RANK, COLD_ROWS, COLD_INPUTS = 2, 2, 16, 8
PDL_LINE = "cfg.numAttrs = 1;"
EMPTY = """
namespace {
__global__ void __launch_bounds__(kThreads) empty_kernel(int) {
  wait_for_predecessor();
  allow_successor();
}
}  // namespace

extern "C" int nibble_empty(long long rows, long long n, int pdl, void* stream) {
  Plan plan;
  if (!plan_for(rows, n, 32, &plan)) return (int)cudaErrorInvalidValue;
  if (pdl) return launch(empty_kernel, plan, stream, 0);
  empty_kernel<<<plan.grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(0);
  return (int)cudaGetLastError();
}
"""


def nvcc(name: str, text: str) -> pathlib.Path:
    """Compile ``text`` into ``OUT_DIR/lib<name>.so``."""
    slug = re.sub(r"\W+", "_", name)
    src, lib = OUT_DIR / f"{slug}.cu", OUT_DIR / f"lib{slug}.so"
    src.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return lib


def module_copy(name: str, py: pathlib.Path, **attrs):
    """A fresh copy of the module at ``py``, with ``attrs`` set on it."""
    spec = importlib.util.spec_from_file_location(
        "nibble_ab_" + re.sub(r"\W+", "_", name), py)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    for key, value in attrs.items():
        setattr(mod, key, value)
    return mod


def graph_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed 5 times, timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def cold_graph_ms(fn, inputs, iters: int = 50) -> float:
    """:func:`graph_ms` of ``fn`` over ``inputs`` in turn, every output kept,
    so that a working set above the 50 MB L2 reaches each call cold."""
    outs, turn = [], itertools.count()
    ms = graph_ms(lambda: outs.append(fn(inputs[next(turn) % len(inputs)])), iters)
    outs.clear()
    return ms


def after_copy_ms(dst, src, fn) -> float:
    """Device time per call of ``fn`` when a ``dst.copy_(src)`` (a PyTorch
    kernel writing ``fn``'s input) runs just before each call: the replay of
    both less that of the copy alone."""
    return graph_ms(lambda: (dst.copy_(src), fn())) - graph_ms(lambda: dst.copy_(src))


def call_ms(fn, calls: int = CALLS) -> float:
    """Wall time per call of ``calls`` back-to-back calls (CUDA events)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def topk_chunk(workers: int):
    """(chunk, parts): the int4 chunk of Llama-3-8B's Top-K gather at
    ``workers``, and the float payload parts it plans from (meta tensors)."""
    cfg = dataclasses.replace(llama3_8b.config(), num_layers=2)
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
    return next(c for c in plan.chunks if c.quant), parts


def summary(readings):
    return {"median": statistics.median(readings), "min": min(readings),
            "max": max(readings), "n": len(readings)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="directory holding the old quant.cu and quant.py")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nibble_ab: needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    emit({"card": card, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    tree_src = SOURCE.read_text()
    if tree_src.count(PDL_LINE) != 1:
        raise RuntimeError(f"{SOURCE} no longer holds {PDL_LINE!r} once")
    jobs = {"old": (args.old / "quant.cu").read_text(), "tree": tree_src,
            "no PDL": tree_src.replace(PDL_LINE, "cfg.numAttrs = 0;"),
            "empty": tree_src + EMPTY}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(nvcc, jobs, jobs.values())))
    mods = {name: module_copy(
                name, args.old / "quant.py" if name == "old" else WRAPPER,
                _build=types.SimpleNamespace(
                    load=lambda _, lib=built[name]: ctypes.CDLL(str(lib))))
            for name in ("old", "no PDL", "tree")}

    chunk, meta_parts = topk_chunk(WORKERS)
    n = 2 * sum(matrixize.quant_slot_sizes(chunk))
    hot_shape, cold_shape = (WORKERS, n), (COLD_ROWS, n)
    gen = torch.Generator("cuda").manual_seed(7)
    codes = lambda shape: torch.randint(-128, 128, shape, generator=gen,
                                        device="cuda", dtype=torch.int8)
    hot = codes(hot_shape)
    hot_packed = ref.nibble_pack(hot)
    hot_in, packed_in = torch.empty_like(hot), torch.empty_like(hot_packed)
    cold = [codes(cold_shape) for _ in range(COLD_INPUTS)]
    cold_packed = [ref.nibble_pack(x) for x in cold]
    bound = {"hot": (hot.numel() + hot_packed.numel()) / HBM_BYTES_PER_S * 1e3,
             "cold": (cold[0].numel() + cold_packed[0].numel()) / HBM_BYTES_PER_S * 1e3}
    emit({"chunk": list(hot_shape), "cold": list(cold_shape), "bound_ms": bound,
          "bound_by": "bytes"})

    for name, mod in mods.items():
        bad = 0
        for x in (hot, cold[0], codes((3, 1001))):
            p, k = ref.nibble_pack(x), x.shape[-1]
            bad += int((mod.nibble_pack(x) != p).sum())
            bad += int((mod.nibble_unpack(p, k) != ref.nibble_unpack(p, k)).sum())
        torch.cuda.synchronize()
        emit({"held": name, "mismatches": bad})
        if bad:
            raise AssertionError(f"build {name!r} differs from the plain version")

    cells = {
        "pack hot": lambda m: graph_ms(lambda: m.nibble_pack(hot)),
        "unpack hot": lambda m: graph_ms(lambda: m.nibble_unpack(hot_packed, n)),
        "pack after copy_": lambda m: after_copy_ms(
            hot_in, hot, lambda: m.nibble_pack(hot_in)),
        "unpack after copy_": lambda m: after_copy_ms(
            packed_in, hot_packed, lambda: m.nibble_unpack(packed_in, n)),
        "pack cold": lambda m: cold_graph_ms(m.nibble_pack, cold),
        "unpack cold": lambda m: cold_graph_ms(lambda x: m.nibble_unpack(x, n),
                                               cold_packed),
    }
    readings = {name: {cell: [] for cell in cells} for name in mods}
    for visit, name in enumerate([*mods, *reversed(mods)]):
        for cell, timed in cells.items():
            got = [timed(mods[name]) for _ in range(REPEATS)]
            readings[name][cell] += got
            emit({"visit": visit, "build": name, "cell": cell, "ms": got})
            torch.cuda.empty_cache()

    # the floors: the empty kernel with and without PDL, a copy_ of the codes
    lib = ctypes.CDLL(str(built["empty"]))
    lib.nibble_empty.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]
    floors = {}
    for pdl, shape in itertools.product((1, 0), (hot_shape, cold_shape)):
        def empty(shape=shape, pdl=pdl):
            err = lib.nibble_empty(shape[0], shape[1], pdl,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"empty kernel: CUDA error {err}")
        floors[f"empty{'' if pdl else ', no PDL'} {shape}"] = [
            graph_ms(empty) for _ in range(2 * REPEATS)]
    floors[f"copy_ {hot_shape}"] = [graph_ms(lambda: hot_in.copy_(hot))
                                    for _ in range(2 * REPEATS)]
    floors[f"copy_ {cold_shape}, cold"] = [
        cold_graph_ms(lambda x: torch.empty_like(x).copy_(x), cold)
        for _ in range(2 * REPEATS)]
    emit({"floors_ms": floors})
    del cold, cold_packed
    torch.cuda.empty_cache()

    # the real neighbours, through a copy of matrixize bound to each build,
    # and the host's cost per call, old against tree
    flat = {name: module_copy(f"matrixize {name}", pathlib.Path(matrixize.__file__),
                              ops=types.SimpleNamespace(
                                  nibble_pack=mods[name].nibble_pack,
                                  nibble_unpack=mods[name].nibble_unpack))
            for name in ("old", "tree")}
    parts = [None] * len(meta_parts)
    for s in chunk.slots:
        parts[s.index] = torch.randn(meta_parts[s.index].shape, generator=gen,
                                     device="cuda")
    payload, scales = matrixize.quant_pack_flat(chunk, parts, lead=1)
    around = {"old": {}, "tree": {}}
    for name in ("old", "tree", "tree", "old") * 2:
        m, mx = mods[name], flat[name]
        for cell, timed in (
                ("quant_pack_flat_ms",
                 lambda: graph_ms(lambda: mx.quant_pack_flat(chunk, parts, lead=1), 20)),
                ("quant_unpack_flat_ms", lambda: graph_ms(lambda: mx.quant_unpack_flat(
                    chunk, payload, scales, leading=(WORKERS,)), 20)),
                ("pack kernel_call_ms", lambda: call_ms(lambda: m.nibble_pack(hot))),
                ("unpack kernel_call_ms",
                 lambda: call_ms(lambda: m.nibble_unpack(hot_packed, n)))):
            got = [timed() for _ in range(REPEATS)]
            around[name].setdefault(cell, []).extend(got)
            emit({"build": name, "cell": cell, "ms": got})

    result = {
        "card": card, "nvidia_smi": smi, "bound_ms": bound,
        "kernels": {name: {cell: summary(r) for cell, r in cells_.items()}
                    for name, cells_ in readings.items()},
        "bound_share": {name: {cell: bound["cold" if "cold" in cell else "hot"]
                               / statistics.median(r) for cell, r in cells_.items()}
                        for name, cells_ in readings.items()},
        "floors": {k: summary(v) for k, v in floors.items()},
        "around": {name: {cell: summary(r) for cell, r in v.items()}
                   for name, v in around.items()}}
    print(json.dumps(result, indent=1), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"lines": lines, "result": result}, indent=1))


if __name__ == "__main__":
    main()
