"""Run the paper's table drivers (:mod:`repro_torch.bench.tables`) and write
each table's rows as JSON (port of the JAX package's ``benchmarks/run.py``).

    python -m repro_torch.bench.run --only table3,fig3 --out OUT_DIR
    python -m repro_torch.bench.run --quick --only table1 --device cpu --out OUT_DIR

Prints ``table,key=value,...`` lines and writes ``OUT_DIR/<table>.json``.
``--only`` keeps the tables whose names contain one of its comma-separated
parts; ``--quick`` trains 40 steps instead of the paper's 150.  Runs on the
CUDA card unless ``--device`` says otherwise.  ``--out`` is required, and
may not point into ``experiments/benchmarks/``: the JAX package's records
live there.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch

#: where the JAX package's benchmark records live (its docs tests read them)
REFERENCE_RECORDS = (pathlib.Path(__file__).resolve().parents[3]
                     / "experiments" / "benchmarks")


def _unported(name: str, item: str):
    def run():
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue A, item {item})")
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="40 training steps instead of 150")
    ap.add_argument("--only", default=None,
                    help="comma-separated parts of table names (e.g. table1,fig3)")
    ap.add_argument("--out", required=True, help="directory for the JSON rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out).resolve()
    if out == REFERENCE_RECORDS or REFERENCE_RECORDS in out.parents:
        ap.error(f"--out {args.out} lies in {REFERENCE_RECORDS}, which holds the "
                 f"JAX package's records")

    from repro_torch.bench import tables
    from repro_torch.bench.common import LMSpec
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import model

    dev = resolve_device(args.device)
    spec = LMSpec(steps=40 if args.quick else 150, workers=4, batch_per_worker=4)
    # the reduced Llama-3-8B tree of the timing-model tables
    cfg_small = get_config("llama3-8b", reduced=True)
    params_small = model.init(cfg_small, torch.Generator(dev).manual_seed(0),
                              device=dev)
    specs_small = model.mspecs(cfg_small)

    runs = {
        "table1_error_feedback": lambda: tables.table1_error_feedback(
            spec, device=dev),
        "table2_warm_start": lambda: tables.table2_warm_start(spec, device=dev),
        "table3_rank_sweep": lambda: tables.table3_rank_sweep(spec, device=dev),
        "table4_compressor_zoo": lambda: tables.table4_compressor_zoo(
            spec, device=dev),
        "table5_time_breakdown": lambda: tables.table5_time_breakdown(
            params_small, specs_small, device=dev),
        "table6_other_methods": lambda: tables.table6_other_methods(
            spec, device=dev),
        "table7_lstm": _unported("table7_lstm", "15"),
        "fig3_scaling": lambda: tables.fig3_scaling(params_small, specs_small,
                                                    device=dev),
        **{name: _unported(name, "18") for name in (
            "adaptive_rank_profile", "resume_overhead", "comm_profile",
            "sync_mode_profile", "zoo_transport_profile", "overlap_profile")},
        "appendixD_transformer": lambda: tables.appendixD_transformer(
            spec, device=dev),
    }
    if args.only:
        keep = {k.strip() for k in args.only.split(",")}
        runs = {k: v for k, v in runs.items() if any(s in k for s in keep)}

    out.mkdir(parents=True, exist_ok=True)
    for name, fn in runs.items():
        t0 = time.time()
        rows = fn()
        dt = time.time() - t0
        print(f"\n=== {name} ({dt:.1f}s) ===")
        for row in rows:
            print(name + "," + ",".join(f"{k}={v}" for k, v in row.items()))
        with open(out / f"{name}.json", "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
