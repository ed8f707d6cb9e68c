"""The measured column of ``sync_mode_profile``
(:func:`repro_torch.bench.tables.sync_mode_profile`): the host time of a
training step under each ``sync_mode`` on 4 gloo processes on the CPU,
the port's counterpart of the JAX package's (4, 1) mesh of CPU devices.

    python -m repro_torch.bench.sync_measure --steps 10

Each process is one data-parallel worker of
:func:`repro_torch.launch.train.make_train_step` on reduced Llama-3-8B
(rank-2 PowerSGD, lr 0.05, q_chunk 64, 20 warm-up steps; global batches
of 8 × 64 ``MarkovLM`` tokens, 2 sequences a worker), with one torch
thread, in a group made on a file store in a temporary directory.  A
step's time runs from the call to the loss on the host; a mode's is the
mean over steps 3 on (all steps when there are fewer than 4), the
slowest worker's.  Prints ``SYNC_MEASURE_JSON={"allreduce": s,
"broadcast": s}`` (seconds).  These are CPU times, never times of a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import tempfile
import time

# torch and the port are imported in the workers alone: the spawning
# process needs neither, and each import of torch costs seconds

WORKERS = 4
MODES = ("allreduce", "broadcast")
JOIN_TIMEOUT_S = 840


def mode_seconds(rank: int, workers: int, mode: str, steps: int) -> float:
    """This worker's mean step seconds under ``mode`` (in a default group
    of ``workers`` gloo processes)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import MarkovLM, shard_batch
    from repro_torch.launch.train import TrainHyper, make_train_step

    cfg = get_config("llama3-8b", reduced=True)
    hyper = TrainHyper(lr=0.05, rank=2, q_chunk=64, warmup_steps=20,
                       sync_mode=mode)
    step_fn, init_state = make_train_step(cfg, hyper, device="cpu")
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)
    params, ef = init_state(torch.Generator().manual_seed(0))
    times = []
    for i in range(steps):
        toks = torch.from_numpy(data.sample(8, 64, step=i))
        batch = shard_batch({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                            rank, workers)
        t0 = time.perf_counter()
        params, ef, met = step_fn(params, ef, batch, seed=1)
        met["lm_loss"].item()
        times.append(time.perf_counter() - t0)
    warm = times[3:] or times
    return sum(warm) / len(warm)


def _worker(rank: int, workers: int, rendezvous_dir: str, steps: int) -> None:
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{rendezvous_dir}/rdzv",
        world_size=workers, rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for mode in MODES:
            t = torch.tensor([mode_seconds(rank, workers, mode, steps)],
                             dtype=torch.float64)
            tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
            out[mode] = t.item()
        if rank == 0:
            with open(os.path.join(rendezvous_dir, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        tdist.destroy_process_group()


def measure(steps: int) -> dict:
    """``{mode: seconds}`` from ``WORKERS`` spawned gloo processes; raises
    where a process fails or outlives ``JOIN_TIMEOUT_S``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_worker, args=(r, WORKERS, d, steps))
                 for r in range(WORKERS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"gloo workers exited with {codes}")
        with open(os.path.join(d, "result.json")) as f:
            return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.sync_measure",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    print("SYNC_MEASURE_JSON=" + json.dumps(measure(args.steps)), flush=True)


if __name__ == "__main__":
    main()
