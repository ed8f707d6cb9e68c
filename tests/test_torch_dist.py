"""The ``torch.distributed`` data-parallel step: 4 gloo processes on the CPU,
one worker each, started once for the whole file.

* (a) :class:`~repro_torch.core.dist.DistBackend` against
  :class:`~repro_torch.core.dist.SimBackend` on the same inputs (rank i's
  input is row i of the simulation's stacked input): ``pmean_data``,
  ``pmean_flat`` and ``allgather_flat`` on the ``auto``, ``float32``,
  ``bfloat16``, ``int8`` and ``int4`` wires.  Reduces within 1e-6 (gloo
  sums in another order than ``mean``; on the bfloat16 wire within
  ``bf16_reduce_tol``: gloo's order against the simulation's worker-order
  fold), gathers and quantized payloads bit-equal, ``CollectiveStats``
  records equal.
* (b) ``make_train_step`` at W = 4 against the reference's
  ``repro.launch.train.make_sim_train_step`` at W = 4, from the same
  parameters and Q factors on the same batches (rank i takes row i of the
  reference's per-worker batch): 5 PowerSGD steps and 3 Top-K steps on the
  int4 gather wire, under the tolerances of ``tests/test_torch_train.py``
  and ``tests/test_torch_topk.py`` (loss rtol 1e-5, parameters atol 2e-6),
  and 3 PowerSGD steps under ``TrainHyper(orthogonalizer="cholesky_qr")``
  against the reference's under the same hyperparameters.
  Momentum, Q factors and rank i's error buffer (against the reference's
  ``error[i]``) need more: atol 1e-5 (see
  :func:`test_steps_match_reference`).
* (c) After (b), parameters, momentum and Q factors are bit-identical on
  the 4 ranks, as the reference finds cross-replica drift exactly 0 under
  a plain all-reduce.
* (d) The entry point's device rules: the CUDA default raises where there
  is no card, and a process group whose backend does not carry the
  device's tensors raises.
* (f) The dense warm-up: 4 PowerSGD steps with ``start_compress_step=2``
  against the reference's at W = 4 under (b)'s tolerances; error buffers
  exactly 0 after the dense steps, replicas bit-identical, and a dense step
  records one reduce of the whole gradient and calls ``all_reduce`` once
  for it and once for the loss.
* (g) Adaptive rank: 4 PowerSGD steps under the staircase ``RANK_SCHEDULE``
  (a growth, then a cut) with ``track_residual``, each rank driving its
  own ``RankController`` from the step's ``residual_ratio``.  Every rank
  takes the same switches and holds bit-identical factors, parameters and
  momentum; the run matches the port's ``make_sim_train_step`` on
  ``SimMesh(4)`` with a controller of its own (losses and residual ratios
  rtol 1e-5, parameters atol 2e-6, momentum and factors atol 1e-5).
* (h) The bfloat16 wire: ``BF16_STEPS`` PowerSGD steps of
  ``make_train_step`` under ``TrainHyper(wire_dtype="bfloat16")`` against
  the port's ``make_sim_train_step`` on ``SimMesh(4)`` from the same state:
  replicas bit-identical, the records at itemsize 2, losses and
  parameters within ``BF16_LOSS_RTOL`` / ``BF16_PARAM_ATOL`` (gloo's sum
  order flips bfloat16 roundings of P and Q elements).
* (i) One-step staleness: ``STALE_STEPS`` steps of ``make_train_step``
  under ``TrainHyper(staleness="one_step")``, PowerSGD with its reduces
  split into chunks (``STALE_CAP``) on the pipelined transport (each
  chunk's ``all_reduce`` issued asynchronously, waited on before its
  unpack) and on the serial one: bit for bit the same, with the same
  records and ``torch.distributed`` calls, the replicas bit-identical, and
  each rank within (b)'s tolerances of the port's ``make_sim_train_step``
  on ``SimMesh(4)`` (the in-flight aggregate within ``STATE_ATOL``).  In
  (a), ``pmean_flat(interleave=True)`` on every wire, chunked, bit for bit
  the serial schedule's result with its records and calls.
* (j) ``sync_mode="broadcast"``: in (a)'s rows ``pmean_data``,
  ``psum_data`` and ``pmean_flat`` (chunked, serial and interleaved: one
  ``all_gather`` a chunk, summed in the canonical tree) bit for bit the
  simulation's at W = 4 on the ``auto``, ``bfloat16`` and ``int4`` wires,
  with its records; ``broadcast_flat`` of ``[-0.0, 0.0, 1.5, -2.0, nan]``
  gives +0.0 as the simulation and the reference do, and rank 0's row
  where the ranks differ.  ``SYNC_STEPS`` PowerSGD steps of
  ``make_train_step`` under ``TrainHyper(sync_mode="broadcast",
  track_drift=True)``: parameters, momentum and factors bit-identical on
  the 4 ranks, ``drift_params``, ``drift_momentum`` and ``drift_q``
  exactly 0.0, ``drift_error`` the same on every rank; the declared calls
  (see :func:`test_sync_steps_identical_across_ranks`); each rank within
  (b)'s tolerances of the port's ``SimMesh(4)`` under the mode.
* (e) Two more schemes of the zoo, 2 steps each with one base seed:
  ``random_k`` (shared-seed draws on a reduce) and ``sign_norm`` (a
  gather of int8 signs and float norms).  Every rank draws the same
  indices for every leaf and step, and the same as the parent process; the
  replicas stay bit-identical; each rank matches the port's
  ``make_sim_train_step`` on ``SimMesh(4)`` (losses rtol 1e-5, parameters
  atol 2e-6: gloo sums the reduces in another order than ``mean``).

The ranks import this module, so the JAX package is imported only inside
the parent's fixture: the ranks stay torch-only.  ``python
tests/test_torch_dist.py`` prints the measured gaps quoted below, for the
distributed step and for the port's simulated step.
"""

import datetime
import hashlib
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import bridge, tree
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist, engine, error_feedback
from repro_torch.core import matrixize as mz
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.timeout(180)

W, BATCH, SEQ = 4, 8, 32
STEPS = {"powersgd": 5, "top_k": 3, "cholesky_qr": 3}
ZOO_STEPS = {"random_k": 2, "sign_norm": 2}
WARMUP_STEPS, WARMUP_K = 4, 2   # (f): PowerSGD, dense through step k − 1
RANK_SCHEDULE, RANK_STEPS = "2@0,4@1,1@3", 4   # (g): ranks 2, 4, 4, 1
ZOO_SEED = 7          # the base seed every rank passes to the step
WIRES = ("auto", "float32", "bfloat16", "int8", "int4")
BF16_STEPS = 2        # (h)
STALE_STEPS, STALE_CAP = 3, 1    # (i): a wire chunk for every part
SYNC_STEPS = 3        # (j)
SYNC_WIRES = ("auto", "bfloat16", "int4")
SIGNED = np.array([-0.0, 0.0, 1.5, -2.0, np.nan], np.float32)
RENDEZVOUS_S = 60     # init_process_group and every collective
RESULTS_S = 140       # from the spawn to the last rank's result
REDUCE_ATOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
STATE_ATOL = 1e-5     # momentum, Q factors, error buffers
# (h): see test_bf16_wire_steps_match_sim
BF16_LOSS_RTOL, BF16_PARAM_ATOL = 1e-5, 5e-4


def bf16_reduce_tol(stacked):
    """The bfloat16 wire's mean of a stacked ``(W, ...)`` input, summed by
    gloo in its order and by the simulation in worker order, each add
    rounded to bfloat16: each of the W − 1 partial sums may round
    otherwise, by up to 2⁻⁸ of Σ|xᵢ| each, and the divide once more by
    2⁻⁸ of the mean."""
    a = np.abs(stacked.astype(np.float64)).sum(0)
    return (W - 1) * 2.0**-8 * a / W + 2.0**-8 * a / W


def _compressor(path):
    """``None``: the step's default, rank-2 PowerSGD."""
    if path == "top_k":
        return compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
    if path == "bf16":
        return compressors.make_compressor("powersgd", rank=2, wire_dtype="bfloat16")
    if path in ("stale", "stale_serial"):
        return compressors.make_compressor("powersgd", rank=2,
                                           pipeline=path == "stale",
                                           max_chunk_bytes=STALE_CAP)
    return None


def _hyper(start_compress_step=0, path="powersgd"):
    """``path`` "cholesky_qr": PowerSGD under ``TrainHyper``'s
    ``orthogonalizer="cholesky_qr"``."""
    orth = "cholesky_qr" if path == "cholesky_qr" else "gram_schmidt"
    sync = path == "sync"
    return train.TrainHyper(q_chunk=16, warmup_steps=2,
                            start_compress_step=start_compress_step,
                            orthogonalizer=orth,
                            staleness=("one_step" if path.startswith("stale")
                                       else "none"),
                            sync_mode="broadcast" if sync else "allreduce",
                            track_drift=sync)


def _batches(vocab, steps):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    out = []
    for i in range(steps):
        toks = data.sample(BATCH, SEQ, step=i)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()})
    return out


def _backend_inputs(seed=0):
    """Per-worker inputs stacked on a leading W dim: float parts to reduce
    (odd sizes, an all-zero slot, one float64 part) and Top-K-like parts to
    gather (float32 values beside int32 indices)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal((W,) + s).astype(np.float32)
    reduce_parts = [f(6, 5), f(33), np.zeros((W, 1), np.float32), f(2, 3, 4),
                    rng.standard_normal((W, 7))]
    gather_parts = [f(33), rng.integers(0, 1000, (W, 33)).astype(np.int32),
                    f(10), rng.integers(0, 1000, (W, 10)).astype(np.int32),
                    f(4, 6)]
    return {"data": f(3, 4), "reduce": reduce_parts, "gather": gather_parts}


def _records(stats):
    """A copy of the records (``reset`` clears the lists in place)."""
    return (list(stats.kinds), list(stats.sizes), list(stats.itemsizes),
            list(stats.fanouts), list(stats.overheads),
            stats.bytes_per_collective())


def _quant_chunk(parts, wire, lead):
    return next(c for c in mz.plan_flat(parts, wire_dtype=wire, lead=lead).chunks
                if c.quant is not None)


def _digest(t):
    """One hash over every leaf's bytes, in tree order."""
    h = hashlib.sha256()
    for x in tree.leaves(t):
        if x is not None:
            h.update(x.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _rank_backend(rank, inputs):
    """(a): every flat collective on this rank's row of the inputs."""
    mine = lambda parts: [torch.tensor(p[rank]) for p in parts]
    out = {}
    stats = dist.CollectiveStats()
    ctx = dist.MeshCtx(data_axes=("data",), stats=stats,
                       backend=dist.DistBackend())
    out["lead"], out["data_size"] = ctx.lead, ctx.data_size()
    data = torch.tensor(inputs["data"][rank])
    out["pmean_data"] = ctx.pmean_data(data).numpy()
    out["pmean_data_records"] = _records(stats)
    out["inputs_unchanged"] = [torch.equal(data, torch.tensor(inputs["data"][rank]))]
    for wire in WIRES:
        stats.reset()
        parts = mine(inputs["reduce"])
        red = ctx.pmean_flat(parts, wire_dtype=wire)
        out[("reduce", wire)] = ([x.numpy() for x in red], _records(stats))
        out["inputs_unchanged"] += [torch.equal(a, b) for a, b in
                                    zip(parts, mine(inputs["reduce"]))]
        runs = []
        for interleave in (False, True):
            stats.reset()
            dist.reset_calls()
            red = ctx.pmean_flat(mine(inputs["reduce"]), wire_dtype=wire,
                                 max_chunk_bytes=_reduce_cap(wire),
                                 interleave=interleave)
            runs.append(([x.numpy() for x in red], _records(stats),
                         dict(dist.CALLS)))
        out[("chunked reduce", wire)] = runs
        stats.reset()
        gat = ctx.allgather_flat(mine(inputs["gather"]), wire_dtype=wire)
        out[("gather", wire)] = ([x.numpy() for x in gat], _records(stats))
        if wire in ("int8", "int4"):
            parts = mine(inputs["gather"])
            payload, scales = mz.quant_pack_flat(_quant_chunk(parts, wire, 0), parts)
            out[("payload", wire)] = (ctx.backend.all_gather(payload).numpy(),
                                      ctx.backend.all_gather(scales).numpy())
    return out


def _rank_sync(rank, inputs):
    """(j): the collectives under ``sync_mode="broadcast"`` on this rank's
    row of the inputs."""
    mine = lambda parts: [torch.tensor(p[rank]) for p in parts]
    stats = dist.CollectiveStats()
    ctx = dist.MeshCtx(data_axes=("data",), sync_mode="broadcast", stats=stats,
                       backend=dist.DistBackend())
    out = {}
    data = torch.tensor(inputs["data"][rank])
    dist.reset_calls()
    out["data"] = ([ctx.pmean_data(data).numpy(), ctx.psum_data(data).numpy(),
                    ctx.pmean_data(data, sync=False).numpy()], _records(stats),
                   dict(dist.CALLS))
    for wire in SYNC_WIRES:
        runs = []
        for interleave in (False, True):
            stats.reset()
            dist.reset_calls()
            red = ctx.pmean_flat(mine(inputs["reduce"]), wire_dtype=wire,
                                 max_chunk_bytes=_reduce_cap(wire),
                                 interleave=interleave)
            runs.append(([x.numpy() for x in red], _records(stats),
                         dict(dist.CALLS)))
        out[("reduce", wire)] = runs
    stats.reset()
    dist.reset_calls()
    signed = ctx.broadcast_flat([torch.tensor(SIGNED)])[0]
    rows = ctx.broadcast_flat(mine(inputs["reduce"][:2]), stacked=True)
    out["broadcast"] = ([signed.numpy()] + [x.numpy() for x in rows],
                        _records(stats), dict(dist.CALLS))
    return out


def _reduce_cap(wire):
    """(a)'s chunked reduces: 28 elements a chunk on every wire, so the
    reduce parts travel in 4 or 5 chunks."""
    return int(28 * {"auto": 4, "float32": 4, "bfloat16": 2, "int8": 1,
                     "int4": 0.5}[wire])


def _rank_steps(rank, path, start, batches, start_compress_step=0):
    """(b), (c), (f), (h), (i): the distributed step on this rank's shard of
    each batch."""
    cfg = llama3_8b.reduced_config()
    stats = dist.CollectiveStats()
    hyper = _hyper(start_compress_step, path)
    step, _ = train.make_train_step(cfg, hyper, _compressor(path), stats=stats,
                                    device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(torch.zeros_like, params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]),
                 inflight=(tree.map(torch.zeros_like, params)
                           if hyper.staleness == "one_step" else None))
    losses, records, calls, error_zero, drifts = [], [], [], [], []
    dist.reset_calls()
    for b in batches:
        stats.reset()
        shard = {k: torch.tensor(v.reshape((W, -1) + v.shape[1:])[rank])
                 for k, v in b.items()}
        params, ef, m = step(params, ef, shard)
        losses.append(m["lm_loss"].item())
        records.append(_records(stats))
        calls.append(dict(dist.CALLS))
        error_zero.append(all(not e.any() for e in tree.leaves(ef.error)))
        drifts.append({k: v.item() for k, v in m.items() if k.startswith("drift_")})
    out = {"losses": losses, "records": records, "step": ef.step,
           "drifts": drifts,
           "calls": dict(dist.CALLS), "calls_after_step": calls,
           "error_zero": error_zero, "error": bridge.to_numpy(ef.error),
           "digests": {k: _digest(t) for k, t in (
               ("params", params), ("momentum", ef.momentum), ("q", ef.comp),
               ("inflight", ef.inflight or {}))}}
    if rank == 0:
        out.update(params=bridge.to_numpy(params),
                   momentum=bridge.to_numpy(ef.momentum),
                   q=bridge.to_numpy(ef.comp),
                   inflight=ef.inflight and bridge.to_numpy(ef.inflight))
    return out


def _rank_comp():
    return compressors.make_compressor("powersgd", rank_schedule=RANK_SCHEDULE,
                                       track_residual=True)


def _controlled_steps(step, params, ef, shards):
    """(g): the steps under a fresh controller of ``RANK_SCHEDULE``, which
    reads each step's ``residual_ratio``.  Per step the rank, loss,
    residual and a digest of the factors."""
    ctl, residual, out = _rank_comp().controller(), None, []
    for i, shard in enumerate(shards):
        new_comp, changed = ctl.update(ef.comp, i, residual)
        if changed:
            ef = error_feedback.replace_comp(ef, new_comp)
        params, ef, m = step(params, ef, shard)
        residual = m["residual_ratio"].item()
        out.append((ctl.rank, m["lm_loss"].item(), residual, _digest(ef.comp)))
    return params, ef, out, ctl.history


def _rank_adaptive(rank, start, batches):
    """(g): the distributed step under the staircase on this rank's
    shards."""
    step, _ = train.make_train_step(llama3_8b.reduced_config(), _hyper(),
                                    _rank_comp(), device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(torch.zeros_like, params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    shards = [{k: torch.tensor(v.reshape((W, -1) + v.shape[1:])[rank])
               for k, v in b.items()} for b in batches]
    params, ef, steps, history = _controlled_steps(step, params, ef, shards)
    out = {"steps": steps, "history": history,
           "digests": {k: _digest(t) for k, t in (
               ("params", params), ("momentum", ef.momentum), ("q", ef.comp))}}
    if rank == 0:
        out.update(params=bridge.to_numpy(params),
                   momentum=bridge.to_numpy(ef.momentum), q=bridge.to_numpy(ef.comp))
    return out


def _draws_digest(params, steps):
    """One hash over ``random_k``'s index draws for every leaf and step."""
    comp = compressors.make_compressor("random_k")
    h = hashlib.sha256()
    for s in range(steps):
        for path, x in tree.items(params):
            n = x.numel()
            h.update(comp.draw("choice", path, engine.step_seed(ZOO_SEED, s),
                               n=n, b=min(n, 64)).numpy().tobytes())
    return h.hexdigest()


def _rank_zoo(rank, name, start, batches):
    """(e): a stateless scheme of the zoo on this rank's shards."""
    step, _ = train.make_train_step(llama3_8b.reduced_config(), _hyper(),
                                    compressors.make_compressor(name, rank=2),
                                    device="cpu")
    params = bridge.to_torch(start)
    ef = EFState(error=tree.map(torch.zeros_like, params),
                 momentum=tree.map(torch.zeros_like, params), comp=None)
    losses = []
    for b in batches:
        shard = {k: torch.tensor(v.reshape((W, -1) + v.shape[1:])[rank])
                 for k, v in b.items()}
        params, ef, m = step(params, ef, shard, seed=ZOO_SEED)
        losses.append(m["lm_loss"].item())
    out = {"losses": losses, "draws": _draws_digest(params, len(batches)),
           "digests": {k: _digest(t) for k, t in (
               ("params", params), ("momentum", ef.momentum))}}
    if rank == 0:
        out["params"] = bridge.to_numpy(params)
    return out


def _rank_device_rules():
    """(d): a gloo group refuses CUDA tensors."""
    try:
        dist.DistBackend().check_device(torch.device("cuda"))
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, rdzv, inputs, results):
    torch.set_num_threads(1)
    try:
        tdist.init_process_group(
            "gloo", init_method=f"file://{rdzv}", world_size=W, rank=rank,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
        out = {"backend": _rank_backend(rank, inputs["backend"]),
               "device_rules": _rank_device_rules()}
        for path in STEPS:
            out[path] = _rank_steps(rank, path, inputs["start"][path],
                                    inputs["batches"][path])
        for name in ZOO_STEPS:
            out[name] = _rank_zoo(rank, name, inputs["start"]["powersgd"]["params"],
                                  inputs["batches"][name])
        out["warmup"] = _rank_steps(rank, "powersgd", inputs["start"]["warmup"],
                                    inputs["batches"]["warmup"],
                                    start_compress_step=WARMUP_K)
        out["adaptive"] = _rank_adaptive(rank, inputs["start"]["powersgd"],
                                         inputs["batches"]["adaptive"])
        out["bf16"] = _rank_steps(rank, "bf16", inputs["start"]["powersgd"],
                                  inputs["batches"]["bf16"])
        for path in ("stale", "stale_serial"):
            out[path] = _rank_steps(rank, path, inputs["start"]["powersgd"],
                                    inputs["batches"]["stale"])
        out["sync_backend"] = _rank_sync(rank, inputs["backend"])
        out["sync"] = _rank_steps(rank, "sync", inputs["start"]["powersgd"],
                                  inputs["batches"]["sync"])
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the reference's run, the ranks, the comparisons
# ---------------------------------------------------------------------------

def _np_tree(t, index=None):
    import jax

    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x if index is None else x[index]),
        t, is_leaf=lambda x: x is None)


def _reference(path, start_compress_step=0):
    """The reference's W-worker step on ``path`` and its initial state."""
    import jax

    from repro.configs import llama3_8b as jllama
    from repro.core import compressors as jcomp
    from repro.core import dist as jdist
    from repro.core.simmesh import SimMesh as JSimMesh
    from repro.launch import train as jtrain

    sim, jstats = JSimMesh(W), jdist.CollectiveStats()
    comp = (jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
            if path == "top_k" else None)
    orth = "cholesky_qr" if path == "cholesky_qr" else "gram_schmidt"
    step, init = jtrain.make_sim_train_step(
        jllama.reduced_config(), sim,
        jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2,
                          start_compress_step=start_compress_step,
                          orthogonalizer=orth),
        compressor=comp, stats=jstats)
    params, ef = init(jax.random.key(0))
    return sim, step, jstats, params, ef


def _reference_steps(sim, step, jstats, params, ef, batches):
    import jax

    losses = []
    for i, b in enumerate(batches):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        losses.append(float(m["lm_loss"][0]))
    return {"losses": losses, "params": _np_tree(params, 0),
            "momentum": _np_tree(ef.momentum, 0), "q": _np_tree(ef.comp, 0),
            "error": _np_tree(ef.error), "records": _records(jstats)}


def _run_ranks():
    """Start the W ranks, run the reference meanwhile, collect both."""
    vocab = llama3_8b.reduced_config().vocab_size
    batches = {p: _batches(vocab, n) for p, n in {**STEPS, **ZOO_STEPS}.items()}
    batches["warmup"] = _batches(vocab, WARMUP_STEPS)
    batches["adaptive"] = _batches(vocab, RANK_STEPS)
    batches["bf16"] = _batches(vocab, BF16_STEPS)
    batches["stale"] = _batches(vocab, STALE_STEPS)
    batches["sync"] = _batches(vocab, SYNC_STEPS)
    refs = {p: _reference(p) for p in STEPS}
    refs["warmup"] = _reference("powersgd", start_compress_step=WARMUP_K)
    starts = {p: {"params": _np_tree(r[3], 0), "comp": _np_tree(r[4].comp, 0)}
              for p, r in refs.items()}
    inputs = {"backend": _backend_inputs(), "start": starts, "batches": batches}

    results = mp.get_context("spawn").Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _rank_main, args=(os.path.join(tmp, "rdzv"), inputs, results),
            nprocs=W, join=False, start_method="spawn")
        deadline = time.monotonic() + RESULTS_S
        try:
            # the reference runs while the ranks do
            reference = {p: _reference_steps(*refs[p], batches[p]) for p in refs}
            ranks = {}
            while len(ranks) < W:
                try:
                    rank, out = results.get(
                        timeout=max(1.0, deadline - time.monotonic()))
                except queue.Empty:
                    pytest.fail(f"ranks {sorted(set(range(W)) - set(ranks))} "
                                f"sent no result within {RESULTS_S} s")
                if isinstance(out, str):
                    pytest.fail(f"rank {rank} failed:\n{out}")
                ranks[rank] = out
            for p in procs.processes:
                p.join(timeout=10)
                assert not p.is_alive() and p.exitcode == 0, (p.pid, p.exitcode)
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
    return {"inputs": inputs, "ranks": ranks, "reference": reference}


@pytest.fixture(scope="module")
def run():
    if not (tdist.is_available() and tdist.is_gloo_available()):
        pytest.skip("torch.distributed with gloo is not available")
    if "spawn" not in mp.get_all_start_methods():
        pytest.skip("multiprocessing cannot spawn processes here")
    return _run_ranks()


# ---------------------------------------------------------------------------
# (a) the backend against the simulation
# ---------------------------------------------------------------------------

def _sim_ctx():
    stats = dist.CollectiveStats()
    return SimMesh(W).ctx(stats=stats), stats


def test_context_shape(run):
    for r in range(W):
        assert run["ranks"][r]["backend"]["lead"] == ()
        assert run["ranks"][r]["backend"]["data_size"] == W


def test_reduces_leave_inputs_unchanged(run):
    """A mean returns a new tensor, as the simulated one does: the float64
    part rides a chunk of its own under the ``auto`` wire, whose wire
    buffer is the part itself, and is all-reduced through a copy."""
    for r in range(W):
        assert all(run["ranks"][r]["backend"]["inputs_unchanged"])


def test_pmean_data_matches_sim(run):
    ctx, stats = _sim_ctx()
    want = ctx.pmean_data(torch.tensor(run["inputs"]["backend"]["data"])).numpy()
    for r in range(W):
        got = run["ranks"][r]["backend"]
        np.testing.assert_allclose(got["pmean_data"], want, atol=REDUCE_ATOL, rtol=0)
        assert got["pmean_data_records"] == _records(stats)


@pytest.mark.parametrize("wire", WIRES)
def test_pmean_flat_matches_sim(run, wire):
    ctx, stats = _sim_ctx()
    parts = [torch.tensor(p) for p in run["inputs"]["backend"]["reduce"]]
    want = [x.numpy() for x in ctx.pmean_flat(parts, wire_dtype=wire)]
    inputs = run["inputs"]["backend"]["reduce"]
    for r in range(W):
        got, records = run["ranks"][r]["backend"][("reduce", wire)]
        for i, (g, w_) in enumerate(zip(got, want)):
            assert g.dtype == w_.dtype and g.shape == w_.shape, i
            atol = (bf16_reduce_tol(inputs[i]) if wire == "bfloat16"
                    else REDUCE_ATOL)
            assert np.all(np.abs(g - w_) <= atol), f"rank {r} part {i}"
        assert records == _records(stats)
    if wire == "bfloat16":
        assert _records(stats)[2] == [2]    # every float part, float64 too


@pytest.mark.parametrize("wire", WIRES)
def test_allgather_flat_matches_sim(run, wire):
    ctx, stats = _sim_ctx()
    parts = [torch.tensor(p) for p in run["inputs"]["backend"]["gather"]]
    want = [x.numpy() for x in ctx.allgather_flat(parts, wire_dtype=wire)]
    for r in range(W):
        got, records = run["ranks"][r]["backend"][("gather", wire)]
        for i, (g, w_) in enumerate(zip(got, want)):
            assert g.dtype == w_.dtype, i
            np.testing.assert_array_equal(g, w_, err_msg=f"rank {r} part {i}")
        assert records == _records(stats)
    assert stats.kinds == ["gather"] * len(stats.kinds)
    assert set(stats.fanouts) == {W}


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_payloads_bitexact(run, wire):
    """The gathered integer codes and scale sidecar of a quantized chunk
    equal the simulation's stacked ``(W, bytes)`` payload bit for bit."""
    parts = [torch.tensor(p) for p in run["inputs"]["backend"]["gather"]]
    payload, scales = mz.quant_pack_flat(_quant_chunk(parts, wire, 1), parts,
                                         lead=1)
    for r in range(W):
        got_payload, got_scales = run["ranks"][r]["backend"][("payload", wire)]
        assert got_payload.dtype == payload.numpy().dtype
        np.testing.assert_array_equal(got_payload, payload.numpy())
        np.testing.assert_array_equal(got_scales, scales.numpy())


@pytest.mark.parametrize("wire", WIRES)
def test_interleaved_reduce_is_the_serial_schedule(run, wire):
    """(a): ``pmean_flat(interleave=True)`` over the process group, each
    chunk's ``all_reduce`` issued asynchronously and waited on just before
    its unpack: the serial schedule's bits, records and calls, with at
    least 4 chunks."""
    for r in range(W):
        (serial, s_records, s_calls), (inter, i_records, i_calls) = (
            run["ranks"][r]["backend"][("chunked reduce", wire)])
        assert i_records == s_records and i_calls == s_calls
        assert len(s_records[0]) >= 4 and s_calls["all_reduce"] == len(s_records[0])
        for a, b in zip(serial, inter):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# (b) steps against the reference, (c) replicas identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(STEPS))
def test_steps_match_reference(run, path):
    """Losses at rtol 1e-5 and parameters at atol 2e-6, as the simulated
    step is held; momentum and Q factors at atol 1e-5.

    Measured on these inputs: losses within 1.3e-7 relative and parameters
    within 3.1e-7 on both paths.  After 5 PowerSGD steps the momentum is
    within 1.5e-6 and Q within 5.2e-6 (entries up to about 0.2): float32
    sums in another order reach P, and Gram-Schmidt amplifies them into Q
    and the aggregate.  The port's own ``make_sim_train_step`` is as far
    from the reference on the same inputs (momentum 1.5e-6, Q 4.7e-6)."""
    ref = run["reference"][path]
    for r in range(W):
        got = run["ranks"][r][path]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
        assert got["step"] == STEPS[path]
    got = run["ranks"][0][path]
    for name in ("params", "momentum", "q"):
        if ref[name] is None:
            assert got[name] is None
            continue
        for (p, g), w_ in zip(tree.items(got[name]), tree.leaves(ref[name])):
            if w_ is None:
                assert g is None, p
                continue
            atol = PARAM_ATOL if name == "params" else STATE_ATOL
            np.testing.assert_allclose(g, w_, atol=atol, rtol=0,
                                       err_msg=f"{name} {list(p)}")


@pytest.mark.parametrize("path", list(STEPS))
def test_error_buffers_match_reference(run, path):
    """Rank i's error buffer is the reference's ``error[i]``, at atol 1e-5.
    Measured: within 2.4e-6 (PowerSGD) and 1.2e-6 (Top-K/int4); the port's
    simulated step, 2.5e-6 and 1.5e-6."""
    ref = run["reference"][path]["error"]
    for r in range(W):
        for (p, g), w_ in zip(tree.items(run["ranks"][r][path]["error"]),
                              tree.leaves(ref)):
            np.testing.assert_allclose(g, w_[r], atol=STATE_ATOL, rtol=0,
                                       err_msg=f"rank {r} {list(p)}")


@pytest.mark.parametrize("path", list(STEPS))
def test_replicas_stay_identical(run, path):
    digests = [run["ranks"][r][path]["digests"] for r in range(W)]
    assert all(d == digests[0] for d in digests), digests


@pytest.mark.parametrize("path", list(STEPS))
def test_collectives_match_reference(run, path):
    """Each step records what the reference's one trace records: PowerSGD 2
    reduces, Top-K/int4 1 reduce and 2 gathers.  The real calls per step
    add the loss's all-reduce, and a quantized gather's scale sidecar
    travels in a call of its own."""
    ref = run["reference"][path]["records"]
    want_calls = {"powersgd": {"all_reduce": 3, "all_gather": 0, "broadcast": 0},
                  "cholesky_qr": {"all_reduce": 3, "all_gather": 0, "broadcast": 0},
                  "top_k": {"all_reduce": 2, "all_gather": 3, "broadcast": 0}}[path]
    for r in range(W):
        got = run["ranks"][r][path]
        assert got["records"] == [ref] * STEPS[path]
        assert got["calls"] == {k: v * STEPS[path] for k, v in want_calls.items()}
    kinds = ref[0]
    assert ((kinds.count("reduce"), kinds.count("gather"))
            == {"powersgd": (2, 0), "cholesky_qr": (2, 0), "top_k": (1, 2)}[path])


# ---------------------------------------------------------------------------
# (e) shared-seed and gather schemes of the zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ZOO_STEPS))
def test_zoo_replicas_and_draws_agree(run, name):
    """The same draws on every rank and in this process; bit-identical
    replicas; each rank's losses and rank 0's parameters as on
    ``SimMesh(4)``."""
    start = bridge.to_torch(run["inputs"]["start"]["powersgd"]["params"])
    mine = _draws_digest(start, ZOO_STEPS[name])
    ranks = [run["ranks"][r][name] for r in range(W)]
    assert all(o["draws"] == mine for o in ranks)
    assert all(o["digests"] == ranks[0]["digests"] for o in ranks)
    step, _ = train.make_sim_train_step(
        llama3_8b.reduced_config(), SimMesh(W), _hyper(),
        compressors.make_compressor(name, rank=2), device="cpu")
    params = start
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params), comp=None)
    losses = []
    for b in run["inputs"]["batches"][name]:
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}), seed=ZOO_SEED)
        losses.append(m["lm_loss"].item())
    for o in ranks:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    for (p, g), w_ in zip(tree.items(ranks[0]["params"]),
                          tree.leaves(bridge.to_numpy(params))):
        np.testing.assert_allclose(g, w_, atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(list(p)))


# ---------------------------------------------------------------------------
# (h) the bfloat16 wire
# ---------------------------------------------------------------------------

def test_bf16_wire_steps_match_sim(run):
    """``BF16_STEPS`` PowerSGD steps on the bfloat16 wire: the replicas stay
    bit-identical and record 2 reduces of itemsize 2 a step; each rank's
    losses within BF16_LOSS_RTOL and rank 0's parameters within
    BF16_PARAM_ATOL of ``SimMesh(4)``.  gloo sums the 4 bfloat16 buffers
    in its own order, the simulation folds them in worker order, so some P
    and Q elements round to a neighbouring bfloat16 (2⁻⁸ relative) and
    the update moves by lr times that, a whole row or column of it for a
    flipped Q element.  Measured on these inputs (``python
    tests/test_torch_dist.py``): losses 6.5e-8 relative, parameters up to
    7.5e-5 apart, 110,828 of 1,705,216 beyond the float32 wire's 2e-6."""
    digests = [run["ranks"][r]["bf16"]["digests"] for r in range(W)]
    assert all(d == digests[0] for d in digests)
    stats = dist.CollectiveStats()
    losses, params = _bf16_sim_steps(run, stats)
    for r in range(W):
        got = run["ranks"][r]["bf16"]
        np.testing.assert_allclose(got["losses"], losses, rtol=BF16_LOSS_RTOL)
        assert got["records"] == [got["records"][0]] * BF16_STEPS
        assert got["records"][0][:3] == (["reduce"] * 2, stats.sizes[:2], [2, 2])
        assert got["calls"] == {"all_reduce": 3 * BF16_STEPS, "all_gather": 0,
                                "broadcast": 0}
    for (p, g), w_ in zip(tree.items(run["ranks"][0]["bf16"]["params"]),
                          tree.leaves(params)):
        np.testing.assert_allclose(g, w_, atol=BF16_PARAM_ATOL, rtol=0,
                                   err_msg=str(list(p)))


def _bf16_sim_steps(run, stats=None):
    """(h)'s steps on ``SimMesh(4)``: losses and the final parameters."""
    start = run["inputs"]["start"]["powersgd"]
    step, _ = train.make_sim_train_step(
        llama3_8b.reduced_config(), SimMesh(W), _hyper(), _compressor("bf16"),
        stats=stats, device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    losses = []
    for b in run["inputs"]["batches"]["bf16"]:
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    return losses, bridge.to_numpy(params)


# ---------------------------------------------------------------------------
# (i) one-step staleness
# ---------------------------------------------------------------------------

def test_one_step_steps_match_sim_and_serial_schedule(run):
    """The pipelined transport's asynchronous reduces give the serial
    transport's run bit for bit on every rank (losses, parameters,
    momentum, factors, in-flight aggregate), with the same records and
    ``torch.distributed`` calls: one per wire chunk and one for the loss.
    The replicas stay bit-identical; each rank's losses within 1e-5 and
    rank 0's parameters within 2e-6 of ``SimMesh(4)`` on the same path,
    its momentum, factors and in-flight aggregate within 1e-5."""
    for r in range(W):
        got, serial = run["ranks"][r]["stale"], run["ranks"][r]["stale_serial"]
        assert got["losses"] == serial["losses"]
        assert got["digests"] == serial["digests"]
        assert got["digests"] == run["ranks"][0]["stale"]["digests"]
        assert got["records"] == serial["records"]
        assert got["calls_after_step"] == serial["calls_after_step"]
        chunks = len(got["records"][0][0])
        assert chunks > 2 and got["records"] == [got["records"][0]] * STALE_STEPS
        assert got["calls"] == {"all_reduce": (chunks + 1) * STALE_STEPS,
                                "all_gather": 0, "broadcast": 0}
    start = run["inputs"]["start"]["powersgd"]
    stats = dist.CollectiveStats()
    step, _ = train.make_sim_train_step(
        llama3_8b.reduced_config(), SimMesh(W), _hyper(path="stale"),
        _compressor("stale"), stats=stats, device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]),
                 inflight=tree.map(torch.zeros_like, params))
    losses = []
    for b in run["inputs"]["batches"]["stale"]:
        stats.reset()
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    got = run["ranks"][0]["stale"]
    assert got["records"][-1] == _records(stats)
    for r in range(W):
        np.testing.assert_allclose(run["ranks"][r]["stale"]["losses"], losses,
                                   rtol=LOSS_RTOL)
    for name, want, atol in (("params", params, PARAM_ATOL),
                             ("momentum", ef.momentum, STATE_ATOL),
                             ("q", ef.comp, STATE_ATOL),
                             ("inflight", ef.inflight, STATE_ATOL)):
        for (p, g), w_ in zip(tree.items(got[name]),
                              tree.leaves(bridge.to_numpy(want))):
            if w_ is None:
                assert g is None, p
                continue
            np.testing.assert_allclose(g, w_, atol=atol, rtol=0,
                                       err_msg=f"{name} {list(p)}")
    assert any(np.abs(x).max() > 0 for x in tree.leaves(got["inflight"]))


# ---------------------------------------------------------------------------
# (j) sync_mode="broadcast"
# ---------------------------------------------------------------------------

def _sim_sync_ctx():
    stats = dist.CollectiveStats()
    return SimMesh(W).ctx(stats=stats, sync_mode="broadcast"), stats


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_sync_reduces_bit_equal_to_sim(run):
    """The canonical reduce over the process group (each chunk one
    ``all_gather``, the rows summed in the tree on every rank) is the
    simulation's bit for bit on the same rows, serial and interleaved, on
    every wire of ``SYNC_WIRES`` (bfloat16 too, where a library sum would
    not be), with the same records; ``sync=False`` records the reduce
    alone."""
    inputs = run["inputs"]["backend"]
    ctx, stats = _sim_sync_ctx()
    data = torch.tensor(inputs["data"])
    want = [ctx.pmean_data(data).numpy(), ctx.psum_data(data).numpy(),
            ctx.pmean_data(data, sync=False).numpy()]
    want_records = _records(stats)
    for r in range(W):
        got, records, calls = run["ranks"][r]["sync_backend"]["data"]
        for g, w_ in zip(got, want):
            _same_bits(g, w_)
        assert records == want_records
        assert calls == {"all_reduce": 0, "all_gather": 3, "broadcast": 0}
    assert want_records[0] == ["reduce", "broadcast", "reduce", "broadcast",
                               "reduce"]
    for wire in SYNC_WIRES:
        ctx, stats = _sim_sync_ctx()
        want = ctx.pmean_flat([torch.tensor(p) for p in inputs["reduce"]],
                              wire_dtype=wire, max_chunk_bytes=_reduce_cap(wire))
        for r in range(W):
            for got, records, calls in run["ranks"][r]["sync_backend"][("reduce", wire)]:
                for g, w_ in zip(got, want):
                    _same_bits(g, w_.numpy())
                assert records == _records(stats)
                chunks = stats.reduce_collectives
                assert chunks >= 4 and calls == {"all_reduce": 0,
                                                 "all_gather": chunks,
                                                 "broadcast": 0}
        assert stats.broadcast_collectives == stats.reduce_collectives


def test_sync_broadcast_bits(run):
    """``broadcast_flat`` over the process group: +0.0 for −0.0 at W = 4
    (the simulation's and the reference's bits), the NaN kept, and rank
    0's row where the ranks' rows differ; one ``broadcast`` call a
    chunk."""
    ctx, stats = _sim_sync_ctx()
    want = [ctx.broadcast_flat([torch.tensor(SIGNED)])[0].numpy()] + [
        x.numpy() for x in ctx.broadcast_flat(
            [torch.tensor(p) for p in run["inputs"]["backend"]["reduce"][:2]],
            stacked=True)]
    assert list(want[0].view(np.uint32)) == [0, 0, 0x3FC00000, 0xC0000000,
                                             0x7FC00000]
    for r in range(W):
        got, records, calls = run["ranks"][r]["sync_backend"]["broadcast"]
        for g, w_ in zip(got, want):
            _same_bits(g, w_)
        np.testing.assert_array_equal(got[1], run["inputs"]["backend"]["reduce"][0][0])
        assert records == _records(stats)
        assert calls == {"all_reduce": 0, "all_gather": 0,
                         "broadcast": len(records[0])}


def _leaf_counts(run):
    params = bridge.to_torch(run["inputs"]["start"]["powersgd"]["params"])
    comp = bridge.to_torch(run["inputs"]["start"]["powersgd"]["comp"])
    return (len(tree.leaves(params)),
            sum(q is not None for q in tree.leaves(comp)))


def test_sync_steps_identical_across_ranks(run):
    """``SYNC_STEPS`` PowerSGD steps under ``TrainHyper(sync_mode=
    "broadcast", track_drift=True)``: parameters, momentum and factors
    bit-identical on the 4 ranks, their drift exactly 0.0 in every step's
    metrics, the error buffers' drift positive and the same on every
    rank.  Records a step: 2 reduces and 1 broadcast (P̂ + Q + the
    uncompressed leaves).  Calls a step: 2 ``all_gather`` (the canonical
    reduces), 1 ``broadcast`` for the fused sync plus one per float leaf
    the drift probe compares (parameters, momentum and error buffers, and
    each factor), and ``all_reduce`` once for the loss and once for each
    of the probe's 4 maxima."""
    n_params, n_factors = _leaf_counts(run)
    want_calls = {"all_reduce": 1 + 4, "all_gather": 2,
                  "broadcast": 1 + 3 * n_params + n_factors}
    ranks = [run["ranks"][r]["sync"] for r in range(W)]
    assert all(o["digests"] == ranks[0]["digests"] for o in ranks)
    for o in ranks:
        assert o["step"] == SYNC_STEPS
        for i, d in enumerate(o["drifts"]):
            assert d["drift_params"] == d["drift_momentum"] == d["drift_q"] == 0.0
            assert d["drift_error"] == ranks[0]["drifts"][i]["drift_error"] > 0.0
        assert o["records"] == [o["records"][0]] * SYNC_STEPS
        kinds, sizes = o["records"][0][:2]
        assert kinds == ["reduce", "reduce", "broadcast"]
        assert sizes[2] == sizes[0] + sizes[1]
        assert o["calls"] == {k: v * SYNC_STEPS for k, v in want_calls.items()}


def test_sync_steps_match_sim(run):
    """Each rank within (b)'s tolerances of the port's ``SimMesh(4)`` run
    under the mode from the same state: losses rtol 1e-5, parameters atol
    2e-6, momentum and factors atol 1e-5; the same records and drifts of
    0.0, the error buffers' drift within 2e-5."""
    start = run["inputs"]["start"]["powersgd"]
    stats = dist.CollectiveStats()
    step, _ = train.make_sim_train_step(
        llama3_8b.reduced_config(), SimMesh(W), _hyper(path="sync"),
        stats=stats, device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    losses, drifts = [], []
    for b in run["inputs"]["batches"]["sync"]:
        stats.reset()
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
        drifts.append({k: v.item() for k, v in m.items() if k.startswith("drift_")})
    got = run["ranks"][0]["sync"]
    assert got["records"][-1] == _records(stats)
    for r in range(W):
        np.testing.assert_allclose(run["ranks"][r]["sync"]["losses"], losses,
                                   rtol=LOSS_RTOL)
    for g, w_ in zip(got["drifts"], drifts):
        assert w_["drift_params"] == w_["drift_momentum"] == w_["drift_q"] == 0.0
        np.testing.assert_allclose(g["drift_error"], w_["drift_error"],
                                   atol=2 * STATE_ATOL, rtol=0)
    for name, want, atol in (("params", params, PARAM_ATOL),
                             ("momentum", ef.momentum, STATE_ATOL),
                             ("q", ef.comp, STATE_ATOL)):
        for (p, g), w_ in zip(tree.items(got[name]),
                              tree.leaves(bridge.to_numpy(want))):
            if w_ is None:
                assert g is None, p
                continue
            np.testing.assert_allclose(g, w_, atol=atol, rtol=0,
                                       err_msg=f"{name} {list(p)}")


# ---------------------------------------------------------------------------
# (f) the dense warm-up
# ---------------------------------------------------------------------------

def test_warmup_steps_match_reference(run):
    """Losses rtol 1e-5 and parameters atol 2e-6; momentum, Q factors and
    rank i's error buffer (the reference's ``error[i]``) atol 1e-5, as in
    (b).  Every rank's error buffers are exactly 0 after the dense steps
    and move from step k on."""
    ref = run["reference"]["warmup"]
    for r in range(W):
        got = run["ranks"][r]["warmup"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
        assert got["step"] == WARMUP_STEPS
        assert got["error_zero"] == [True] * WARMUP_K + [False] * (
            WARMUP_STEPS - WARMUP_K)
        for (p, g), w_ in zip(tree.items(got["error"]), tree.leaves(ref["error"])):
            np.testing.assert_allclose(g, w_[r], atol=STATE_ATOL, rtol=0,
                                       err_msg=f"rank {r} {list(p)}")
    got = run["ranks"][0]["warmup"]
    for name in ("params", "momentum", "q"):
        for (p, g), w_ in zip(tree.items(got[name]), tree.leaves(ref[name])):
            if w_ is None:
                assert g is None, p
                continue
            atol = PARAM_ATOL if name == "params" else STATE_ATOL
            np.testing.assert_allclose(g, w_, atol=atol, rtol=0,
                                       err_msg=f"{name} {list(p)}")


def test_warmup_replicas_stay_identical(run):
    digests = [run["ranks"][r]["warmup"]["digests"] for r in range(W)]
    assert all(d == digests[0] for d in digests), digests


def test_warmup_collectives(run):
    """A dense step records one reduce of the whole gradient (one float32
    wire chunk) and calls ``all_reduce`` for it and for the loss; a
    compressed step records PowerSGD's two reduces, as in (b).  A dense and
    a compressed step together record what the reference's one trace
    records: its switch traces both branches."""
    ref = run["reference"]["warmup"]["records"]
    n_params = sum(x.size for x in tree.leaves(run["inputs"]["start"]["warmup"]["params"]))
    for r in range(W):
        got = run["ranks"][r]["warmup"]
        dense, compressed = got["records"][0], got["records"][WARMUP_K]
        assert got["records"] == [dense] * WARMUP_K + [compressed] * (
            WARMUP_STEPS - WARMUP_K)
        assert dense[0] == ["reduce"] and dense[1] == [n_params]
        assert compressed == run["ranks"][r]["powersgd"]["records"][0]
        assert tuple(a + b for a, b in zip(dense, compressed)) == ref
        per_step = [c["all_reduce"] for c in got["calls_after_step"]]
        assert np.diff([0] + per_step).tolist() == [2] * WARMUP_K + [3] * (
            WARMUP_STEPS - WARMUP_K)
        assert got["calls"]["all_gather"] == 0


# ---------------------------------------------------------------------------
# (g) adaptive rank
# ---------------------------------------------------------------------------

def test_adaptive_rank_ranks_agree_and_match_sim(run):
    """Every rank takes the staircase's switches at the same steps with the
    same residuals and bit-identical factors after every step; the run
    matches ``SimMesh(4)`` driven the same way."""
    ranks = [run["ranks"][r]["adaptive"] for r in range(W)]
    for o in ranks[1:]:
        assert o["history"] == ranks[0]["history"]
        assert o["steps"] == ranks[0]["steps"]     # ranks, losses, residuals, Q
        assert o["digests"] == ranks[0]["digests"]
    assert ranks[0]["history"] == [(0, 2), (1, 4), (3, 1)]
    assert [s[0] for s in ranks[0]["steps"]] == [2, 4, 4, 1]
    step, _ = train.make_sim_train_step(llama3_8b.reduced_config(), SimMesh(W),
                                        _hyper(), _rank_comp(), device="cpu")
    start = run["inputs"]["start"]["powersgd"]
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    shards = [SimMesh(W).shard({k: torch.tensor(v) for k, v in b.items()})
              for b in run["inputs"]["batches"]["adaptive"]]
    params, ef, sim_steps, history = _controlled_steps(step, params, ef, shards)
    assert history == ranks[0]["history"]
    got = ranks[0]["steps"]
    np.testing.assert_allclose([s[1] for s in got], [s[1] for s in sim_steps],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in sim_steps],
                               rtol=1e-5)
    for name, want, atol in (("params", params, PARAM_ATOL),
                             ("momentum", ef.momentum, STATE_ATOL),
                             ("q", ef.comp, STATE_ATOL)):
        for (p, g), w_ in zip(tree.items(ranks[0][name]),
                              tree.leaves(bridge.to_numpy(want))):
            if w_ is None:
                assert g is None, p
                continue
            assert g.shape == w_.shape, (name, p)
            np.testing.assert_allclose(g, w_, atol=atol, rtol=0,
                                       err_msg=f"{name} {list(p)}")


# ---------------------------------------------------------------------------
# (d) device rules
# ---------------------------------------------------------------------------

def test_default_device_raises_without_card():
    """Without ``device=`` the step runs on the card, and raises where there
    is none, before it looks for a process group."""
    if torch.cuda.is_available():
        assert train.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.make_train_step(llama3_8b.reduced_config(), _hyper())


def test_backend_device_mismatch_raises(run):
    msg = run["ranks"][0]["device_rules"]
    assert msg is not None and "'gloo'" in msg and "cuda" in msg and "'nccl'" in msg
    with pytest.raises(ValueError, match="'nccl' process group cannot carry cpu"):
        dist.check_backend_device("nccl", "cpu")
    dist.check_backend_device("gloo", "cpu")
    dist.check_backend_device("nccl", torch.device("cuda", 0))


def _sim_port_steps(out, path):
    """The port's ``make_sim_train_step`` at W = 4 from the ranks' start."""
    step, _ = train.make_sim_train_step(
        llama3_8b.reduced_config(), SimMesh(W), _hyper(path=path),
        _compressor(path), device="cpu")
    start = out["inputs"]["start"][path]
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    losses = []
    for b in out["inputs"]["batches"][path]:
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    return {"losses": losses, "params": bridge.to_numpy(params),
            "momentum": bridge.to_numpy(ef.momentum), "q": bridge.to_numpy(ef.comp),
            "error": [bridge.to_numpy(tree.map(lambda x: x[r], ef.error))
                      for r in range(W)]}


if __name__ == "__main__":
    # the worst cases quoted above: the distributed step, and the port's
    # simulated step on the same inputs, each against the reference
    out = _run_ranks()

    def gap(a, b):
        return max(float(np.abs(x - y).max()) for x, y in
                   zip(tree.leaves(a), tree.leaves(b)) if x is not None)

    got, want = _bf16_sim_steps(out)
    d = [np.abs(g - w_) for g, w_ in zip(tree.leaves(out["ranks"][0]["bf16"]["params"]),
                                         tree.leaves(want))]
    print(f"bf16 wire, distributed vs SimMesh(4): loss rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(got, out['ranks'][0]['bf16']['losses'])):.2e}, "
          f"params max {max(float(x.max()) for x in d):.2e}, beyond {PARAM_ATOL}: "
          f"{sum(int((x > PARAM_ATOL).sum()) for x in d)} of {sum(x.size for x in d)}",
          flush=True)
    for path in STEPS:
        ref, sim = out["reference"][path], _sim_port_steps(out, path)
        dist_run = dict(out["ranks"][0][path],
                        error=[out["ranks"][r][path]["error"] for r in range(W)])
        for label, got in (("distributed", dist_run), ("simulated", sim)):
            loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
            gaps = {name: gap(got[name], ref[name])
                    for name in ("params", "momentum", "q") if ref[name] is not None}
            gaps["error"] = max(gap(got["error"][r], tree.map(
                lambda x: None if x is None else x[r], ref["error"])) for r in range(W))
            print(f"{path}, {label} vs reference: loss rel {loss:.2e}, "
                  + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()), flush=True)
