"""The ``torch.distributed`` data-parallel step: 4 gloo processes on the CPU,
one worker each, started once for the whole file.

* (a) :class:`~repro_torch.core.dist.DistBackend` against
  :class:`~repro_torch.core.dist.SimBackend` on the same inputs (rank i's
  input is row i of the simulation's stacked input): ``pmean_data``,
  ``pmean_flat`` and ``allgather_flat`` on the ``auto``, ``float32``,
  ``int8`` and ``int4`` wires.  Reduces within 1e-6 (gloo sums in another
  order than ``mean``), gathers and quantized payloads bit-equal,
  ``CollectiveStats`` records equal.
* (b) ``make_train_step`` at W = 4 against the reference's
  ``repro.launch.train.make_sim_train_step`` at W = 4, from the same
  parameters and Q factors on the same batches (rank i takes row i of the
  reference's per-worker batch): 5 PowerSGD steps and 3 Top-K steps on the
  int4 gather wire, under the tolerances of ``tests/test_torch_train.py``
  and ``tests/test_torch_topk.py`` (loss rtol 1e-5, parameters atol 2e-6).
  Momentum, Q factors and rank i's error buffer (against the reference's
  ``error[i]``) need more: atol 1e-5 (see
  :func:`test_steps_match_reference`).
* (c) After (b), parameters, momentum and Q factors are bit-identical on
  the 4 ranks, as the reference finds cross-replica drift exactly 0 under
  a plain all-reduce.
* (d) The entry point's device rules: the CUDA default raises where there
  is no card, and a process group whose backend does not carry the
  device's tensors raises.

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
from repro_torch.core import compressors, dist, matrixize as mz
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train

pytestmark = pytest.mark.timeout(180)

W, BATCH, SEQ = 4, 8, 32
STEPS = {"powersgd": 5, "top_k": 3}
WIRES = ("auto", "float32", "int8", "int4")
RENDEZVOUS_S = 60     # init_process_group and every collective
RESULTS_S = 140       # from the spawn to the last rank's result
REDUCE_ATOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
STATE_ATOL = 1e-5     # momentum, Q factors, error buffers


def _compressor(path):
    """``None``: the step's default, rank-2 PowerSGD."""
    if path == "top_k":
        return compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
    return None


def _hyper():
    return train.TrainHyper(q_chunk=16, warmup_steps=2)


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
        stats.reset()
        gat = ctx.allgather_flat(mine(inputs["gather"]), wire_dtype=wire)
        out[("gather", wire)] = ([x.numpy() for x in gat], _records(stats))
        if wire in ("int8", "int4"):
            parts = mine(inputs["gather"])
            payload, scales = mz.quant_pack_flat(_quant_chunk(parts, wire, 0), parts)
            out[("payload", wire)] = (ctx.backend.all_gather(payload).numpy(),
                                      ctx.backend.all_gather(scales).numpy())
    return out


def _rank_steps(rank, path, start, batches):
    """(b), (c): the distributed step on this rank's shard of each batch."""
    cfg = llama3_8b.reduced_config()
    stats = dist.CollectiveStats()
    step, _ = train.make_train_step(cfg, _hyper(), _compressor(path),
                                    stats=stats, device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(torch.zeros_like, params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    losses, records = [], []
    dist.reset_calls()
    for b in batches:
        stats.reset()
        shard = {k: torch.tensor(v.reshape((W, -1) + v.shape[1:])[rank])
                 for k, v in b.items()}
        params, ef, m = step(params, ef, shard)
        losses.append(m["lm_loss"].item())
        records.append(_records(stats))
    out = {"losses": losses, "records": records, "step": ef.step,
           "calls": dict(dist.CALLS), "error": bridge.to_numpy(ef.error),
           "digests": {k: _digest(t) for k, t in (
               ("params", params), ("momentum", ef.momentum), ("q", ef.comp))}}
    if rank == 0:
        out.update(params=bridge.to_numpy(params),
                   momentum=bridge.to_numpy(ef.momentum),
                   q=bridge.to_numpy(ef.comp))
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


def _reference(path):
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
    step, init = jtrain.make_sim_train_step(
        jllama.reduced_config(), sim,
        jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2),
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
    batches = {p: _batches(vocab, n) for p, n in STEPS.items()}
    refs = {p: _reference(p) for p in STEPS}
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
            reference = {p: _reference_steps(*refs[p], batches[p]) for p in STEPS}
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
    for r in range(W):
        got, records = run["ranks"][r]["backend"][("reduce", wire)]
        for i, (g, w_) in enumerate(zip(got, want)):
            assert g.dtype == w_.dtype and g.shape == w_.shape, i
            np.testing.assert_allclose(g, w_, atol=REDUCE_ATOL, rtol=0,
                                       err_msg=f"rank {r} part {i}")
        assert records == _records(stats)


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
    want_calls = {"powersgd": {"all_reduce": 3, "all_gather": 0},
                  "top_k": {"all_reduce": 2, "all_gather": 3}}[path]
    for r in range(W):
        got = run["ranks"][r][path]
        assert got["records"] == [ref] * STEPS[path]
        assert got["calls"] == {k: v * STEPS[path] for k, v in want_calls.items()}
    kinds = ref[0]
    assert ((kinds.count("reduce"), kinds.count("gather"))
            == {"powersgd": (2, 0), "top_k": (1, 2)}[path])


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
        llama3_8b.reduced_config(), SimMesh(W), _hyper(), _compressor(path),
        device="cpu")
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
