"""Whole training steps under ``sync_mode="broadcast"``: reduced
Llama-3-8B at W = 4, ``TrainHyper(sync_mode="broadcast",
track_drift=True)`` in the port's ``make_sim_train_step`` against the JAX
package's on the same parameters, factors and ``MarkovLM`` batches.

Paths: PowerSGD bucketed and per leaf, ``cholesky_qr``, Top-K on the int4
wire, ``start_compress_step=1`` and one-step staleness, 3 steps each.
Losses rtol 1e-5, parameters atol 2e-6, momentum, factors and error
buffers atol 1e-5 (``tests/test_torch_train.py`` and
``tests/test_torch_dist.py``); the records of the reference's one trace
(PowerSGD: 2 reduces and 1 broadcast of P̂ + Q + the uncompressed leaves a
step); ``drift_params``, ``drift_momentum`` and ``drift_q`` exactly 0.0 in
both packages, ``drift_error`` the reference's within the error buffers'
tolerance.  The collectives themselves are ``tests/test_torch_sync.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist
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


KEY = jax.random.key(0)


def _records(stats):
    """A copy of the records (``reset`` clears the lists in place)."""
    return (list(stats.kinds), list(stats.sizes), list(stats.itemsizes),
            list(stats.fanouts), list(stats.overheads),
            stats.bytes_per_collective())



W, STEPS, BATCH, SEQ = 4, 3, 8, 32
LOSS_RTOL, PARAM_ATOL, STATE_ATOL = 1e-5, 2e-6, 1e-5
PATHS = {
    "powersgd": {},
    "per_leaf": {"bucketing": "off"},
    "cholesky_qr": {"orthogonalizer": "cholesky_qr"},
    "top_k_int4": {},
    "warmup_k1": {"start_compress_step": 1},
    "one_step": {"staleness": "one_step"},
}


def _batches(vocab):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
            for t in (data.sample(BATCH, SEQ, step=i) for i in range(STEPS))]


def _first(t, index=0):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x if index is None else x[index]),
        t, is_leaf=lambda x: x is None)


@pytest.fixture(scope="module", params=list(PATHS))
def reference_run(request):
    """The reference's steps under the mode with ``track_drift``: its start,
    per step the loss and drift metrics, its final state (worker 0's, every
    worker's error buffer) and the records of its one trace."""
    path = request.param
    sim, jstats = JSimMesh(W), jdist.CollectiveStats()
    comp = (jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
            if path == "top_k_int4" else None)
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2,
                              sync_mode="broadcast", track_drift=True,
                              **PATHS[path])
    step, init = jtrain.make_sim_train_step(jllama.reduced_config(), sim, hyper,
                                            compressor=comp, stats=jstats)
    params, ef = init(KEY)
    start = {"params": _first(params), "comp": _first(ef.comp)}
    metrics = []
    for i, b in enumerate(_batches(jllama.reduced_config().vocab_size)):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        metrics.append({k: float(v[0]) for k, v in m.items()})
    final = {"params": _first(params), "momentum": _first(ef.momentum),
             "q": _first(ef.comp), "error": _first(ef.error, None)}
    return path, start, metrics, final, _records(jstats)


def _port_run(path, start):
    cfg = llama3_8b.reduced_config()
    stats = dist.CollectiveStats()
    comp = (compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
            if path == "top_k_int4" else None)
    hyper = train.TrainHyper(q_chunk=16, warmup_steps=2, sync_mode="broadcast",
                             track_drift=True, **PATHS[path])
    step, _ = train.make_sim_train_step(cfg, SimMesh(W), hyper, compressor=comp,
                                        stats=stats, device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=None if comp is not None else bridge.to_torch(start["comp"]),
                 inflight=(tree.map(torch.zeros_like, params)
                           if hyper.staleness == "one_step" else None))
    metrics, records = [], []
    for b in _batches(cfg.vocab_size):
        stats.reset()
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
        records.append(_records(stats))
    return params, ef, metrics, records


def _close(got, want, atol, what):
    for (p, g), w_ in zip(tree.items(bridge.to_numpy(got)), tree.leaves(want)):
        if w_ is None:
            assert g is None, (what, p)
            continue
        np.testing.assert_allclose(g, w_, atol=atol, rtol=0, err_msg=f"{what} {p}")


def test_sync_steps_match_reference(reference_run):
    """Losses, parameters, momentum, factors and error buffers within the
    step tests' tolerances; the drift metrics of parameters, momentum and
    factors exactly 0.0 in both packages, the error buffers' drift the
    reference's within their tolerance (each worker keeps its own)."""
    path, start, ref_metrics, final, _ = reference_run
    params, ef, metrics, _ = _port_run(path, start)
    np.testing.assert_allclose([m["lm_loss"] for m in metrics],
                               [m["lm_loss"] for m in ref_metrics], rtol=LOSS_RTOL)
    _close(params, final["params"], PARAM_ATOL, "params")
    _close(ef.momentum, final["momentum"], STATE_ATOL, "momentum")
    _close(ef.error, final["error"], STATE_ATOL, "error")
    if path != "top_k_int4":
        _close(ef.comp, final["q"], STATE_ATOL, "q")
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        for name in ("params", "momentum", "q"):
            assert m[f"drift_{name}"] == r[f"drift_{name}"] == 0.0, (i, name)
        if path == "warmup_k1" and i == 0:
            # a dense step leaves every error buffer at exactly zero
            assert m["drift_error"] == r["drift_error"] == 0.0
            continue
        assert r["drift_error"] > 0.0
        np.testing.assert_allclose(m["drift_error"], r["drift_error"],
                                   atol=2 * STATE_ATOL, rtol=0, err_msg=f"step {i}")


def test_sync_records_match_reference(reference_run):
    """The port records what each step ran; the reference records its one
    trace (under a warm-up, both branches of its switch).  PowerSGD: 2
    reduces and 1 broadcast a step, the broadcast carrying P̂ + Q + the
    uncompressed leaves; per leaf a broadcast leg beside every reduce."""
    path, start, _, _, jrecords = reference_run
    _, _, _, records = _port_run(path, start)
    if path == "warmup_k1":
        union = tuple(a + b for a, b in zip(records[0], records[1]))
        assert union == jrecords
        assert records[0][0] == ["reduce", "broadcast"]
        return
    assert all(r == jrecords for r in records)
    kinds = jrecords[0]
    if path in ("powersgd", "cholesky_qr", "one_step"):
        assert kinds == ["reduce", "reduce", "broadcast"]
        # P̂ and the uncompressed leaves (the first reduce's payload) + Q
        assert jrecords[1][2] == jrecords[1][0] + jrecords[1][1]
    elif path == "per_leaf":
        assert kinds == ["reduce", "broadcast"] * (len(kinds) // 2)
    else:
        assert kinds == ["reduce", "broadcast", "gather", "gather"]
