"""One-step staleness, the delayed-parameter-update pipeline
(``TrainHyper(staleness="one_step")``): the port against the JAX package on
the same numpy inputs.

* ``pmean_flat(interleave=True)`` on every wire (``auto``, ``float32``,
  ``bfloat16``, ``int8``, ``int4``), plain and weighted, with
  ``max_chunk_bytes`` forcing at least 3 chunks: bit for bit the serial
  schedule's result and records, and the reference's interleaved reduce;
  without data axes too.
* ``PipelinedTransport.shift`` and ``init_inflight`` as the reference's
  (``tests/test_engine.py``), and ``pipeline=True`` bit for bit the serial
  transport in a PowerSGD step, with the same records.
* ``staleness="none"`` and a ``pipeline=True`` compressor give the default
  path's bits (reduced Llama-3-8B, 3 steps at W = 2).
* The stale pipeline on reduced Llama-3-8B against the reference's
  ``make_sim_train_step`` at the reference suite's operating point (lr
  0.05, momentum 0; ``tests/sim/test_staleness.py``): 4 steps at W = 4,
  clean, with rotating dropout and with a straggler; losses rtol 1e-5,
  parameters atol 2e-6 (``tests/test_torch_train.py``'s tolerances), the
  in-flight aggregate atol ``INFLIGHT_ATOL``.  The port alone: the bubble
  (step 0 applies zeros: parameters and momentum unchanged, the first
  loss bit-equal to the synchronous run's), the records identical to the
  synchronous run's, the parked aggregate bit-equal to the synchronous
  step's aggregate, and linearity (W = 4 against W = 1).
* The aliasing case: without data axes a part alone in its wire chunk
  comes back as a view of its Δ, which the step turns into the error
  buffer; the parked aggregate is the reference's, nonzero, through a
  dense step and a compressed one.
* ``start_compress_step=1`` with a rank cut (``2@0,1@2``) under one-step
  against the reference; Top-K on the int4 wire under one-step on a small
  tree, 2 steps, against the reference's eager quantizer (under jit XLA rewrites its
  scales' division, C3 in ROADMAP.md).
* The two ``ValueError``s, with the reference's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import engine as jengine
from repro.core import error_feedback as jef
from repro.core import matrixize as jmz
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
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


KEY = jax.random.key(0)
WIRES = ("auto", "float32", "bfloat16", "int8", "int4")
W, STEPS, BATCH, SEQ = 4, 4, 8, 32
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
# the parked aggregate Δ'₃ after 4 steps: measured on these inputs within
# 5.5e-7 of the reference's, entries up to 0.13 (``python
# tests/test_torch_staleness.py`` prints the gaps)
INFLIGHT_ATOL = 2e-6
LINEARITY_TOL = 5e-5       # tests/sim/test_staleness.py


def _records(stats):
    """A copy of the records (``reset`` clears the lists in place)."""
    return (list(stats.kinds), list(stats.sizes), list(stats.itemsizes),
            list(stats.fanouts), list(stats.overheads))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b))
               if x is not None)


# ---------------------------------------------------------------------------
# the interleaved reduce
# ---------------------------------------------------------------------------

SHAPES = [(7,), (3, 5), (2, 4, 6), (33,), (1,)]


def _cap(wire):
    """Bytes a chunk may hold: 28 floats on the wire, so the float parts
    travel in 4 chunks (7 + 15, 48, 33, 1) whatever the wire."""
    return int(28 * {"auto": 4, "float32": 4, "bfloat16": 2, "int8": 1,
                     "int4": 0.5}[wire])


def _parts(seed, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + s).astype(np.float32) * 3.0 ** (i - 2)
            for i, s in enumerate(SHAPES)]


def _weights(weighted, workers=3):
    return np.array([1.5, 0.0, 2.5], np.float32)[:workers] if weighted else None


def _reference_interleaved(parts, weights, wire, workers=3):
    sim, stats = JSimMesh(workers), jdist.CollectiveStats()
    w = jnp.ones(workers) if weights is None else jnp.asarray(weights)

    def one(ps, wt):
        ctx = sim.ctx(weight=None if weights is None else wt, stats=stats)
        return ctx.pmean_flat(list(ps), wire_dtype=wire,
                              max_chunk_bytes=_cap(wire), interleave=True)

    out = sim.run(one)([jnp.asarray(p) for p in parts], w)
    return [np.asarray(x[0]) for x in out], stats


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("wire", WIRES)
def test_pmean_flat_interleave_bit_equal(wire, weighted):
    """Interleaved against serial: the same bits, records and chunks; both
    against the reference's interleaved reduce (eager, fed the same
    inputs), bit for bit with the same records."""
    parts = _parts(7, lead=(3,))
    weights = _weights(weighted)
    got = {}
    for interleave in (False, True):
        stats = dist.CollectiveStats()
        ctx = SimMesh(3).ctx(stats=stats, weights=weights)
        out = ctx.pmean_flat([torch.tensor(p) for p in parts], wire_dtype=wire,
                             max_chunk_bytes=_cap(wire), interleave=interleave)
        got[interleave] = ([x.numpy() for x in out], _records(stats))
    assert got[False][1] == got[True][1]
    assert len(got[True][1][0]) == 4, got[True][1]
    for a, b in zip(got[False][0], got[True][0]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    want, jstats = _reference_interleaved(parts, weights, wire)
    for a, b in zip(got[True][0], want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got[True][1] == _records(jstats)


@pytest.mark.parametrize("wire", WIRES)
def test_pmean_flat_interleave_without_data_axes(wire):
    parts = [torch.tensor(p) for p in _parts(3)]
    s_serial, s_inter = dist.CollectiveStats(), dist.CollectiveStats()
    a = dist.MeshCtx(stats=s_serial).pmean_flat(parts, wire_dtype=wire,
                                                max_chunk_bytes=_cap(wire))
    b = dist.MeshCtx(stats=s_inter).pmean_flat(parts, wire_dtype=wire,
                                               max_chunk_bytes=_cap(wire),
                                               interleave=True)
    assert _records(s_serial) == _records(s_inter)
    assert s_serial.data_collectives == 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# PipelinedTransport
# ---------------------------------------------------------------------------

def test_pipelined_transport_shift_rotation():
    """``shift`` returns ``(to_apply, new_inflight)`` = ``(inflight,
    fresh)``; ``init_inflight`` gives zeros shaped like its argument, as
    the reference's."""
    fresh = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    inflight = engine.PipelinedTransport.init_inflight(fresh)
    jfresh = {"a": jnp.ones(3), "b": jnp.full((2,), 2.0)}
    jinflight = jengine.PipelinedTransport.init_inflight(jfresh)
    for got, want in zip(tree.leaves(inflight), jax.tree_util.tree_leaves(jinflight)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got.any()
    applied, parked = engine.PipelinedTransport.shift(fresh, inflight)
    assert applied is inflight and parked is fresh
    assert issubclass(engine.PipelinedTransport, engine.Transport)


MODEL = {"w1": (24, 16), "conv": (8, 4, 3, 3), "stack": (3, 12, 6),
         "bias": (7,), "scale": (5,)}


def _specs(mod):
    return {"w1": mod.MatrixSpec("matrix", 0), "conv": mod.MatrixSpec("conv", 0),
            "stack": mod.MatrixSpec("matrix", 1), "bias": mod.NONE,
            "scale": mod.NONE}


def _model_deltas(workers, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((workers,) + s).astype(np.float32)
            for k, s in MODEL.items()}


@pytest.mark.parametrize("cap", [None, 256], ids=["fused", "chunked"])
def test_pipelined_powersgd_step_bit_equal(cap):
    """``pipeline=True`` gives the serial transport's aggregate, factors
    and records (``tests/test_engine.py``'s pipelined-transport tests);
    ``make_compressor`` passes the keyword on."""
    deltas = _model_deltas(3)
    params = {k: torch.zeros(s) for k, s in MODEL.items()}
    outs = []
    for pipeline in (False, True):
        comp = compressors.make_compressor("powersgd", rank=2, pipeline=pipeline,
                                           max_chunk_bytes=cap)
        assert comp.cfg.pipeline is pipeline
        stats = dist.CollectiveStats()
        out = comp.step(bridge.to_torch(deltas),
                        comp.init(params, _specs(mz), torch.Generator().manual_seed(0)),
                        _specs(mz), SimMesh(3).ctx(stats=stats))
        outs.append((out, _records(stats)))
    (a, ra), (b, rb) = outs
    assert ra == rb and (cap is None) == (len(ra[0]) == 2)
    assert _equal(a.agg, b.agg) and _equal(a.state, b.state)
    assert _equal(a.recon, b.recon)


# ---------------------------------------------------------------------------
# training steps on reduced Llama-3-8B
# ---------------------------------------------------------------------------

def _batches(vocab, steps=STEPS, batch=BATCH):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
            for t in (data.sample(batch, SEQ, step=i) for i in range(steps))]


def _dropout(step):
    w = np.ones((W,), np.float32)
    w[step % W] = 0.0
    return w


def _straggler(step):
    w = np.ones((W,), np.float32)
    if step % 2 == 1:
        w[3] = 0.0
    return w


SCENARIOS = {"clean": None, "dropout": _dropout, "straggler": _straggler}


def _jhyper(staleness, **kw):
    return jtrain.TrainHyper(lr=0.05, momentum=0.0, q_chunk=32, warmup_steps=5,
                             remat=False, weight_decay=0.0, staleness=staleness,
                             **kw)


def _hyper(staleness, **kw):
    """The reference suite's operating point: a one-step delay halves the
    heavy ball's stability region, so it trains without momentum."""
    return train.TrainHyper(lr=0.05, momentum=0.0, q_chunk=32, warmup_steps=5,
                            weight_decay=0.0, staleness=staleness, **kw)


def _first(t):
    return jax.tree_util.tree_map(lambda x: None if x is None else np.array(x[0]),
                                  t, is_leaf=lambda x: x is None)


@pytest.fixture(scope="module")
def reference():
    """The reference's one-step step at W = 4 (one trace): its start and,
    per scenario, losses, final parameters and in-flight aggregate (worker
    0's)."""
    cfg = jllama.reduced_config()
    sim = JSimMesh(W)
    step, init = jtrain.make_sim_train_step(cfg, sim, _jhyper("one_step"))
    params, ef = init(KEY)
    start = (_first(params), _first(ef.comp))
    runs = {}
    for name, weights_for in SCENARIOS.items():
        params, ef = init(KEY)   # the step donates its inputs
        losses = []
        for i, b in enumerate(_batches(cfg.vocab_size)):
            w = None if weights_for is None else weights_for(i)
            params, ef, m = step(params, ef, sim.shard(
                {k: jnp.asarray(v) for k, v in b.items()}), KEY, w)
            losses.append(float(m["lm_loss"][0]))
        runs[name] = (losses, _first(params), _first(ef.inflight))
    return start, runs


def _port_state(start, workers, staleness="one_step"):
    params0, q0 = start
    params = bridge.to_torch(params0)
    ef = EFState(error=tree.map(lambda p: torch.zeros((workers,) + tuple(p.shape)),
                                params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(q0),
                 inflight=(tree.map(torch.zeros_like, params)
                           if staleness == "one_step" else None))
    return params, ef


def _port_run(start, hyper, workers=W, weights_for=None, steps=STEPS,
              stats=None, compressor=None, after_step=None):
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(workers)
    step, _ = train.make_sim_train_step(cfg, sim, hyper, compressor=compressor,
                                        stats=stats, device="cpu")
    params, ef = _port_state(start, workers, hyper.staleness)
    losses = []
    for i, b in enumerate(_batches(cfg.vocab_size, steps)):
        w = None if weights_for is None else weights_for(i)
        params, ef, m = step(params, ef, sim.shard(
            {k: torch.tensor(v) for k, v in b.items()}), weights=w)
        losses.append(m["lm_loss"].item())
        if after_step is not None:
            after_step(i, params, ef)
    return losses, params, ef


def _hold(got_losses, got_params, want_losses, want_params):
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    for (path, a), b in zip(tree.items(bridge.to_numpy(got_params)),
                            tree.leaves(want_params)):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_stale_steps_match_reference(reference, scenario):
    start, runs = reference
    want_losses, want_params, want_inflight = runs[scenario]
    losses, params, ef = _port_run(start, _hyper("one_step"),
                                   weights_for=SCENARIOS[scenario])
    _hold(losses, params, want_losses, want_params)
    for (path, a), b in zip(tree.items(bridge.to_numpy(ef.inflight)),
                            tree.leaves(want_inflight)):
        np.testing.assert_allclose(a, b, atol=INFLIGHT_ATOL, rtol=0,
                                   err_msg=str(path))
    assert ef.step == STEPS
    assert any(x.abs().max().item() > 0 for x in tree.leaves(ef.inflight))


def test_bubble_trace_identity_and_parked_aggregate(reference):
    """Step 0 applies the zero aggregate: parameters unchanged and momentum
    zero, bit for bit, and the first loss the synchronous run's.  The
    records are the synchronous run's, step for step.  After step 0 the
    parked aggregate is the synchronous step's aggregate (its momentum
    after step 0, momentum starting at 0), and the error buffers are the
    synchronous run's."""
    start, _ = reference
    params0, _ = _port_state(start, W)
    seen = {}

    def keep(tag):
        def after(i, params, ef):
            if i == 0:
                seen[tag] = (tree.map(torch.clone, params),
                             tree.map(torch.clone, ef.momentum),
                             tree.map(torch.clone, ef.error),
                             ef.inflight and tree.map(torch.clone, ef.inflight))
        return after

    s_sync, s_stale = dist.CollectiveStats(), dist.CollectiveStats()
    sync, _, _ = _port_run(start, _hyper("none"), steps=2, stats=s_sync,
                           after_step=keep("none"))
    stale, _, _ = _port_run(start, _hyper("one_step"), steps=2, stats=s_stale,
                            after_step=keep("one_step"))
    assert float(sync[0]).hex() == float(stale[0]).hex()
    assert sync[1] != stale[1]
    assert _records(s_sync) == _records(s_stale)
    assert s_stale.kinds == ["reduce"] * 4
    p, m, e, inflight = seen["one_step"]
    assert _equal(p, params0) and not any(x.any() for x in tree.leaves(m))
    assert _equal(e, seen["none"][2])
    assert _equal(inflight, seen["none"][1])
    assert any(x.any() for x in tree.leaves(inflight))


def test_one_step_linearity(reference):
    """Lemma 3 under the delay: 4 stale workers equal one stale worker with
    the whole batch (the reference's metric and bound)."""
    start, _ = reference
    _, single, ef1 = _port_run(start, _hyper("one_step"), workers=1, steps=3)
    _, multi, ef4 = _port_run(start, _hyper("one_step"), workers=W, steps=3)
    worst = 0.0
    for a, b in zip(tree.leaves(multi) + tree.leaves(ef4.inflight),
                    tree.leaves(single) + tree.leaves(ef1.inflight)):
        worst = max(worst, ((a - b).abs().max() / (b.abs().max() + 1e-12)).item())
    assert worst < LINEARITY_TOL, worst


def test_staleness_none_and_pipeline_bit_equal_default_path(reference):
    """Reference test 1: an explicit ``staleness="none"`` and a
    ``pipeline=True`` compressor give the default path's losses (as hex)
    and parameters bit for bit."""
    start, _ = reference
    base_hyper = train.TrainHyper(q_chunk=32, warmup_steps=5, weight_decay=0.0)
    runs = [_port_run(start, base_hyper, workers=2, steps=3),
            _port_run(start, dataclasses.replace(base_hyper, staleness="none"),
                      workers=2, steps=3),
            _port_run(start, base_hyper, workers=2, steps=3,
                      compressor=compressors.make_compressor(
                          "powersgd", rank=2, pipeline=True))]
    (l0, p0, e0) = runs[0]
    assert e0.inflight is None
    for losses, params, ef in runs[1:]:
        assert [x.hex() for x in losses] == [x.hex() for x in l0]
        assert _equal(params, p0) and _equal(ef.momentum, e0.momentum)
        assert ef.inflight is None


def test_default_compressor_takes_the_pipeline():
    cfg = llama3_8b.reduced_config()
    for staleness, want in (("none", False), ("one_step", True)):
        comp = train._default_compressor(_hyper(staleness))
        assert comp.cfg.pipeline is want
        _, init = train.make_sim_train_step(cfg, SimMesh(2), _hyper(staleness),
                                            device="cpu")
        params, ef = init(torch.Generator().manual_seed(0))
        if want:
            for p, x in zip(tree.leaves(params), tree.leaves(ef.inflight)):
                assert x.shape == p.shape and x.device == p.device and not x.any()
                assert x.data_ptr() != p.data_ptr()
        else:
            assert ef.inflight is None
        moved = ef.to("cpu")
        assert (moved.inflight is None) == (not want)


# ---------------------------------------------------------------------------
# the aliasing case, the warm-up and a rank cut, Top-K on the int4 wire
# ---------------------------------------------------------------------------

ALIAS = {"w": (6, 5), "b": (5,)}


def test_parked_aggregate_owns_its_storage():
    """Without data axes and with a chunk cap of one part per chunk, the
    dense step's aggregate of every leaf and the compressed step's of the
    uncompressed leaf are views of Δ, which ``e ← Δ − recon`` then zeroes:
    parked as it is, the aggregate would be lost.  Two steps (one dense,
    one compressed) against the reference's apply_updates: parameters,
    momentum, error buffers and the parked aggregate, nonzero, within
    1e-6."""
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in ALIAS.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in ALIAS.items()}
             for _ in range(2)]
    specs = lambda mod: {"w": mod.MatrixSpec("matrix", 0), "b": mod.NONE}
    kw = dict(lr=0.1, momentum=0.9, start_compress_step=1, staleness="one_step")

    comp = compressors.make_compressor("powersgd", rank=1, max_chunk_bytes=4)
    deltas = bridge.to_torch(grads[0])
    out = error_feedback._dense_step(comp, deltas, None, dist.SINGLE)
    assert all(a.data_ptr() == d.data_ptr()
               for a, d in zip(tree.leaves(out.agg), tree.leaves(deltas)))

    jcomp_ = jcomp.make_compressor("powersgd", rank=1, max_chunk_bytes=4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jef.init_state(jcomp_, jp, specs(jmz), KEY, staleness="one_step")
    p = bridge.to_torch(params)
    state = error_feedback.init_state(comp, p, specs(mz), staleness="one_step")
    state.comp = bridge.to_torch(jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), jstate.comp,
        is_leaf=lambda x: x is None))
    for i, g in enumerate(grads):
        jp, jstate, _ = jef.apply_updates(
            jcomp_, jp, jax.tree_util.tree_map(jnp.asarray, g), jstate,
            specs(jmz), key=KEY, **kw)
        p, state, _ = error_feedback.apply_updates(
            comp, p, bridge.to_torch(g), state, specs(mz), **kw)
        for name, got, want in (("params", p, jp),
                                ("momentum", state.momentum, jstate.momentum),
                                ("error", state.error, jstate.error),
                                ("inflight", state.inflight, jstate.inflight)):
            for (path, a), b in zip(tree.items(bridge.to_numpy(got)),
                                    jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0,
                                           err_msg=f"step {i} {name} {path}")
        assert all(x.abs().max() > 0.1 for x in tree.leaves(state.inflight)), i
        if i == 0:   # the bubble: nothing applied yet
            np.testing.assert_array_equal(p["b"].numpy(), params["b"])


WARMUP_SCHEDULE = "2@0,1@2"    # a cut: the retained columns, no draw


def test_warmup_and_rank_cut_under_one_step():
    """``start_compress_step=1`` and a rank cut at step 2 under one-step,
    4 steps at W = 2, each package driving its own ``RankController``:
    losses rtol 1e-5, parameters atol 2e-6, the parked aggregate atol
    ``INFLIGHT_ATOL``, the factors' rank 1 after the cut."""
    cfg, jcfg = llama3_8b.reduced_config(), jllama.reduced_config()
    workers, steps = 2, 4
    jsim = JSimMesh(workers)
    jcomp_ = jcomp.PowerSGDCompressor(rank=2, rank_schedule=WARMUP_SCHEDULE,
                                      pipeline=True)
    jstep, jinit = jtrain.make_sim_train_step(
        jcfg, jsim, _jhyper("one_step", start_compress_step=1), compressor=jcomp_)
    jp, je = jinit(KEY)
    start = (_first(jp), _first(je.comp))
    jctl = jcomp_.controller()
    batches = _batches(cfg.vocab_size, steps)
    want = []
    for i, b in enumerate(batches):
        comp_w0, changed = jctl.update(jax.tree_util.tree_map(
            lambda x: x[0], je.comp), i, None)
        if changed:
            je = jef.EFState(error=je.error, momentum=je.momentum,
                             comp=jsim.replicate(comp_w0), step=je.step,
                             inflight=je.inflight)
        jp, je, m = jstep(jp, je, jsim.shard(
            {k: jnp.asarray(v) for k, v in b.items()}), KEY, None)
        want.append(float(m["lm_loss"][0]))

    comp = compressors.PowerSGDCompressor(rank=2, rank_schedule=WARMUP_SCHEDULE,
                                          pipeline=True)
    sim = SimMesh(workers)
    step, _ = train.make_sim_train_step(
        cfg, sim, _hyper("one_step", start_compress_step=1), compressor=comp,
        device="cpu")
    params, ef = _port_state(start, workers)
    ctl = comp.controller()
    losses = []
    for i, b in enumerate(batches):
        new_comp, changed = ctl.update(ef.comp, i)
        if changed:
            ef = error_feedback.replace_comp(ef, new_comp)
        params, ef, m = step(params, ef, sim.shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    assert ctl.history == jctl.history == [(0, 2), (2, 1)]
    assert {q.shape[-1] for q in tree.leaves(ef.comp) if q is not None} == {1}
    _hold(losses, params, want, _first(jp))
    for (path, a), b in zip(tree.items(bridge.to_numpy(ef.inflight)),
                            tree.leaves(_first(je.inflight))):
        np.testing.assert_allclose(a, b, atol=INFLIGHT_ATOL, rtol=0,
                                   err_msg=str(path))


def test_topk_int4_one_step_matches_eager_reference():
    """Top-K on the int4 gather wire under one-step, 2 steps at W = 2 on a
    small tree (the bubble, then step 0's aggregate applied), against the
    reference's ``apply_updates`` run eagerly (its jitted int4 scales are
    one ulp off, C3): parameters, momentum, the parked aggregate and the
    error buffers within 1e-6 (a mean of decodes,
    ``tests/test_torch_topk.py``'s tolerance), the records equal."""
    workers = 2
    rng = np.random.default_rng(11)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in MODEL.items()}
    grads = [_model_deltas(workers, seed=20 + i) for i in range(2)]
    kw = dict(lr=0.1, momentum=0.9, staleness="one_step")
    jsim, jstats = JSimMesh(workers), jdist.CollectiveStats()
    comp_r = jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
    jp = jsim.replicate(jax.tree_util.tree_map(jnp.asarray, params))
    je = jsim.replicate(jef.init_state(
        comp_r, jax.tree_util.tree_map(jnp.asarray, params), _specs(jmz), KEY,
        staleness="one_step"))

    def one(p, g, e):
        p, e, _ = jef.apply_updates(comp_r, p, g, e, _specs(jmz),
                                    ctx=jsim.ctx(stats=jstats), key=KEY, **kw)
        return p, e

    comp = compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
    stats = dist.CollectiveStats()
    p = bridge.to_torch(params)
    state = error_feedback.init_state(comp, p, _specs(mz), lead=(workers,),
                                      staleness="one_step")
    for i, g in enumerate(grads):
        jp, je = jsim.run(one)(jp, jax.tree_util.tree_map(jnp.asarray, g), je)
        p, state, _ = error_feedback.apply_updates(
            comp, p, bridge.to_torch(g), state, _specs(mz),
            ctx=SimMesh(workers).ctx(stats=stats), **kw)
        for name, got, want in (("params", p, _first(jp)),
                                ("momentum", state.momentum, _first(je.momentum)),
                                ("inflight", state.inflight, _first(je.inflight)),
                                ("error", state.error, je.error)):
            for (path, a), b in zip(tree.items(bridge.to_numpy(got)),
                                    jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6,
                                           err_msg=f"step {i} {name} {path}")
    assert _records(stats) == _records(jstats)
    assert any(x.any() for x in tree.leaves(state.inflight))


def test_unknown_mode_and_missing_inflight_raise():
    comp = compressors.make_compressor("powersgd", rank=1)
    p = {"w": torch.ones(4, 3)}
    specs = {"w": mz.MatrixSpec("matrix", 0)}
    state = error_feedback.init_state(comp, p, specs)
    grads = {"w": torch.ones(4, 3)}
    jp = {"w": jnp.ones((4, 3))}
    jcomp_ = jcomp.make_compressor("powersgd", rank=1)
    jstate = jef.init_state(jcomp_, jp, {"w": jmz.MatrixSpec("matrix", 0)}, KEY)
    for staleness in ("two_step", "one_step"):
        with pytest.raises(ValueError) as want:
            jef.apply_updates(jcomp_, jp, jp, jstate,
                              {"w": jmz.MatrixSpec("matrix", 0)}, lr=0.1,
                              staleness=staleness)
        with pytest.raises(ValueError) as got:
            error_feedback.apply_updates(comp, p, grads, state, specs, lr=0.1,
                                         staleness=staleness)
        assert str(got.value) == str(want.value)
    # nothing was touched
    assert torch.equal(p["w"], torch.ones(4, 3)) and state.step == 0


if __name__ == "__main__":
    # the gaps behind LOSS_RTOL, PARAM_ATOL and INFLIGHT_ATOL
    torch.set_num_threads(1)
    start, runs = reference.__wrapped__()
    for name, weights_for in SCENARIOS.items():
        want_losses, want_params, want_inflight = runs[name]
        losses, params, ef = _port_run(start, _hyper("one_step"),
                                       weights_for=weights_for)
        gap = lambda a, b: max(float(np.abs(x - y).max()) for x, y in
                               zip(tree.leaves(bridge.to_numpy(a)), tree.leaves(b)))
        print(f"{name}: loss rel "
              f"{max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)):.2e}, "
              f"params {gap(params, want_params):.2e}, in-flight "
              f"{gap(ef.inflight, want_inflight):.2e} (entries up to "
              f"{max(float(np.abs(x).max()) for x in tree.leaves(want_inflight)):.2f})")
