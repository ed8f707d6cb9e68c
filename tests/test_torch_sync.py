"""Replica-deterministic aggregation, ``sync_mode="broadcast"``: the port
against the JAX package on the same numpy inputs.

* ``_tree_sum``, the canonical pairwise tree, bit for bit at W = 1–5 in
  float32 and bfloat16 (from W = 4 on its order is not the worker-order
  fold's; at W = 3 it is that fold, and neither is a library sum's).
* ``pmean_data``, ``psum_data``, ``pmean_flat`` (``sync=None`` and
  ``sync=False``) and ``broadcast_flat`` under the mode, unweighted,
  weighted and all-dropped, float32 and bfloat16, W = 1–4, inputs with
  −0.0 and NaN: every result bit for bit the reference's, and the records
  (kinds, sizes, itemsizes, fanouts, overheads, bytes) equal.  The
  broadcast turns −0.0 into +0.0 where W ≥ 2 and keeps it at W = 1, held
  once and per worker; a dropped worker 0 still delivers its copy.
* Every wire, chunked: the reduce and broadcast records and results; the
  quantized wires record their own reduce and a float32 broadcast leg,
  and ``broadcast_flat`` remaps them to ``"auto"``.
* The reference suite's budgets (``tests/test_engine.py``): PowerSGD ≤ 2
  reduces + 1 broadcast a step, identity ≤ 1 + 1, at 1, 6 and 17 layers;
  a PowerSGD step, bucketed and per leaf, against the reference's.
* ``replica_drift`` against the reference's on a tree whose workers
  differ; the mode without data axes; an unknown mode.

Whole training steps under the mode are ``tests/test_torch_sync_steps.py``
(a file of their own, so that parallel test workers share the load).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import matrixize as jmz
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch.core import compressors, dist
from repro_torch.core import matrixize as mz
from repro_torch.core.simmesh import SimMesh
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
WEIGHTINGS = ("uniform", "weighted", "dropped")
DTYPES = ("float32", "bfloat16")
# the broadcast's input on every worker, and the bits the reference gives
# back: the sign of −0.0 kept at W = 1 only (its masked sum has one term)
SIGNED = np.array([-0.0, 0.0, 1.5, -2.0, np.nan], np.float32)
SIGNED_BITS = {1: [0x80000000, 0, 0x3FC00000, 0xC0000000, 0x7FC00000],
               2: [0, 0, 0x3FC00000, 0xC0000000, 0x7FC00000]}


def _records(stats):
    """A copy of the records (``reset`` clears the lists in place)."""
    return (list(stats.kinds), list(stats.sizes), list(stats.itemsizes),
            list(stats.fanouts), list(stats.overheads),
            stats.bytes_per_collective())


def _bits(x) -> np.ndarray:
    """The raw bits of a numpy array, a JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32 if x.element_size() == 4 else np.uint64)
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _assert_bits(got, want, what=""):
    """Bit for bit, but for the payload of a bfloat16 NaN: torch writes
    0xFFFF where a bfloat16 result is NaN, the JAX package 0x7FC0 (as
    their casts do), so there the NaNs need only sit in the same places."""
    g, w_ = _bits(got), _bits(want)
    if g.dtype == np.uint16:
        nan = np.isnan(np.asarray(want, np.float32))
        np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan, what)
        g, w_ = g[~nan], w_[~nan]
    np.testing.assert_array_equal(g, w_, what)


def _pair(x: np.ndarray, dtype: str):
    """The same values, bit for bit, for each package: a bfloat16 input is
    cast once (by JAX) and its bits handed to torch, since the two casts
    write different NaN payloads."""
    j = jnp.asarray(x).astype(dtype)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.tensor(np.asarray(j))
    return j, t


def _weights(kind, workers):
    if kind == "uniform":
        return None
    if kind == "dropped":
        return np.zeros(workers, np.float32)
    return np.array([0.0, 2.5, 1.0, 0.5][:workers], np.float32) + np.float32(
        workers == 1)


def _inputs(workers, seed=0):
    """Two per-worker parts of mixed magnitudes, −0.0 on every worker in
    one slot and a NaN in another."""
    rng = np.random.default_rng(seed + workers)
    scale = np.exp(rng.standard_normal((workers, 1)) * 3).astype(np.float32)
    a = (rng.standard_normal((workers, 37)) * scale).astype(np.float32)
    a[:, 0] = -0.0
    a[-1, 1] = np.nan
    b = rng.standard_normal((workers, 3, 4)).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("workers", [1, 2, 3, 4, 5])
def test_tree_sum_matches_reference(workers, dtype):
    rng = np.random.default_rng(workers)
    x = (rng.standard_normal((workers, 4096))
         * np.array([1, 300, 1e-2, 7, 1e3], np.float32)[:workers, None]
         ).astype(np.float32)
    j, t = _pair(x, dtype)
    got = dist._tree_sum(t)
    np.testing.assert_array_equal(_bits(got), _bits(jdist._tree_sum(j)))
    assert torch.equal(t, _pair(x, dtype)[1])   # the input is not written
    if workers >= 4 and dtype == "bfloat16":
        # not the worker-order fold (at W = 3 the tree is that fold)
        assert not torch.equal(got, dist.worker_sum(t))


# ---------------------------------------------------------------------------
# the collectives under the mode
# ---------------------------------------------------------------------------

def _reference_collectives(a, b, weights, workers):
    """The reference's collectives under the mode, eager under ``vmap``:
    worker 0's results and the records."""
    sim, stats = JSimMesh(workers), jdist.CollectiveStats()
    w = jnp.ones(workers) if weights is None else jnp.asarray(weights)

    def one(xa, xb, wt):
        ctx = sim.ctx(weight=None if weights is None else wt, stats=stats,
                      sync_mode="broadcast")
        return (ctx.pmean_data(xa), ctx.psum_data(xa),
                *ctx.pmean_flat([xa, xb]), *ctx.pmean_flat([xa, xb], sync=False),
                *ctx.broadcast_flat([xa, xb]))

    out = sim.run(one)(a, b, w)
    return [np.asarray(x[0]) for x in out], stats


@pytest.mark.parametrize("weighting", WEIGHTINGS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_collectives_match_reference(workers, dtype, weighting):
    """Every result bit for bit, records equal; the broadcast delivers
    worker 0's row whatever its weight."""
    a, b = _inputs(workers)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    weights = _weights(weighting, workers)
    want, jstats = _reference_collectives(ja, jb, weights, workers)
    stats = dist.CollectiveStats()
    ctx = SimMesh(workers).ctx(stats=stats, weights=weights,
                               sync_mode="broadcast")
    got = [ctx.pmean_data(ta), ctx.psum_data(ta),
           *ctx.pmean_flat([ta, tb]), *ctx.pmean_flat([ta, tb], sync=False),
           *ctx.broadcast_flat([ta, tb], stacked=True)]
    for i, (g, w_) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w_.shape, i
        _assert_bits(g, w_, str(i))
    assert _records(stats) == _records(jstats)
    assert stats.kinds == ["reduce", "broadcast", "reduce", "broadcast",
                           "reduce", "broadcast", "reduce", "broadcast"]
    assert stats.broadcast_collectives == 4
    # the inputs are not written
    assert _bits(ta).tobytes() == _bits(_pair(a, dtype)[1]).tobytes()


@pytest.mark.parametrize("layout", ["held_once", "per_worker", "dropped_rank0"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_broadcast_signed_zero_and_nan(workers, layout):
    """``[-0.0, 0.0, 1.5, -2.0, nan]`` on every worker: the reference's
    ``broadcast_flat`` keeps the sign of −0.0 at W = 1 and gives +0.0 at W
    = 2 and 4, eager and jitted; the port gives those bits on a held-once
    part (the path's P̂, Q and uncompressed aggregates) and on per-worker
    rows, with worker 0 dropped too.  The canonical reduce keeps −0.0."""
    sim = JSimMesh(workers)
    stacked = np.stack([SIGNED] * workers)

    def one(x):
        ctx = sim.ctx(sync_mode="broadcast")
        return ctx.broadcast_flat([x])[0], ctx.pmean_flat([x], sync=False)[0]

    for run in (sim.run(one), jax.jit(sim.run(one))):
        ref_b, ref_m = (np.asarray(v) for v in run(jnp.asarray(stacked)))
        np.testing.assert_array_equal(_bits(ref_b[0]), SIGNED_BITS[min(workers, 2)])
        np.testing.assert_array_equal(_bits(ref_m[0]), SIGNED_BITS[1])
    weights = None
    if layout == "dropped_rank0":
        weights = np.ones(workers, np.float32)
        weights[0] = 0.0
    ctx = SimMesh(workers).ctx(weights=weights, sync_mode="broadcast")
    if layout == "held_once":
        got = ctx.broadcast_flat([torch.tensor(SIGNED)])[0]
    else:
        got = ctx.broadcast_flat([torch.tensor(stacked)], stacked=True)[0]
    assert tuple(got.shape) == SIGNED.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref_b[0]))
    mean = ctx.pmean_flat([torch.tensor(stacked)], sync=False)[0]
    if layout != "dropped_rank0":
        np.testing.assert_array_equal(_bits(mean), SIGNED_BITS[1])


def test_broadcast_takes_worker_0s_row():
    """The reference's per-worker case (``tests/test_engine.py``): worker
    rows differ and every worker receives row 0; a held-once part comes
    back with its own values."""
    x = np.asarray(jax.random.normal(KEY, (4, 13)))
    stats, jstats = dist.CollectiveStats(), jdist.CollectiveStats()

    def one(v):
        return JSimMesh(4).ctx(stats=jstats, sync_mode="broadcast").broadcast_flat([v])[0]

    want = np.asarray(JSimMesh(4).run(one)(jnp.asarray(x)))
    ctx = SimMesh(4).ctx(stats=stats, sync_mode="broadcast")
    got = ctx.broadcast_flat([torch.tensor(x)], stacked=True)[0]
    np.testing.assert_array_equal(got.numpy(), want[0])
    np.testing.assert_array_equal(want, np.broadcast_to(x[:1], want.shape))
    held = ctx.broadcast_flat([torch.tensor(x[2])])[0]
    np.testing.assert_array_equal(held.numpy(), x[2])
    assert _records(stats)[:5] == tuple(2 * list(r) for r in _records(jstats)[:5])
    assert stats.kinds == ["broadcast", "broadcast"] and stats.fanouts == [1, 1]


def _cap(wire):
    """28 elements a chunk on every wire: the parts travel in 3 chunks."""
    return int(28 * {"auto": 4, "float32": 4, "bfloat16": 2, "int8": 1,
                     "int4": 0.5}[wire])


@pytest.mark.parametrize("sync", [None, False], ids=["sync", "no_sync"])
@pytest.mark.parametrize("wire", WIRES)
def test_wires_match_reference(wire, sync):
    """Chunked reduces and a chunked broadcast on every wire: results bit
    for bit and records equal.  A quantized chunk records its reduce at
    its wire cost and its broadcast leg in float32; the broadcast remaps a
    quantized wire to ``"auto"``."""
    rng = np.random.default_rng(3)
    shapes = [(7,), (3, 5), (2, 4, 6), (9,)]
    parts = [rng.standard_normal((3,) + s).astype(np.float32) for s in shapes]
    jstats = jdist.CollectiveStats()

    def one(*ps):
        ctx = JSimMesh(3).ctx(stats=jstats, sync_mode="broadcast")
        red = ctx.pmean_flat(list(ps), wire_dtype=wire, max_chunk_bytes=_cap(wire),
                             sync=sync)
        return (*red, *ctx.broadcast_flat(red, wire_dtype=wire,
                                          max_chunk_bytes=_cap(wire)))

    want = [np.asarray(x[0]) for x in JSimMesh(3).run(one)(*map(jnp.asarray, parts))]
    stats = dist.CollectiveStats()
    ctx = SimMesh(3).ctx(stats=stats, sync_mode="broadcast")
    red = ctx.pmean_flat([torch.tensor(p) for p in parts], wire_dtype=wire,
                         max_chunk_bytes=_cap(wire), sync=sync)
    got = red + ctx.broadcast_flat(red, wire_dtype=wire, max_chunk_bytes=_cap(wire))
    for i, (g, w_) in enumerate(zip(got, want)):
        _assert_bits(g, w_, str(i))
    assert _records(stats) == _records(jstats)
    n_reduce = stats.reduce_collectives
    assert n_reduce >= 3
    assert stats.broadcast_collectives == (n_reduce if sync is None else 0) + len(
        mz.plan_flat(red, wire_dtype="auto" if wire in mz.QUANT_WIRE_DTYPES else wire,
                     max_chunk_bytes=_cap(wire)).chunks)
    if wire in ("int8", "int4") and sync is None:
        legs = [i for k, i in zip(stats.kinds, stats.itemsizes) if k == "broadcast"]
        assert legs[:n_reduce] == [4] * n_reduce


def test_without_data_axes_and_unknown_mode():
    """Without data axes the mode changes nothing: identities, a reduce
    record each (the reference's ``_synced`` needs data axes), a broadcast
    record for ``broadcast_flat``.  An unknown mode raises."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    stats, jstats = dist.CollectiveStats(), jdist.CollectiveStats()
    ctx = dist.MeshCtx(sync_mode="broadcast", stats=stats)
    jctx = jdist.MeshCtx(sync_mode="broadcast", stats=jstats)
    t, j = torch.tensor(x), jnp.asarray(x)
    got = [ctx.pmean_data(t), ctx.psum_data(t), *ctx.pmean_flat([t]),
           *ctx.broadcast_flat([t])]
    want = [jctx.pmean_data(j), jctx.psum_data(j), *jctx.pmean_flat([j]),
            *jctx.broadcast_flat([j])]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert _records(stats) == _records(jstats)
    assert stats.kinds == ["reduce", "reduce", "reduce", "broadcast"]
    with pytest.raises(ValueError, match="unknown sync_mode 'gossip'"):
        dist.MeshCtx(sync_mode="gossip")
    with pytest.raises(ValueError, match="unknown collective kind"):
        stats.record(1, kind="scatter")


# ---------------------------------------------------------------------------
# compressor steps
# ---------------------------------------------------------------------------

def _model_tree(n_layers, workers):
    """``tests/test_engine.py``'s tree: ``n_layers`` (24 + i, 16) weights
    with a 16-wide bias each, per worker."""
    rng = np.random.default_rng(n_layers)
    grads = {}
    for i in range(n_layers):
        grads[f"l{i}/w"] = rng.standard_normal((workers, 24 + i, 16)).astype(np.float32)
        grads[f"l{i}/b"] = rng.standard_normal((workers, 16)).astype(np.float32)
    return grads


def _reference_step(name, grads, workers, stats, **kw):
    comp = (jcomp.PowerSGDCompressor(rank=2, **kw) if name == "powersgd"
            else jcomp.IdentityCompressor())
    specs = {k: jmz.default_spec(v[0]) for k, v in grads.items()}
    shapes = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype) for k, v in grads.items()}
    state = comp.init(shapes, specs, KEY)
    sim = JSimMesh(workers)

    def step(g):
        ctx = sim.ctx(stats=stats, sync_mode="broadcast")
        out = comp.step(g, state, specs, ctx=ctx, key=KEY)
        return out.agg, out.state

    # one trace, jitted: its records are the eager run's, and the
    # aggregates are compared within a tolerance
    agg, new_state = jax.jit(sim.run(step))(
        {k: jnp.asarray(v) for k, v in grads.items()})
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x[0]), t,
        is_leaf=lambda x: x is None)
    return state, first(agg), first(new_state)


def _port_step(name, grads, workers, state, stats, **kw):
    comp = (compressors.PowerSGDCompressor(rank=2, **kw) if name == "powersgd"
            else compressors.make_compressor("identity"))
    specs = {k: mz.MatrixSpec("matrix", 0) if k.endswith("/w") else mz.NONE
             for k in grads}
    out = comp.step(bridge.to_torch(grads),
                    None if state is None else bridge.to_torch(state), specs,
                    ctx=SimMesh(workers).ctx(stats=stats, sync_mode="broadcast"))
    return bridge.to_numpy(out.agg), out.state and bridge.to_numpy(out.state)


@pytest.mark.parametrize("name,reduces,broadcasts", [
    ("powersgd", 2, 1), ("identity", 1, 1)])
def test_collective_budget_broadcast_mode(name, reduces, broadcasts):
    """The reference suite's budgets under the mode at 1, 6 and 17 layers:
    ``reduces`` reduces and at most ``broadcasts`` broadcast a step,
    broadcast bytes flat in W; records and aggregates the reference's."""
    for n_layers in (1, 6, 17):
        grads = _model_tree(n_layers, 2)
        stats, jstats = dist.CollectiveStats(), jdist.CollectiveStats()
        state, want_agg, _ = _reference_step(name, grads, 2, jstats)
        agg, _ = _port_step(name, grads, 2, None if name == "identity"
                            else jax.tree_util.tree_map(np.asarray, state), stats)
        assert stats.reduce_collectives <= reduces, (n_layers, stats.kinds)
        assert stats.broadcast_collectives <= broadcasts, (n_layers, stats.kinds)
        assert stats.gather_collectives == 0
        for k, s_, i_, b_ in zip(stats.kinds, stats.sizes, stats.itemsizes,
                                 stats.bytes_per_collective()):
            if k == "broadcast":
                assert b_ == s_ * i_
        assert _records(stats) == _records(jstats)
        for k in grads:
            np.testing.assert_allclose(agg[k], want_agg[k], atol=1e-6, rtol=0,
                                       err_msg=f"{n_layers} layers, {k}")


@pytest.mark.parametrize("bucketing", ["auto", "off"])
def test_powersgd_step_matches_reference(bucketing):
    """One PowerSGD step at W = 3, bucketed (2 reduces + 1 fused broadcast
    of P̂, Q and the biases' aggregates) and per leaf (a reduce and a
    broadcast record per call): aggregates and factors within 1e-6 of the
    reference's, the records equal."""
    grads = _model_tree(4, 3)
    stats, jstats = dist.CollectiveStats(), jdist.CollectiveStats()
    state, want_agg, want_q = _reference_step("powersgd", grads, 3, jstats,
                                              bucketing=bucketing)
    agg, q = _port_step("powersgd", grads, 3,
                        jax.tree_util.tree_map(np.asarray, state), stats,
                        bucketing=bucketing)
    assert _records(stats) == _records(jstats)
    if bucketing == "auto":
        assert stats.kinds == ["reduce", "reduce", "broadcast"]
        # P̂ + the biases (the first reduce's payload) + Q, padding included
        assert stats.sizes[2] == stats.sizes[0] + stats.sizes[1]
    else:
        assert stats.kinds == ["reduce", "broadcast"] * (2 * 4 + 4)
    for k in grads:
        np.testing.assert_allclose(agg[k], want_agg[k], atol=1e-6, rtol=0, err_msg=k)
        if q[k] is not None:
            np.testing.assert_allclose(q[k], want_q[k], atol=1e-6, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the drift probe
# ---------------------------------------------------------------------------

def test_replica_drift_matches_reference():
    """A per-worker tree whose workers differ (a −0.0 against +0.0 too)
    and a held-once tree: the port's drift is the reference's, and a NaN
    leaf gives NaN in both."""
    rng = np.random.default_rng(5)
    same = rng.standard_normal((3, 5)).astype(np.float32)
    per_worker = {"a": np.stack([same] * 4),
                  "b": np.zeros((4, 7), np.float32), "n": None,
                  "i": np.arange(8, dtype=np.int32).reshape(4, 2)}
    per_worker["a"][2, 1, 1] += 0.375
    per_worker["b"][0, 3] = -0.0
    per_worker["b"][3, 4] = 1e-3
    sim = JSimMesh(4)

    def one(t):
        return jtrain.replica_drift(sim.ctx(sync_mode="broadcast"), t)

    want = np.asarray(sim.run(one)(jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x), per_worker,
        is_leaf=lambda x: x is None)))
    ctx = SimMesh(4).ctx(sync_mode="broadcast")
    got = train.replica_drift(ctx, bridge.to_torch(per_worker), per_worker=True)
    assert got.item() == want[0] == np.float32(0.375)
    held = {"a": torch.tensor(per_worker["a"][0]), "b": torch.tensor(per_worker["b"][0])}
    assert train.replica_drift(ctx, held).item() == 0.0
    assert train.replica_drift(ctx, {"q": None}).item() == 0.0
    held["a"][0, 0] = float("nan")
    assert np.isnan(train.replica_drift(ctx, held).item())
    bad = dict(per_worker, a=per_worker["a"].copy())
    bad["a"][1, 0, 0] = np.nan
    assert np.isnan(np.asarray(sim.run(one)(jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x), bad,
        is_leaf=lambda x: x is None)))[0])
    assert np.isnan(train.replica_drift(ctx, bridge.to_torch(bad),
                                        per_worker=True).item())
