"""Bucketed PowerSGD compress+aggregate: the port against the JAX package
under the single-worker context and a 4-worker SimMesh, fed the
reference's Q factors.  agg, recon and the new Q agree within atol 1e-5 /
rtol 1e-4 (fp32, different summation orders; measured ≤ 3e-7); the
payload bits and the fused-collective trace (2 reduces per power
iteration, same sizes) agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dist as jdist
from repro.core import matrixize as jmz
from repro.core import powersgd as jpsgd
from repro.core.simmesh import SimMesh as JSimMesh
from repro_torch import bridge, tree
from repro_torch.core import dist, engine, matrixize as mz, powersgd
from repro_torch.core.compressors import PowerSGDCompressor, make_compressor
from repro_torch.core.simmesh import SimMesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL, RTOL = 1e-5, 1e-4

SHAPES = {"w1": (3, 24, 16), "w2": (20, 15), "w3": (24, 14), "b": (16,),
          "w4": (2, 9, 40)}


def _specs(mod):
    return {"w1": mod.MatrixSpec("matrix", 1), "w2": mod.MatrixSpec("matrix", 0),
            "w3": mod.MatrixSpec("matrix", 0), "b": mod.NONE,
            "w4": mod.MatrixSpec("matrix", 1)}


def _deltas(workers, seed=0):
    rng = np.random.default_rng(seed)
    lead = (workers,) if workers else ()
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _reference(jcfg, deltas, workers, metrics=False):
    """Run the JAX engine; returns (agg, recon, new_q, bits, stats, q0) as
    numpy, agg/new_q from worker 0; with ``metrics``, the compressor's
    metrics (per worker) after them."""
    specs = _specs(jmz)
    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape[1:] if workers else x.shape,
                                       jnp.float32), deltas)
    q0 = jpsgd.init_state(jcfg, shapes, specs, jax.random.key(1))
    stats = jdist.CollectiveStats()
    jd = jax.tree_util.tree_map(jnp.asarray, deltas)
    if workers:
        sim = JSimMesh(workers)

        def worker(d, q):
            out = jpsgd.compress_aggregate(jcfg, d, q, specs, sim.ctx(stats=stats))
            return out.agg, out.recon, out.state, out.bits_per_worker, out.metrics

        agg, recon, q, bits, mets = sim.run(worker, in_axes=(0, None))(jd, q0)
        agg, q, bits = (jax.tree_util.tree_map(lambda x: x[0], t)
                        for t in (agg, q, bits))
    else:
        out = jpsgd.compress_aggregate(jcfg, jd, q0, specs,
                                       jdist.MeshCtx(stats=stats))
        agg, recon, q, bits = out.agg, out.recon, out.state, out.bits_per_worker
        mets = out.metrics
    to_np = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t,
        is_leaf=lambda x: x is None)
    out = (to_np(agg), to_np(recon), to_np(q), int(bits), stats, to_np(q0))
    return out + (to_np(mets),) if metrics else out


def _port(cfg, deltas, q0, workers, metrics=False):
    stats = dist.CollectiveStats()
    ctx = SimMesh(workers).ctx(stats=stats) if workers else dist.MeshCtx(stats=stats)
    out = powersgd.compress_aggregate(cfg, bridge.to_torch(deltas),
                                      bridge.to_torch(q0), _specs(mz), ctx)
    got = (bridge.to_numpy(out.agg), bridge.to_numpy(out.recon),
           bridge.to_numpy(out.state), out.bits_per_worker, stats)
    return got + (bridge.to_numpy(out.metrics),) if metrics else got


def _close(got, want, held_once=False):
    """``held_once``: the port holds a worker-identical value once where the
    vmapped reference has one copy per worker."""
    for (path, g), w in zip(tree.items(got), tree.leaves(want)):
        if w is None:
            assert g is None, path
            continue
        if held_once and g.ndim < w.ndim:
            g = np.broadcast_to(g, w.shape)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=str(path))


@pytest.mark.parametrize("workers", [0, 4], ids=["single", "sim4"])
@pytest.mark.parametrize("error_mode,num_iters",
                         [("global", 1), ("local", 1), ("global", 2)])
def test_compress_aggregate_matches_reference(workers, error_mode, num_iters):
    kw = dict(rank=2, error_mode=error_mode, num_iters=num_iters)
    deltas = _deltas(workers)
    agg_r, recon_r, q_r, bits_r, stats_r, q0 = _reference(
        jpsgd.PowerSGDConfig(**kw), deltas, workers)
    agg, recon, q, bits, stats = _port(powersgd.PowerSGDConfig(**kw), deltas,
                                       q0, workers)
    _close(agg, agg_r)
    _close(q, q_r)
    # per-worker under sim: global-mode recon of a matrix is the aggregate,
    # which the port holds once
    _close(recon, recon_r, held_once=True)
    assert bits == bits_r
    # 2 fused reduces per power iteration, identical wire sizes
    assert stats.data_collectives == stats.reduce_collectives == 2 * num_iters
    assert stats.data_collectives == stats_r.data_collectives
    assert stats.sizes == stats_r.sizes
    assert stats.itemsizes == stats_r.itemsizes


# The two CholeskyQR2 orthogonalizers through the engine at W = 4, fed the
# reference's Q: the reduced P of these random deltas is well conditioned
# (gs_cholqr keeps Gram-Schmidt on every slab), so the same tolerances hold.
@pytest.mark.parametrize("bucketing", ["auto", "off"], ids=["bucketed", "per_leaf"])
@pytest.mark.parametrize("orthogonalizer", ["cholesky_qr", "gs_cholqr"])
def test_compress_aggregate_orthogonalizers_match_reference(orthogonalizer,
                                                            bucketing):
    kw = dict(rank=2, orthogonalizer=orthogonalizer, bucketing=bucketing)
    deltas = _deltas(4)
    agg_r, recon_r, q_r, bits_r, stats_r, q0 = _reference(
        jpsgd.PowerSGDConfig(**kw), deltas, 4)
    agg, recon, q, bits, stats = _port(powersgd.PowerSGDConfig(**kw), deltas,
                                       q0, 4)
    _close(agg, agg_r)
    _close(q, q_r)
    _close(recon, recon_r, held_once=True)
    assert bits == bits_r
    assert stats.kinds == stats_r.kinds
    assert stats.sizes == stats_r.sizes
    assert stats.itemsizes == stats_r.itemsizes
    assert stats.data_collectives == stats_r.data_collectives


def test_orthogonalizer_variants_equivalent():
    """The twin of the reference's test: Gram-Schmidt and CholeskyQR give
    the same reconstruction, since P̂Qᵀ depends only on span(P̂)."""
    m = torch.tensor(np.random.default_rng(0).standard_normal((50, 40)),
                     dtype=torch.float32)
    specs = {"w": mz.MatrixSpec("matrix", 0)}
    outs = {}
    for name in ("gram_schmidt", "cholesky_qr"):
        comp = make_compressor("powersgd", rank=3, orthogonalizer=name)
        state = comp.init({"w": m}, specs, torch.Generator().manual_seed(0))
        outs[name] = comp.step({"w": m}, state, specs).agg["w"]
    torch.testing.assert_close(outs["gram_schmidt"], outs["cholesky_qr"],
                               atol=5e-4, rtol=0)


# PowerSGD over the quantized reduce: each worker's P and Q slots are
# quantized and dequantized before the mean.  Measured on these inputs: agg
# and Q within 7.2e-7, recon within 9.5e-7 of the reference (float32 sums
# in another order, a few ulps; no int8/int4 code differs, a flip would
# move an element by a whole quantization step, max|x|/qmax).
QUANT_TOL = 1e-6


@pytest.mark.parametrize("workers", [0, 4], ids=["single", "sim4"])
@pytest.mark.parametrize("error_mode", ["global", "local"])
@pytest.mark.parametrize("wire_dtype", ["int8", "int4"])
def test_compress_aggregate_quantized_reduce_matches_reference(
        wire_dtype, error_mode, workers):
    kw = dict(rank=2, error_mode=error_mode, wire_dtype=wire_dtype)
    deltas = _deltas(workers)
    agg_r, recon_r, q_r, bits_r, stats_r, q0 = _reference(
        jpsgd.PowerSGDConfig(**kw), deltas, workers)
    agg, recon, q, bits, stats = _port(powersgd.PowerSGDConfig(**kw), deltas,
                                       q0, workers)
    for got, want, held_once in ((agg, agg_r, False), (q, q_r, False),
                                 (recon, recon_r, True)):
        for (path, g), w in zip(tree.items(got), tree.leaves(want)):
            if w is None:
                assert g is None, path
                continue
            if held_once and g.ndim < w.ndim:
                g = np.broadcast_to(g, w.shape)
            np.testing.assert_allclose(g, w, atol=QUANT_TOL, rtol=QUANT_TOL,
                                       err_msg=str(path))
    assert bits == bits_r
    assert stats.kinds == stats_r.kinds == ["reduce", "reduce"]
    assert stats.sizes == stats_r.sizes
    assert stats.itemsizes == stats_r.itemsizes
    assert stats.overheads == stats_r.overheads


def test_collective_budget_matches_declared():
    comp = PowerSGDCompressor(rank=2)
    stats = dist.CollectiveStats()
    params = bridge.to_torch(_deltas(0))
    state = comp.init(params, _specs(mz), torch.Generator().manual_seed(0))
    comp.step(bridge.to_torch(_deltas(3)), state, _specs(mz),
              SimMesh(3).ctx(stats=stats))
    assert comp.declared_budget() == (2, 2, 0)
    assert stats.reduce_collectives == comp.declared_budget()[1]


def test_cold_start_draws_from_generator():
    """warm_start=False equals warm start fed each leaf's fresh factor from
    the generator of the step's seed and the leaf's path
    (``engine.leaf_generator``), on both paths; without a seed it raises."""
    deltas = bridge.to_torch(_deltas(2))
    shapes = bridge.to_torch(_deltas(0))
    warm_cfg = powersgd.PowerSGDConfig(rank=3)
    stale = powersgd.init_state(warm_cfg, shapes, _specs(mz),
                                torch.Generator().manual_seed(5))
    fresh = tree.unflatten(stale, [
        None if q is None else
        torch.randn(q.shape, generator=engine.leaf_generator(9, path))
        for path, q in tree.items(stale)])
    ctx = SimMesh(2).ctx()
    warm = powersgd.compress_aggregate(warm_cfg, deltas, fresh, _specs(mz), ctx)
    for bucketing in ("auto", "off"):
        cold_comp = PowerSGDCompressor(rank=3, warm_start=False,
                                       bucketing=bucketing)
        cold = cold_comp.step(deltas, stale, _specs(mz), ctx, seed=9)
        for a, b in zip(tree.leaves(cold.state), tree.leaves(fresh)):
            assert (a is None) == (b is None)
        for a, b in zip(tree.leaves(cold.agg), tree.leaves(warm.agg)):
            if bucketing == "auto":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
        with pytest.raises(ValueError, match="seed"):
            cold_comp.step(deltas, stale, _specs(mz), ctx)


def test_compressed_floats_total_matches_reference():
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in SHAPES.items()}
    want = jpsgd.compressed_floats_total(shapes, _specs(jmz), 3)
    pshapes = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    assert powersgd.compressed_floats_total(pshapes, _specs(mz), 3) == want


# the id of each case names the ROADMAP queue A item the option came from
@pytest.mark.parametrize("kw", [pytest.param({"bucketing": "off"}, id="kw0-None"),
                                pytest.param({"track_residual": True},
                                             id="kw1-item 8"),
                                pytest.param({"wire_dtype": "bfloat16"},
                                             id="kw2-item 11")])
def test_unported_options_raise(kw):
    """Every option of these cases is ported now (the name is kept):
    ``bucketing="off"`` (the per-leaf path, item 4) is ported and matches
    the reference's per-leaf path, ``track_residual=True`` (item 8) is
    ported: it leaves the step as it was and reports each worker's
    residual ratios within rtol 1e-5 of the reference's, and
    ``wire_dtype="bfloat16"`` (item 11) is ported: at these shapes no
    bfloat16 rounding flips between the packages, so the step matches
    within the float32 tolerances, its two reduces at itemsize 2
    (``tests/test_torch_wire_bf16.py`` holds the wire bit for bit)."""
    deltas = _deltas(4)
    agg_r, recon_r, q_r, bits_r, stats_r, q0, mets_r = _reference(
        jpsgd.PowerSGDConfig(rank=2, **kw), deltas, 4, metrics=True)
    agg, recon, q, bits, stats, mets = _port(
        powersgd.PowerSGDConfig(rank=2, **kw), deltas, q0, 4, metrics=True)
    _close(agg, agg_r)
    _close(q, q_r)
    _close(recon, recon_r, held_once=True)
    assert bits == bits_r
    assert stats.sizes == stats_r.sizes and stats.kinds == stats_r.kinds
    assert stats.itemsizes == stats_r.itemsizes == (
        [2, 2] if kw.get("wire_dtype") == "bfloat16" else stats.itemsizes)
    if mets_r is None:
        assert mets is None
        return
    assert sorted(mets) == sorted(mets_r)
    for k in mets_r:
        assert mets[k].shape == mets_r[k].shape, k     # one per worker
        np.testing.assert_allclose(mets[k], mets_r[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_simmesh_data_movement():
    sim = SimMesh(3)
    x = {"a": torch.arange(6.0).reshape(6, 1), "b": torch.ones(2)}
    assert tuple(sim.shard({"a": x["a"]})["a"].shape) == (3, 2, 1)
    rep = sim.replicate(x)
    assert tuple(rep["b"].shape) == (3, 2)
    sim.assert_replicated(rep)
    bad = {"b": torch.stack([torch.ones(2), torch.ones(2), torch.zeros(2)])}
    with pytest.raises(AssertionError, match="diverges"):
        sim.assert_replicated(bad)
    with pytest.raises(ValueError):
        sim.shard({"a": torch.zeros(4)})


def test_pmean_data_is_the_worker_mean():
    stats = dist.CollectiveStats()
    ctx = SimMesh(4).ctx(stats=stats)
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(ctx.pmean_data(x), x.mean(0))
    assert stats.sizes == [3]
    assert dist.SINGLE.pmean_data(x) is x
