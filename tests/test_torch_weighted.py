"""Scenario weights (worker dropout, stragglers, heterogeneous batches): the
port's weighted collectives, gather combine and training step against the
JAX package on the same numpy inputs, under the weights
``[1.0, 0.0, 2.0, 0.5]`` and the all-dropped round.

* ``SimBackend.pmean``/``psum`` and ``MeshCtx.gather_data_weight`` under
  ``SimMesh(4).ctx(weights=...)`` against the reference's under its
  ``SimMesh(4).run``: within atol/rtol 1e-6 (sums in another order), the
  gathered weights equal, the records equal (the weights ride no
  collective).  The all-dropped mean is exactly zero.  The port's
  ``Transport.combine_mean`` is bit-equal to its weighted ``pmean``.
* The weighted gather combine of ``sign_norm``, ``top_k`` and
  ``spectral_atomo`` on the mixed tree of
  ``tests/sim/test_zoo_conformance.py``: fused against per-leaf within
  atol 1e-6 (the reference's test), and against the JAX package within
  the class tolerances of ``tests/test_torch_zoo.py``.
* Weighted bucketed and per-leaf PowerSGD on the mixed tree, and 3
  weighted Signum steps, against the reference.
* 3 weighted steps of ``make_sim_train_step`` on reduced Llama-3-8B at
  W = 4, PowerSGD and Top-K on the int4 wire, against the reference's
  ``step_fn(..., weights=...)``: loss rtol 1e-5, parameters atol 2e-6
  (the tolerances of ``tests/test_torch_train.py``).
* The port alone: a weight-0 worker's batch leaves parameters, momentum
  and the other workers' error buffers unchanged, bit for bit, while its
  own error buffer moves; the collective records equal the unweighted
  step's; ``weights=None`` is bit-equal to the unweighted step composed by
  hand; an all-dropped round gives a zero aggregate (momentum only decays)
  and finite parameters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import engine as jengine
from repro.core import matrixize as jmz
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro.optim import sgd as jsgd
from repro_torch import bridge, tree
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist, engine, error_feedback
from repro_torch.core import matrixize as mz
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.optim import sgd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W = 4
WEIGHTS = {"dropout": [1.0, 0.0, 2.0, 0.5], "all_dropped": [0.0] * W}
KEY = jax.random.key(0)
SEED = 11            # the port's step seed fed the reference's KEY
SHAPES = {"w1": (24, 16), "conv": (8, 4, 3, 3), "stack": (3, 12, 6),
          "bias": (7,), "scale": (5,)}


def _specs(mod):
    return {"w1": mod.MatrixSpec("matrix", 0), "conv": mod.MatrixSpec("conv", 0),
            "stack": mod.MatrixSpec("matrix", 1), "bias": mod.NONE,
            "scale": mod.NONE}


def _deltas(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((W,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _records(stats):
    return (stats.kinds, stats.sizes, stats.itemsizes, stats.fanouts,
            stats.overheads, stats.bytes_per_collective())


def _weights(case):
    return np.asarray(WEIGHTS[case], np.float32)


# ---------------------------------------------------------------------------
# the weighted collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(WEIGHTS))
def test_weighted_collectives_match_reference(case):
    weights = _weights(case)
    x = np.random.default_rng(1).standard_normal((W, 3, 5)).astype(np.float32)
    sim, jstats = JSimMesh(W), jdist.CollectiveStats()

    def one(xi, wi):
        ctx = sim.ctx(weight=wi, stats=jstats)
        return ctx.pmean_data(xi), ctx.psum_data(xi), ctx.gather_data_weight()

    jmean, jsum, jw = (np.asarray(a[0]) for a in sim.run(one)(
        jnp.asarray(x), jnp.asarray(weights)))
    stats = dist.CollectiveStats()
    ctx = SimMesh(W).ctx(stats=stats, weights=torch.tensor(weights))
    xt = torch.tensor(x)
    mean, psum = ctx.pmean_data(xt), ctx.psum_data(xt)
    np.testing.assert_allclose(mean.numpy(), jmean, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(psum.numpy(), jsum, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ctx.gather_data_weight().numpy(), jw)
    listed = SimMesh(W).ctx(weights=WEIGHTS[case], device="cpu")
    assert torch.equal(listed.gather_data_weight(), torch.tensor(weights))
    assert _records(stats) == _records(jstats)
    assert stats.kinds == ["reduce", "reduce"]
    # the single home of the semantics, and the combine that must equal it
    w4 = torch.tensor(weights).view(W, 1, 1)
    assert torch.equal(dist.weighted_mean(xt, w4, lambda v: v.sum(0)), mean)
    assert torch.equal(engine.Transport.combine_mean(
        xt.clone(), torch.tensor(weights)), mean)
    assert torch.equal(xt, torch.tensor(x))      # pmean leaves its input
    if case == "all_dropped":
        assert not mean.any() and torch.isfinite(mean).all()
        assert not psum.any()
    for unweighted in (dist.SINGLE, SimMesh(W).ctx()):
        assert unweighted.gather_data_weight() is None


@pytest.mark.parametrize("weights, match", [
    ([1.0, 1.0, 1.0], "shape"), ([1.0, -1.0, 1.0, 1.0], "non-negative"),
    ([1.0, float("nan"), 1.0, 1.0], "finite"),
    ([float("inf"), 1.0, 1.0, 1.0], "finite")])
def test_weights_are_validated(weights, match):
    with pytest.raises(ValueError, match=match):
        SimMesh(W).ctx(weights=weights)


# ---------------------------------------------------------------------------
# compressor steps on the mixed tree
# ---------------------------------------------------------------------------

def _feed_uniform_draws(comp):
    """Spectral Atomo's Bernoulli draws, as the reference draws them for
    ``KEY`` (``tests/test_torch_zoo.py::feed_reference_draws``)."""
    def draw(kind, path, seed, **kw):
        assert kind == "uniform" and seed == SEED, (kind, seed)
        k = jengine.leaf_key(KEY, tuple(jax.tree_util.DictKey(p) for p in path))
        count, attempts, n = kw["shape"]
        out = jax.vmap(lambda km: jax.vmap(
            lambda ka: jax.random.uniform(ka, (n,)))(
                jax.random.split(km, attempts)))(jax.random.split(k, count))
        return torch.tensor(np.asarray(out))

    comp.draw = draw
    return comp


def _make(mod, name, transport):
    kw = {"rank": 2}
    if name == "powersgd":
        if transport == "per_leaf":
            kw["bucketing"] = "off"
    else:
        kw["transport"] = transport
    return mod.make_compressor(name, **kw)


@functools.lru_cache(maxsize=None)
def _reference_fn(name, transport):
    """The reference's weighted step of ``name`` under ``SimMesh.run``,
    jitted once for every weight vector; its initial state; and the one
    step's records, taken when it is traced."""
    comp, jstats = _make(jcomp, name, transport), jdist.CollectiveStats()
    specs, sim = _specs(jmz), JSimMesh(W)
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in SHAPES.items()}

    def one(g, s, w):
        out = comp.step(g, s, specs, ctx=sim.ctx(weight=w, stats=jstats), key=KEY)
        return out.agg, out.recon, out.state

    return (jax.jit(sim.run(one, in_axes=(0, None, 0))),
            comp.init(shapes, specs, KEY), jstats)


def _reference_step(name, transport, deltas, weights):
    """agg and state of worker 0, recon of every worker, the initial state
    and the records of the reference's weighted step."""
    fn, state0, jstats = _reference_fn(name, transport)
    agg, recon, state = fn(jax.tree_util.tree_map(jnp.asarray, deltas), state0,
                           jnp.asarray(weights))
    np_tree = lambda t, i=None: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x if i is None else x[i]),
        t, is_leaf=lambda x: x is None)
    return (np_tree(agg, 0), np_tree(recon), np_tree(state, 0), np_tree(state0),
            _records(jstats))


def _port_step(comp, deltas, weights, state0, stats):
    ctx = SimMesh(W).ctx(stats=stats, weights=torch.tensor(weights))
    return comp.step(bridge.to_torch(deltas), bridge.to_torch(state0),
                     _specs(mz), ctx, seed=SEED)


@pytest.mark.parametrize("case", sorted(WEIGHTS))
@pytest.mark.parametrize("name", ["sign_norm", "top_k", "spectral_atomo"])
def test_gather_combine_matches_weighted_reference(name, case):
    """The receiver-side weighted combine of the fused gather against the
    per-leaf path's weighted ``pmean`` of reconstructions (atol 1e-6), and
    both against the JAX package's fused step."""
    weights, deltas = _weights(case), _deltas(seed=3)
    agg_r, recon_r, _, _, jrecords = _reference_step(name, "fused", deltas,
                                                     weights)
    outs = {}
    for transport in ("fused", "per_leaf"):
        stats = dist.CollectiveStats()
        outs[transport] = _port_step(
            _feed_uniform_draws(_make(compressors, name, transport)), deltas,
            weights, None, stats)
        if transport == "fused":
            assert _records(stats) == jrecords
    svd = name == "spectral_atomo"
    for k in SHAPES:
        fused = outs["fused"].agg[k].numpy()
        np.testing.assert_allclose(fused, outs["per_leaf"].agg[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
        atol = 1e-5 * float(np.abs(agg_r[k]).max(initial=0.0)) if svd else 1e-6
        np.testing.assert_allclose(fused, agg_r[k], atol=atol,
                                   rtol=1e-5 if svd else 1e-6, err_msg=k)
        atol = 1e-5 * float(np.abs(recon_r[k]).max(initial=0.0)) if svd else 1e-6
        np.testing.assert_allclose(outs["fused"].recon[k].numpy(), recon_r[k],
                                   atol=atol, rtol=1e-5 if svd else 1e-6,
                                   err_msg=k)
        if case == "all_dropped":
            assert not outs["fused"].agg[k].any(), k


@pytest.mark.parametrize("case", sorted(WEIGHTS))
@pytest.mark.parametrize("transport", ["fused", "per_leaf"])
def test_weighted_powersgd_matches_reference(transport, case):
    """Bucketed and per-leaf PowerSGD from the reference's Q factors: agg,
    recon and the new Q within 1e-5 (float32 products summed in another
    order), records equal."""
    weights, deltas = _weights(case), _deltas(seed=4)
    stats = dist.CollectiveStats()
    agg_r, recon_r, state_r, state0, jrecords = _reference_step(
        "powersgd", transport, deltas, weights)
    out = _port_step(_make(compressors, "powersgd", transport), deltas, weights,
                     state0, stats)
    for k in SHAPES:
        np.testing.assert_allclose(out.agg[k].numpy(), agg_r[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        # the reconstruction is the aggregate, held once in the port
        np.testing.assert_allclose(
            np.broadcast_to(out.recon[k].numpy(), recon_r[k].shape), recon_r[k],
            atol=1e-5, rtol=1e-5, err_msg=k)
        if state_r[k] is not None:
            np.testing.assert_allclose(out.state[k].numpy(), state_r[k],
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        if case == "all_dropped":
            assert not out.agg[k].any(), k
    assert _records(stats) == jrecords


def test_weighted_signum_vote_matches_reference():
    """Three Signum steps: each worker's vote weighted (the reference's
    weighted ``psum``), parameters and momentum within 1e-6."""
    weights, steps = _weights("dropout"), 3
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [_deltas(seed=30 + i) for i in range(steps)]
    sim, jstats = JSimMesh(W), jdist.CollectiveStats()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jm = jax.tree_util.tree_map(lambda x: jnp.zeros((W,) + x.shape), jp)

    def one(p, g, m, w):
        p, st = jsgd.signum_apply(
            p, g, jsgd.SignumState(m, jnp.zeros((), jnp.int32)), lr=0.1,
            momentum=0.9, ctx=sim.ctx(weight=w, stats=jstats))
        return p, st.momentum

    run = jax.jit(sim.run(one, in_axes=(None, 0, 0, 0)))   # records once
    for g in grads:
        jp, jm = run(jp, jax.tree_util.tree_map(jnp.asarray, g), jm,
                     jnp.asarray(weights))
        jp = jax.tree_util.tree_map(lambda x: x[0], jp)
    stats = dist.CollectiveStats()
    ctx = SimMesh(W).ctx(stats=stats, weights=torch.tensor(weights))
    p, state = bridge.to_torch(params), sgd.signum_init(
        bridge.to_torch(params), lead=(W,))
    for g in grads:
        stats.reset()
        p, state = sgd.signum_apply(p, bridge.to_torch(g), state, lr=0.1,
                                    momentum=0.9, ctx=ctx)
    for k in SHAPES:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.momentum[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    assert _records(stats) == _records(jstats)


# ---------------------------------------------------------------------------
# the training step: reduced Llama-3-8B, 4 workers
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 3, 8, 32
PATHS = ("powersgd", "top_k_int4")


def _batches(vocab, steps=STEPS, seed=0):
    data = MarkovLM(vocab=vocab, seed=seed, order=1)
    for i in range(steps):
        toks = data.sample(BATCH, SEQ, step=i)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _comp(mod, path):
    if path == "powersgd":
        return mod.make_compressor("powersgd", rank=2)
    return mod.make_compressor("top_k", rank=2, wire_dtype="int4")


@pytest.fixture(scope="module", params=PATHS)
def reference_run(request):
    """3 weighted steps of the reference; the initial parameters and Q
    factors, the losses, the final parameters and one step's records."""
    path = request.param
    cfg = jllama.reduced_config()
    sim, jstats = JSimMesh(W), jdist.CollectiveStats()
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2)
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper,
                                            compressor=_comp(jcomp, path),
                                            stats=jstats)
    params, ef = init(jax.random.key(0))
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x[0]), t,
        is_leaf=lambda x: x is None)
    start = (first(params), first(ef.comp))
    losses = []
    weights = jnp.asarray(_weights("dropout"))
    for i, b in enumerate(_batches(cfg.vocab_size)):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i),
                             weights=weights)
        losses.append(float(m["lm_loss"][0]))
    return path, start, losses, first(params), _records(jstats)


def _port(path, start, stats=None):
    """The port's step and its state from the reference's start."""
    params0, q0 = start
    cfg = llama3_8b.reduced_config()
    step, _ = train.make_sim_train_step(
        cfg, SimMesh(W), train.TrainHyper(q_chunk=16, warmup_steps=2),
        compressor=_comp(compressors, path), stats=stats, device="cpu")
    params = bridge.to_torch(params0)
    ef = error_feedback.EFState(
        error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
        momentum=tree.map(torch.zeros_like, params), comp=bridge.to_torch(q0))
    return cfg, step, params, ef


def _shard(b):
    return SimMesh(W).shard({k: torch.tensor(v) for k, v in b.items()})


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b))
               if x is not None)


def test_weighted_steps_match_reference(reference_run):
    """Loss rtol 1e-5 and parameters atol 2e-6 after 3 steps; the records
    of each step equal the reference's one trace."""
    path, start, ref_losses, ref_params, jrecords = reference_run
    stats = dist.CollectiveStats()
    cfg, step, params, ef = _port(path, start, stats)
    losses = []
    for b in _batches(cfg.vocab_size):
        stats.reset()
        params, ef, m = step(params, ef, _shard(b), weights=_weights("dropout"))
        losses.append(m["lm_loss"].item())
        assert _records(stats) == jrecords
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for (p, got), want in zip(tree.items(bridge.to_numpy(params)),
                              tree.leaves(ref_params)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0, err_msg=str(p))


def test_dropped_worker_batch_has_no_effect(reference_run):
    """From one state, the dropout weights and worker 1's batch replaced by
    another draw: parameters, momentum, the compressor state and the other
    workers' error buffers bit-equal; worker 1's own error buffer moves.
    The records equal the unweighted step's."""
    path, start = reference_run[:2]
    cfg = llama3_8b.reduced_config()
    batch = _shard(next(_batches(cfg.vocab_size)))
    other = _shard(next(_batches(cfg.vocab_size, seed=1)))
    swapped = {k: v.clone() for k, v in batch.items()}
    for k in swapped:
        swapped[k][1] = other[k][1]
    assert not torch.equal(swapped["tokens"], batch["tokens"])
    runs = []
    for b, weights in ((batch, _weights("dropout")),
                       (swapped, _weights("dropout")), (batch, None)):
        stats = dist.CollectiveStats()
        _, step, params, ef = _port(path, start, stats)
        params, ef, m = step(params, ef, b, weights=weights)
        runs.append((params, ef, m["lm_loss"], _records(stats)))
    (p_a, ef_a, loss_a, rec_a), (p_b, ef_b, loss_b, rec_b), (_, _, _, rec_u) = runs
    assert _equal(p_a, p_b) and _equal(ef_a.momentum, ef_b.momentum)
    assert _equal(ef_a.comp, ef_b.comp) and torch.equal(loss_a, loss_b)
    keep = [0, 2, 3]
    assert all(torch.equal(a[keep], b[keep]) for a, b in
               zip(tree.leaves(ef_a.error), tree.leaves(ef_b.error)))
    assert not all(torch.equal(a[1], b[1]) for a, b in
                   zip(tree.leaves(ef_a.error), tree.leaves(ef_b.error)))
    assert rec_a == rec_b == rec_u


def test_unweighted_step_is_unchanged(reference_run):
    """``weights=None`` is bit-equal to the unweighted step composed by hand
    (gradients, ``apply_updates`` under ``SimMesh.ctx()``, the plain mean
    of the losses); all-ones weights agree with it within the rounding
    tolerances above."""
    path, start = reference_run[:2]
    cfg, step, params, ef = _port(path, start)
    batch = _shard(next(_batches(cfg.vocab_size)))
    p_hand, ef_hand = tree.map(torch.clone, params), ef.to("cpu")
    p_ones, ef_ones = tree.map(torch.clone, params), ef.to("cpu")
    params, ef, m = step(params, ef, batch)
    hyper = train.TrainHyper(q_chunk=16, warmup_steps=2)
    grads, losses = train.worker_grads(cfg, p_hand, batch, W, q_chunk=16,
                                       device="cpu")
    p_hand, ef_hand, _ = error_feedback.apply_updates(
        _comp(compressors, path), p_hand, grads, ef_hand,
        model.mspecs(cfg), lr=train._schedule(hyper, 0),
        momentum=hyper.momentum, weight_decay=hyper.weight_decay,
        ctx=SimMesh(W).ctx())
    assert torch.equal(m["lm_loss"], losses["lm_loss"].mean())
    assert _equal(params, p_hand) and _equal(ef.error, ef_hand.error)
    assert _equal(ef.momentum, ef_hand.momentum) and _equal(ef.comp, ef_hand.comp)
    p_ones, _, m_ones = step(p_ones, ef_ones, batch, weights=[1.0] * W)
    np.testing.assert_allclose(m_ones["lm_loss"].item(), m["lm_loss"].item(),
                               rtol=1e-5)
    for (p, got), want in zip(tree.items(p_ones), tree.leaves(params)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0,
                                   err_msg=str(p))


def test_all_dropped_round_is_a_zero_aggregate(reference_run):
    """After one dropout step, an all-zero round: the aggregate is exactly
    zero, so momentum only decays (``m ← λm``, bit for bit), the loss
    metric is exactly 0 and everything stays finite."""
    path, start = reference_run[:2]
    cfg, step, params, ef = _port(path, start)
    batches = list(_batches(cfg.vocab_size, steps=2))
    params, ef, _ = step(params, ef, _shard(batches[0]),
                         weights=_weights("dropout"))
    decayed = tree.map(lambda m: m.clone().mul_(0.9), ef.momentum)
    params, ef, m = step(params, ef, _shard(batches[1]),
                         weights=_weights("all_dropped"))
    assert _equal(ef.momentum, decayed)
    assert m["lm_loss"].item() == 0.0
    for t in (params, ef.error, ef.momentum, ef.comp):
        assert all(torch.isfinite(x).all() for x in tree.leaves(t)
                   if x is not None)
