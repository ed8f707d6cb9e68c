"""Adaptive rank: the port's rank schedules, warm-start-preserving
transitions, residual tracking and ``RankController`` against the JAX
package on the same numpy inputs.

* ``parse_schedule`` of every form, and ``next_rank`` of each schedule on a
  grid of steps, ranks and residuals: equal.  ``StaircaseRank`` and
  ``ResidualEnergyRank`` refuse what the reference refuses.
* ``transition_factor`` / ``transition_state``: a truncation bit-exact, a
  growth bit-exact when fed the reference's columns, broadcast over batch
  dims, per-leaf rank trees with ``None``.
* Mixed per-bucket ranks: the bucketed step against the per-leaf step and
  the reference's, and the "share a rank" error.
* ``residual_ratio`` and ``bucket_residual_ratio`` of both paths per worker
  at W = 4 within rtol 1e-5 of the reference's, falling from rank 1 to 8.
* ``RankController`` decisions, columns and ``state_dict`` round trip.
* ``train_lm`` under a staircase and a residual controller (the
  reference's columns fed in) against the reference's ``train_lm``:
  ``rank_history``, ``final_rank`` and ``compressed_floats_total`` equal,
  ``eval_loss`` within rtol 1e-5 (the rule of ``tests/test_torch_bench.py``);
  the same under ``orthogonalizer="cholesky_qr"``, with ``2@0,4@1,1@3``
  and at a fixed rank.
* ``make_sim_train_step`` with ``TrainHyper(rank_schedule=…,
  track_residual=True)``: the step's ``residual_ratio`` against the
  reference's, plain and under scenario weights (reduced Llama-3-8B with
  one layer, W = 2); with a dense warm-up no step reports one, as in the
  reference.  A growth and then a cut (``2@0,4@1,1@3``) through both
  packages' steps at W = 4, the reference's ``RankController`` against the
  port's fed its columns: ranks, losses, residual ratios, parameters and
  factors.

``python tests/test_torch_rank.py`` prints the residual schedule's margins
to its thresholds in the ``train_lm`` runs.
"""

import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import compressors as jcomp
from repro.core import engine as jengine
from repro.core import error_feedback as jef
from repro.core import matrixize as jmz
from repro.core import powersgd as jpsgd
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import bridge, tree
from repro_torch.bench import common as bench
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist, error_feedback
from repro_torch.core import matrixize as mz
from repro_torch.core import powersgd
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train
from repro_torch.models import model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "reference_bench_common_rank", ROOT / "benchmarks" / "common.py")
jbench = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = jbench   # its dataclasses look their module up
_spec.loader.exec_module(jbench)

KEY = jax.random.key(0)
RESIDUAL_RTOL = 1e-5


def _np(t):
    return jax.tree_util.tree_map(lambda x: None if x is None else np.array(x), t,
                                  is_leaf=lambda x: x is None)


def _jpath(path):
    return tuple(jax.tree_util.DictKey(k) for k in path)


def _ref_columns(key):
    """A port ``draw(path, shape)`` giving the reference's columns for the
    transition key ``key``: ``normal(leaf_key(key, path), shape)``."""
    def draw(path, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jengine.leaf_key(key, _jpath(path)), shape, dtype=jnp.float32)))
    return draw


class FedController(powersgd.RankController):
    """The port's controller fed the reference controller's columns: the
    reference splits its key (``key(17)`` by default) once per switch and
    draws each leaf's columns from the split-off key."""

    def draw(self, switch, path, shape):
        key = jax.random.key(17)
        for _ in range(switch + 1):
            key, sub = jax.random.split(key)
        return _ref_columns(sub)(path, shape)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SPECS = [4, "4", " 3 ", "4@0,2@60,1@120", "2@60,4@0", [(0, 4), (10, 2)],
         ((0, 1), (3, 8)), "residual", "residual:min=1,max=16,init=4,every=5",
         "residual:shrink=0.2,grow=0.9,ema=0.5,min=2,max=8,init=2"]


def _same_schedule(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.initial_rank() == want.initial_rank()
    assert got.needs_residual == want.needs_residual


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_parse_schedule_matches_reference(spec):
    got, want = powersgd.parse_schedule(spec), jpsgd.parse_schedule(spec)
    _same_schedule(got, want)
    assert powersgd.parse_schedule(got) is got
    for step in (0, 1, 2, 3, 5, 9, 10, 20, 59, 60, 61, 119, 120, 500):
        for current in (1, 2, 3, 4, 8, 16):
            for residual in (None, 0.0, 0.1, 0.35, 0.5, 0.7, 0.71, 0.95):
                assert (got.next_rank(step, current, residual)
                        == want.next_rank(step, current, residual)), (
                    step, current, residual)


@pytest.mark.parametrize("bad", [None, 2.5, {"rank": 2}])
def test_parse_schedule_rejects(bad):
    for mod in (powersgd, jpsgd):
        with pytest.raises(TypeError):
            mod.parse_schedule(bad)


@pytest.mark.parametrize("cls,kw", [
    ("StaircaseRank", {"milestones": ((10, 4),)}),
    ("StaircaseRank", {"milestones": ()}),
    ("StaircaseRank", {"milestones": ((0, 2), (5, 1), (3, 4))}),
    ("StaircaseRank", {"milestones": ((0, 0),)}),
    ("ResidualEnergyRank", {"min_rank": 4, "init_rank": 2}),
    ("ResidualEnergyRank", {"init_rank": 16}),
    ("ResidualEnergyRank", {"shrink_below": 0.8, "grow_above": 0.7}),
])
def test_schedules_reject_what_the_reference_rejects(cls, kw):
    for mod in (powersgd, jpsgd):
        with pytest.raises(AssertionError):
            getattr(mod, cls)(**kw)


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------

def test_truncation_bitexact_and_dense():
    q = jax.random.normal(KEY, (3, 16, 4))
    want = np.asarray(jpsgd.transition_factor(q, 2, KEY))
    got = powersgd.transition_factor(torch.tensor(np.asarray(q)), 2)
    assert got.is_contiguous() and tuple(got.shape) == (3, 16, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(16, 2), (3, 16, 2), (2, 3, 16, 1)])
def test_growth_bitexact_with_reference_columns(shape):
    """Every old column kept bit for bit; the new ones are the reference's
    when fed its draw, the same in every batch slice."""
    q = jax.random.normal(KEY, shape)
    key = jax.random.key(5)
    want = np.asarray(jpsgd.transition_factor(q, 5, key))
    qt = torch.tensor(np.asarray(q))
    got = powersgd.transition_factor(qt, 5, lambda path, s: torch.tensor(
        np.asarray(jax.random.normal(key, s, dtype=jnp.float32))))
    assert tuple(got.shape) == shape[:-1] + (5,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[..., :shape[-1]].numpy(), np.asarray(q))
    new = got[..., shape[-1]:].reshape((-1, 16, 5 - shape[-1]))
    assert all(torch.equal(new[0], x) for x in new)


def test_transition_same_rank_and_growth_without_draw():
    q = torch.randn(16, 3)
    assert powersgd.transition_factor(q, 3) is q
    with pytest.raises(ValueError, match="draw"):
        powersgd.transition_factor(q, 4)


def _state():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "blocks": {"c": rng.standard_normal((2, 6, 4)).astype(np.float32),
                       "b": rng.standard_normal((6, 4)).astype(np.float32)},
            "v": None}


@pytest.mark.parametrize("ranks", [2, 6, {"a": 1, "blocks": {"b": None, "c": 7},
                                          "v": None}])
def test_transition_state_matches_reference(ranks):
    state = _state()
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    key = jax.random.key(3)
    want = _np(jpsgd.transition_state(jstate, ranks, key))
    port_in = bridge.to_torch(state)
    got = powersgd.transition_state(port_in, ranks, _ref_columns(key))
    for (path, g), w in zip(tree.items(got), tree.leaves(want)):
        if w is None:
            assert g is None, path
            continue
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    if isinstance(ranks, dict):
        assert got["blocks"]["b"] is port_in["blocks"]["b"]
    with pytest.raises(ValueError, match="align"):
        powersgd.transition_state(port_in, {"a": 1}, _ref_columns(key))


# ---------------------------------------------------------------------------
# mixed per-bucket ranks, bits, residual ratios
# ---------------------------------------------------------------------------

TREE = {"a": (24, 16), "b": (23, 16), "c": (64, 32), "s": (3, 12, 10), "v": (16,)}


def _specs(mod):
    return {"a": mod.MatrixSpec("matrix", 0), "b": mod.MatrixSpec("matrix", 0),
            "c": mod.MatrixSpec("matrix", 0), "s": mod.MatrixSpec("matrix", 1),
            "v": mod.NONE}


def _grads(workers, seed=1):
    rng = np.random.default_rng(seed)
    lead = (workers,) if workers else ()
    # a low-rank component plus noise, so a higher rank captures more
    out = {}
    for k, s in TREE.items():
        base = rng.standard_normal(s[:-1] + (2,)) @ rng.standard_normal((2, s[-1]))
        noise = 0.3 * rng.standard_normal(lead + s)
        out[k] = (base + noise).astype(np.float32)
    return out


def _factors(ranks, seed=2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in TREE.items():
        r = ranks.get(k)
        out[k] = (None if r is None else
                  rng.standard_normal(s[:-2] + (s[-1], r)).astype(np.float32))
    return out


def _reference_step(cfg, grads, q0, workers):
    """The reference's compress step: agg, new Q, bits, metrics (per worker
    under a SimMesh), numpy."""
    specs = _specs(jmz)
    jq = jax.tree_util.tree_map(jnp.asarray, q0)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    if workers:
        sim = JSimMesh(workers)

        def worker(d, q):
            out = jpsgd.compress_aggregate(cfg, d, q, specs, sim.ctx())
            return out.agg, out.state, out.bits_per_worker, out.metrics

        agg, q, bits, metrics = sim.run(worker, in_axes=(0, None))(jg, jq)
        first = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
        agg, q, bits = first(agg), first(q), first(bits)
    else:
        out = jpsgd.compress_aggregate(cfg, jg, jq, specs)
        agg, q, bits, metrics = out.agg, out.state, out.bits_per_worker, out.metrics
    return _np(agg), _np(q), int(bits), (None if metrics is None else _np(metrics))


def _port_step(cfg, grads, q0, workers):
    ctx = SimMesh(workers).ctx() if workers else dist.SINGLE
    out = powersgd.compress_aggregate(cfg, bridge.to_torch(grads),
                                      bridge.to_torch(q0), _specs(mz), ctx)
    return out


MIXED = {"a": 2, "b": 2, "c": 4, "s": 3}
# These leaves' aggregates and factors reach magnitudes of 3 to 20, so the
# gaps are held relative to each leaf's largest magnitude: measured at most
# 6.2e-6 of it (the factor of "s" at W = 4, whose third column is mostly
# noise that Gram-Schmidt amplifies float32 rounding into).
MIXED_TOL = 2e-5


def _close_scaled(got, want, what):
    for (path, g), w in zip(tree.items(bridge.to_numpy(got)), tree.leaves(want)):
        if w is None:
            assert g is None, path
            continue
        assert g.shape == w.shape, (what, path)
        gap = float(np.abs(g - w).max())
        assert gap <= MIXED_TOL * float(np.abs(w).max()), (what, path, gap)


@pytest.mark.parametrize("workers", [0, 4], ids=["single", "sim4"])
def test_mixed_per_bucket_ranks_match_per_leaf_and_reference(workers):
    """a and b share a bucket at rank 2, c and s run at 4 and 3: the
    bucketed step equals the per-leaf step and both equal the reference's
    bucketed step within ``MIXED_TOL`` of each leaf's scale, each factor
    keeps its rank, and the bits are each leaf's at its own rank."""
    grads, q0 = _grads(workers), _factors(MIXED)
    bucketed = _port_step(powersgd.PowerSGDConfig(rank=4), grads, q0, workers)
    per_leaf = _port_step(powersgd.PowerSGDConfig(rank=4, bucketing="off"),
                          grads, q0, workers)
    agg_r, q_r, bits_r, _ = _reference_step(jpsgd.PowerSGDConfig(rank=4), grads,
                                            q0, workers)
    _close_scaled(bucketed.agg, bridge.to_numpy(per_leaf.agg), "agg")
    for got in (bucketed, per_leaf):
        _close_scaled(got.agg, agg_r, "agg")
        _close_scaled(got.state, q_r, "q")
        for path, q in tree.items(got.state):
            assert q is None or q.shape[-1] == MIXED[path[0]]
    shapes = {k: torch.empty(s, device="meta") for k, s in TREE.items()}
    total = powersgd.compressed_floats_total(shapes, _specs(mz),
                                             bridge.to_torch(q0))
    assert bucketed.bits_per_worker == per_leaf.bits_per_worker == bits_r == 32 * total


def test_leaves_sharing_a_bucket_must_share_a_rank():
    grads, q0 = _grads(0), _factors({"a": 2, "b": 4, "c": 4, "s": 4})
    with pytest.raises(ValueError, match="share a rank"):
        _port_step(powersgd.PowerSGDConfig(rank=4), grads, q0, 0)
    with pytest.raises(ValueError, match="share a rank"):
        _reference_step(jpsgd.PowerSGDConfig(rank=4), grads, q0, 0)


def test_compressed_floats_total_on_a_state_tree():
    q0 = _factors(MIXED)
    jshapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in TREE.items()}
    want = jpsgd.compressed_floats_total(
        jshapes, _specs(jmz), jax.tree_util.tree_map(jnp.asarray, q0))
    shapes = {k: torch.empty(s, device="meta") for k, s in TREE.items()}
    assert powersgd.compressed_floats_total(shapes, _specs(mz),
                                            bridge.to_torch(q0)) == want
    uniform = _factors({"a": 3, "b": 3, "c": 3, "s": 3})
    assert (powersgd.compressed_floats_total(shapes, _specs(mz),
                                             bridge.to_torch(uniform))
            == powersgd.compressed_floats_total(shapes, _specs(mz), 3))


@pytest.mark.parametrize("workers", [0, 4], ids=["single", "sim4"])
@pytest.mark.parametrize("bucketing", ["auto", "off"])
def test_residual_ratios_match_reference(bucketing, workers):
    """Per worker (each from its own M, as under the reference's vmap),
    within rtol 1e-5, at mixed ranks; the bucketed path also gives one
    ratio per bucket."""
    grads, q0 = _grads(workers), _factors(MIXED)
    kw = dict(rank=4, bucketing=bucketing, track_residual=True)
    got = _port_step(powersgd.PowerSGDConfig(**kw), grads, q0, workers).metrics
    want = _reference_step(jpsgd.PowerSGDConfig(**kw), grads, q0, workers)[3]
    assert sorted(got) == sorted(want)
    lead = (workers,) if workers else ()
    assert tuple(got["residual_ratio"].shape) == lead
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RESIDUAL_RTOL,
                                   atol=0, err_msg=k)
    if bucketing == "auto":
        assert tuple(got["bucket_residual_ratio"].shape) == lead + (3,)
    if workers:
        # a ratio of sums pooled over the workers is another number
        assert len(set(got["residual_ratio"].tolist())) == workers


@pytest.mark.parametrize("bucketing", ["auto", "off"])
def test_residual_falls_with_rank(bucketing):
    grads = _grads(4)
    ratios = {}
    for r in (1, 8):
        q0 = _factors({"a": r, "b": r, "c": r, "s": r})
        out = _port_step(powersgd.PowerSGDConfig(rank=r, bucketing=bucketing,
                                                 track_residual=True), grads, q0, 4)
        ratios[r] = out.metrics["residual_ratio"]
        assert bool(((ratios[r] > 0) & (ratios[r] < 1.5)).all())
    assert bool((ratios[8] < ratios[1]).all())


def test_no_metrics_without_tracking_or_matrices():
    grads, q0 = _grads(0), _factors(MIXED)
    assert _port_step(powersgd.PowerSGDConfig(rank=4), grads, q0, 0).metrics is None
    out = powersgd.compress_aggregate(
        powersgd.PowerSGDConfig(track_residual=True), {"v": torch.ones(16)},
        {"v": None}, {"v": mz.NONE})
    assert out.metrics is None


# ---------------------------------------------------------------------------
# RankController
# ---------------------------------------------------------------------------

def test_controller_staircase_matches_reference():
    """Ranks, history and factors at each step: truncations bit-exact,
    growths bit-exact with the reference's columns fed in."""
    state = _state()
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    spec = "4@0,2@2,6@3,1@5"
    jctl, ctl = jpsgd.RankController(spec), FedController(spec)
    got_state = bridge.to_torch(state)
    for step in range(7):
        jstate, jchanged = jctl.update(jstate, step)
        got_state, changed = ctl.update(got_state, step)
        assert changed == jchanged and ctl.rank == jctl.rank
        for (path, g), w in zip(tree.items(got_state), tree.leaves(_np(jstate))):
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"step {step} {path}")
    assert ctl.history == jctl.history == [(0, 4), (2, 2), (3, 6), (5, 1)]
    assert ctl.switches == 3


def test_controller_residual_decisions_match_reference():
    """The EMA and each decision, on a residual sequence that crosses both
    thresholds, with the default smoothing and without."""
    seq = [None, 0.9, 0.95, 0.8, 0.1, 0.05, 0.02, 0.5, 0.75, 0.9, 0.2, 0.01]
    for spec in ("residual:min=1,max=8,init=2,every=2",
                 "residual:min=1,max=8,init=4,every=1,ema=0"):
        jctl, ctl = jpsgd.RankController(spec), FedController(spec)
        state = {"w": np.random.default_rng(0).standard_normal((16, jctl.rank)
                                                                ).astype(np.float32)}
        jstate, pstate = {"w": jnp.asarray(state["w"])}, bridge.to_torch(state)
        for step, res in enumerate(seq):
            jstate, jch = jctl.update(jstate, step, res)
            pstate, ch = ctl.update(pstate, step, res)
            assert ch == jch and ctl.rank == jctl.rank, (spec, step)
            assert ctl.observe(None) == jctl.observe(None)
            np.testing.assert_array_equal(pstate["w"].numpy(), np.asarray(jstate["w"]))
        assert ctl.history == jctl.history and len(ctl.history) > 2


def test_controller_state_dict_round_trip_replays_the_schedule():
    """A controller restored mid-run takes the rest of the schedule's
    switches with the same columns as one that never stopped; its snapshot
    holds the reference's rank, ema and history."""
    spec = "2@0,4@2,1@4,3@6"
    whole, first = powersgd.RankController(spec), powersgd.RankController(spec)
    start = powersgd.transition_state(bridge.to_torch(_state()), 2)
    s_whole = s_first = start
    for step in range(3):
        s_whole, _ = whole.update(s_whole, step, 0.5)
        s_first, _ = first.update(s_first, step, 0.5)
    snap = first.state_dict()
    jctl = jpsgd.RankController(spec)
    jstate = jax.tree_util.tree_map(jnp.asarray, _state())
    for step in range(3):
        jstate, _ = jctl.update(jstate, step, 0.5)
    jsnap = jctl.state_dict()
    for k in ("rank", "ema", "history"):
        assert snap[k] == jsnap[k], k
    assert (snap["seed"], snap["switches"]) == (17, 1)
    resumed = powersgd.RankController(spec).load_state_dict(snap)
    s_resumed = s_first
    for step in range(3, 8):
        s_whole, a = whole.update(s_whole, step, 0.5)
        s_resumed, b = resumed.update(s_resumed, step, 0.5)
        assert a == b
    assert resumed.history == whole.history
    for x, y in zip(tree.leaves(s_whole), tree.leaves(s_resumed)):
        assert (x is None and y is None) or torch.equal(x, y)
    # another seed draws other columns
    other = powersgd.RankController(spec, seed=3)
    s_other = start
    for step in range(3):
        s_other, _ = other.update(s_other, step)
    assert not torch.equal(s_other["a"], s_first["a"])


def test_compressor_keywords_and_controller():
    for mod in (compressors, jcomp):
        comp = mod.make_compressor("powersgd", rank=2, rank_schedule="4@0,1@3")
        assert comp.cfg.rank == 4 and not comp.cfg.track_residual
        comp = mod.make_compressor("powersgd", rank_schedule="residual:init=2")
        assert comp.cfg.rank == 2 and comp.cfg.track_residual
        comp = mod.make_compressor("powersgd", rank=3, track_residual=True)
        assert comp.cfg.track_residual and comp.rank_schedule is None
        assert comp.controller().schedule == mod.make_compressor(
            "powersgd", rank=3).controller().schedule
    _same_schedule(compressors.make_compressor("powersgd", rank=3).controller().schedule,
                   jcomp.make_compressor("powersgd", rank=3).controller().schedule)
    assert compressors.make_compressor("powersgd").controller(seed=4).seed == 4
    hyper = train.TrainHyper(rank=3, rank_schedule="1@0,2@4", track_residual=True)
    comp = train._default_compressor(hyper)
    assert comp.cfg.rank == 1 and comp.cfg.track_residual
    assert comp.rank_schedule == powersgd.StaircaseRank(((0, 1), (4, 2)))


def test_budget_stays_two_collectives_at_every_stage():
    comp = compressors.make_compressor("powersgd", rank_schedule="4@0,2@2,1@4,3@5")
    grads = bridge.to_torch(_grads(2))
    state = bridge.to_torch(_factors({"a": 4, "b": 4, "c": 4, "s": 4}))
    ctl = comp.controller()
    for step in range(6):
        state, _ = ctl.update(state, step)
        stats = dist.CollectiveStats()
        out = comp.step(grads, state, _specs(mz), SimMesh(2).ctx(stats=stats))
        state = out.state
        assert stats.kinds == ["reduce", "reduce"], step
    assert state["a"].shape[-1] == 3


# ---------------------------------------------------------------------------
# train_lm with a controller against the reference
# ---------------------------------------------------------------------------

# a one-layer LM at half width: the reference traces its step once per rank
LM = dict(steps=6, layers=1, d_model=64, seq=32)
LM_SCHEDULES = {"staircase": "2@0,4@2,1@4",
                "residual": "residual:min=1,max=4,init=2,every=2,ema=0"}


def _lm_runs(spec, **kw):
    """Both packages' ``train_lm`` on ``LM`` from the same state; under a
    rank schedule ``spec`` the port's controller is fed the reference's
    columns.  ``kw`` goes to both ``make_compressor`` calls."""
    jcomp_ = jcomp.make_compressor("powersgd", rank_schedule=spec, **kw)
    jctl = None if spec is None else jcomp_.controller()
    want = jbench.train_lm(jcomp_, jbench.LMSpec(**LM), controller=jctl)
    lm = jbench.LMSpec(**LM)
    cfg = jbench._make_cfg(lm)
    key = jax.random.key(lm.seed)
    params = jmodel.init(key, cfg, model_shards=1)
    q0 = jef.init_state(jcomp_, params, jmodel.mspecs(cfg), key).comp
    comp = compressors.make_compressor("powersgd", rank_schedule=spec, **kw)
    residuals, ctl = [], None
    if spec is not None:
        ctl = FedController(comp.rank_schedule)
        observe = ctl.observe
        ctl.observe = lambda r: residuals.append(r) or observe(r)
    got = bench.train_lm(comp, bench.LMSpec(**LM), device="cpu",
                         params=bridge.to_torch(_np(params)),
                         comp_state=bridge.to_torch(_np(q0)), controller=ctl)
    return got, want, residuals, None if ctl is None else ctl.schedule


def _same_lm_run(got, want):
    for key in ("rank_history", "final_rank"):    # present under a controller
        assert (key in got) == (key in want) and got.get(key) == want.get(key)
    assert got["compressed_floats_total"] == want["compressed_floats_total"]
    assert got["bits_per_worker_per_step"] == want["bits_per_worker_per_step"]
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)


@pytest.mark.parametrize("which", list(LM_SCHEDULES))
def test_train_lm_with_controller_matches_reference(which):
    got, want, _, _ = _lm_runs(LM_SCHEDULES[which])
    assert len(got["rank_history"]) >= 2          # the run switched
    _same_lm_run(got, want)


@pytest.mark.parametrize("spec", ["2@0,4@1,1@3", None],
                         ids=["staircase", "fixed"])
def test_train_lm_cholesky_qr_matches_reference(spec):
    """``train_lm`` through ``make_compressor("powersgd",
    orthogonalizer="cholesky_qr")``, under a growth and a cut (the
    controller fed the reference's columns) and at a fixed rank, under the
    rules above."""
    got, want, _, _ = _lm_runs(spec, orthogonalizer="cholesky_qr")
    if spec is not None:
        assert [r for _, r in got["rank_history"]] == [2, 4, 1]
    _same_lm_run(got, want)


# ---------------------------------------------------------------------------
# the training step: residual_ratio in the metrics, one-layer reduced Llama, W = 2
# ---------------------------------------------------------------------------

W, BATCH, SEQ = 2, 4, 32
WEIGHTS = (3.0, 1.0)
SCHEDULE = "2@0,4@2"


def _cfg(mod):
    """Reduced Llama-3-8B with one layer (the reference traces faster)."""
    return dataclasses.replace(mod.reduced_config(), num_layers=1)


def _batch(vocab, step=0):
    toks = MarkovLM(vocab=vocab, seed=0, order=1).sample(BATCH, SEQ, step=step)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's step with ``rank_schedule`` and ``track_residual``:
    one unweighted and one weighted step from one initial state (one
    trace); that state as numpy."""
    cfg = _cfg(jllama)
    sim = JSimMesh(W)
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2,
                              rank_schedule=SCHEDULE, track_residual=True)
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper)
    params, ef = init(KEY)
    start = {"params": _np(jax.tree_util.tree_map(lambda x: x[0], params)),
             "comp": _np(jax.tree_util.tree_map(lambda x: x[0], ef.comp))}
    batch = sim.shard(_batch(cfg.vocab_size))
    out = {}
    for name, weights in (("plain", None), ("weighted", jnp.asarray(WEIGHTS))):
        p, e = init(KEY)
        _, _, m = step(p, e, batch, jax.random.key(0), weights=weights)
        out[name] = {k: float(m[k][0]) for k in ("lm_loss", "residual_ratio")}
    return start, out


def _port_state(start):
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    return params, ef


@pytest.mark.parametrize("case", ["plain", "weighted"])
def test_step_residual_matches_reference(reference_steps, case):
    """The step's residual ratio is the workers' ratios averaged as the loss
    is (weighted under scenario weights): within rtol 1e-5 of the
    reference's, the loss within 1e-5 too, and only 2 reduces recorded."""
    start, want = reference_steps
    stats = dist.CollectiveStats()
    cfg = _cfg(llama3_8b)
    step, _ = train.make_sim_train_step(
        cfg, SimMesh(W), train.TrainHyper(q_chunk=16, warmup_steps=2,
                                          rank_schedule=SCHEDULE,
                                          track_residual=True),
        stats=stats, device="cpu")
    params, ef = _port_state(start)
    batch = SimMesh(W).shard({k: torch.tensor(v)
                              for k, v in _batch(cfg.vocab_size).items()})
    _, _, m = step(params, ef, batch,
                   weights=None if case == "plain" else WEIGHTS)
    assert m["residual_ratio"].shape == ()
    np.testing.assert_allclose(m["residual_ratio"].item(),
                               want[case]["residual_ratio"], rtol=RESIDUAL_RTOL)
    np.testing.assert_allclose(m["lm_loss"].item(), want[case]["lm_loss"], rtol=1e-5)
    assert stats.kinds == ["reduce", "reduce"]


def test_step_with_controller_switches_rank():
    """The staircase through ``make_sim_train_step``: ranks 2, 2, 4, 4 with
    payload bits following, a finite residual every step, error buffers and
    momentum untouched by the switch itself."""
    cfg = _cfg(llama3_8b)
    comp = compressors.make_compressor("powersgd", rank_schedule=SCHEDULE,
                                       track_residual=True)
    step, init = train.make_sim_train_step(
        cfg, SimMesh(W), train.TrainHyper(q_chunk=16, warmup_steps=2),
        compressor=comp, device="cpu")
    params, ef = init(torch.Generator().manual_seed(0))
    ctl, residual, ranks, bits = comp.controller(), None, [], []
    for i in range(4):
        before = (tree.map(torch.clone, ef.error), tree.map(torch.clone, ef.momentum))
        new_comp, changed = ctl.update(ef.comp, i, residual)
        if changed:
            ef = error_feedback.replace_comp(ef, new_comp)
            assert all(torch.equal(a, b) for a, b in zip(
                tree.leaves(before[0]) + tree.leaves(before[1]),
                tree.leaves(ef.error) + tree.leaves(ef.momentum)))
        ranks.append(ctl.rank)
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in _batch(cfg.vocab_size, i).items()}))
        residual = m["residual_ratio"].item()
        assert 0 < residual < 1.5
        bits.append(m["bits_per_worker"])
        assert bits[-1] == 32 * sum(bench.payload_floats(params, model.mspecs(cfg),
                                                         ef.comp))
    assert ranks == [2, 2, 4, 4] and bits[0] == bits[1] < bits[2] == bits[3]


SWITCH_W, SWITCH_SCHEDULE, SWITCH_STEPS = 4, "2@0,4@1,1@3", 4


def test_step_across_rank_switches_matches_reference():
    """A growth, then a cut, through both packages' ``make_sim_train_step``
    at W = 4: the reference's ``RankController`` (its factors unreplicated
    for the switch and replicated after it) against the port's controller
    fed the reference's columns.  Per step the rank, the loss and the
    residual ratio; at the end the parameters and the factors, at this
    file's tolerances (losses and residuals rtol 1e-5, parameters atol 2e-6
    as in ``tests/test_torch_train.py``, factors ``MIXED_TOL`` of each
    leaf's scale)."""
    cfg = _cfg(jllama)
    sim = JSimMesh(SWITCH_W)
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2,
                              rank_schedule=SWITCH_SCHEDULE, track_residual=True)
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper)
    params, ef = init(KEY)
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[0], t, is_leaf=lambda x: x is None)
    start = {"params": _np(first(params)), "comp": _np(first(ef.comp))}
    batches = [_batch(cfg.vocab_size, i) for i in range(SWITCH_STEPS)]
    jctl, residual, want = jpsgd.RankController(SWITCH_SCHEDULE), None, []
    for i, b in enumerate(batches):
        comp, changed = jctl.update(first(ef.comp), i, residual)
        if changed:
            ef = jef.replace_comp(ef, sim.replicate(comp))
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        residual = float(m["residual_ratio"][0])
        want.append((jctl.rank, float(m["lm_loss"][0]), residual))
    want_params, want_comp = _np(first(params)), _np(first(ef.comp))

    psim = SimMesh(SWITCH_W)
    pstep, _ = train.make_sim_train_step(
        _cfg(llama3_8b), psim,
        train.TrainHyper(q_chunk=16, warmup_steps=2, rank_schedule=SWITCH_SCHEDULE,
                         track_residual=True), device="cpu")
    params = bridge.to_torch(start["params"])
    ef = EFState(error=tree.map(lambda p: torch.zeros((SWITCH_W,) + tuple(p.shape)),
                                params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start["comp"]))
    ctl, residual, got = FedController(SWITCH_SCHEDULE), None, []
    for i, b in enumerate(batches):
        comp, changed = ctl.update(ef.comp, i, residual)
        if changed:
            ef = error_feedback.replace_comp(ef, comp)
        params, ef, m = pstep(params, ef, psim.shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        residual = m["residual_ratio"].item()
        got.append((ctl.rank, m["lm_loss"].item(), residual))

    assert [g[0] for g in got] == [w[0] for w in want] == [2, 4, 4, 1]
    assert ctl.history == jctl.history == [(0, 2), (1, 4), (3, 1)]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want],
                               rtol=RESIDUAL_RTOL)
    for (path, g), w in zip(tree.items(bridge.to_numpy(params)),
                            tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, atol=2e-6, rtol=0, err_msg=str(path))
    _close_scaled(ef.comp, want_comp, "q")


def test_dense_warmup_reports_no_residual():
    """A property of the reference kept as it is: with
    ``start_compress_step > 0`` every step goes through its warm-up switch,
    which returns no metrics, so no step reports a residual ratio, the
    compressed ones included.  Without the warm-up every step does."""
    rng = np.random.default_rng(4)
    shapes = {"w": (12, 8), "b": (5,)}
    specs = lambda mod: {"w": mod.MatrixSpec("matrix", 0), "b": mod.NONE}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal((W,) + s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    # the reference, jitted as its training step runs it
    sim = JSimMesh(W)
    jc = jcomp.make_compressor("powersgd", rank=2, track_residual=True)
    for k, want_keys in ((2, set()), (0, {"residual_ratio", "bucket_residual_ratio"})):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        ef = sim.replicate(jef.init_state(jc, jp, specs(jmz), KEY))
        jp = sim.replicate(jp)

        def one(p, g, e, k=k):
            p, e, aux = jef.apply_updates(jc, p, g, e, specs(jmz), lr=0.1,
                                          ctx=sim.ctx(), key=KEY,
                                          start_compress_step=k)
            return p, e, {n: v for n, v in aux.items() if n != "bits_per_worker"}

        run = jax.jit(sim.run(one))
        port_comp = compressors.make_compressor("powersgd", rank=2,
                                                track_residual=True)
        p = bridge.to_torch(params)
        pef = EFState(error=tree.map(lambda x: torch.zeros((W,) + tuple(x.shape)), p),
                      momentum=tree.map(torch.zeros_like, p),
                      comp=bridge.to_torch(_np(jax.tree_util.tree_map(
                          lambda x: x[0], ef.comp))))
        for g in grads:
            jp, ef, jaux = run(jp, jax.tree_util.tree_map(jnp.asarray, g), ef)
            p, pef, aux = error_feedback.apply_updates(
                port_comp, p, bridge.to_torch(g), pef, specs(mz), lr=0.1,
                ctx=SimMesh(W).ctx(), start_compress_step=k)
            assert set(jaux) == want_keys
            assert set(aux) - {"bits_per_worker"} == want_keys
    # the training step likewise
    cfg = _cfg(llama3_8b)
    step, init = train.make_sim_train_step(
        cfg, SimMesh(W), train.TrainHyper(q_chunk=16, warmup_steps=2,
                                          track_residual=True,
                                          start_compress_step=2), device="cpu")
    params, ef = init(torch.Generator().manual_seed(0))
    for i in range(3):
        params, ef, m = step(params, ef, SimMesh(W).shard(
            {k: torch.tensor(v) for k, v in _batch(cfg.vocab_size, i).items()}))
        assert "residual_ratio" not in m


if __name__ == "__main__":
    # each residual decision's margin to its thresholds in the train_lm run
    got, want, residuals, sched = _lm_runs(LM_SCHEDULES["residual"])
    print("rank history", got["rank_history"], "reference", want["rank_history"])
    for step, r in enumerate(residuals):
        if r is None or step % sched.every:
            continue
        print(f"step {step}: residual {r:.6f}, grow_above {sched.grow_above} "
              f"margin {r - sched.grow_above:+.3e}, shrink_below "
              f"{sched.shrink_below} margin {r - sched.shrink_below:+.3e}")
    print("eval_loss rel gap", abs(got["eval_loss"] - want["eval_loss"])
          / abs(want["eval_loss"]))
