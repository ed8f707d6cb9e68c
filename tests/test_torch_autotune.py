"""The α-β autotuner (``repro_torch.core.autotune``) against the JAX
package's ``repro.core.autotune``, on the same shapes.

* ``TunePlan`` equal field for field (``predicted_comm_s`` and
  ``leaf_ranks`` included) on the benchmark LM, reduced Llama-3-8B,
  ResNet-18 and the LSTM, over budgets from infeasible to unconstrained,
  every wire candidate set, chunk caps, measured bucket residuals,
  ``overlap_compute_s``, tolerances and worker counts.  The reference's
  default link (``hw=None``: its roofline) is handed to the port as a
  ``HardwareModel`` built from the reference's ``alpha``/``bw``; the port's
  ``from_roofline`` and ``hw=None`` raise (ROADMAP queue A, item 16).
* ``collective_time`` and ``comm_time_from_stats`` equal on recorded
  stats.
* ``apply_plan`` bit for bit in the retained columns; a growth fed the
  reference's columns bit for bit; ``make_tuned_compressor`` threads the
  plan's wire, chunk cap and tolerance, and a mixed-rank step issues the
  plan's bits in 2 reduces at the wire's itemsize.
* The reference's own ``tests/test_autotune.py`` properties, on the port.
* ``train_lm(init_comp_transform=apply_plan)`` from the reference's initial
  state against the reference's ``train_lm`` on the bfloat16 wire.
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
from repro.core import autotune as jautotune
from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import engine as jengine
from repro.core import matrixize as jmz
from repro.core import powersgd as jpsgd
from repro.models import lstm as jlstm
from repro.models import model as jmodel
from repro.models import resnet as jresnet
from repro_torch import bridge, tree
from repro_torch.bench import common as bench
from repro_torch.configs import llama3_8b
from repro_torch.core import autotune, dist, matrixize as mz, powersgd
from repro_torch.core.compressors import PowerSGDCompressor
from repro_torch.models import lstm, model, resnet


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
    "reference_bench_common", ROOT / "benchmarks" / "common.py")
if _spec.name in sys.modules:
    jbench = sys.modules[_spec.name]
else:
    jbench = importlib.util.module_from_spec(_spec)
    sys.modules[_spec.name] = jbench   # its dataclasses look their module up
    _spec.loader.exec_module(jbench)

KEY = jax.random.key(0)
JHW = jautotune.HardwareModel.from_roofline()
# the reference's default link, as the port takes it
ROOFLINE = autotune.HardwareModel(alpha=JHW.alpha, bw=JHW.bw)
NCCL = autotune.HardwareModel.from_backend("nccl_10gbit")


def _jshapes(params):
    return jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)


def _lm():
    cfg = bench._make_cfg(bench.LMSpec())
    jparams = jax.eval_shape(lambda: jmodel.init(
        KEY, jbench._make_cfg(jbench.LMSpec()), 1))
    return ((model.init(cfg, None, device="meta"), model.mspecs(cfg)),
            (jparams, jmodel.mspecs(jbench._make_cfg(jbench.LMSpec()))))


def _llama():
    jcfg = jllama.reduced_config()
    jparams = jax.eval_shape(lambda: jmodel.init(KEY, jcfg, 1))
    cfg = llama3_8b.reduced_config()
    return ((model.init(cfg, None, device="meta"), model.mspecs(cfg)),
            (jparams, jmodel.mspecs(jcfg)))


def _resnet():
    params, _ = resnet.init(resnet.paper_resnet18(), None, device="meta")
    jparams, _ = jax.eval_shape(lambda: jresnet.init(KEY, jresnet.paper_resnet18()))
    return (params, resnet.mspecs(params)), (jparams, jresnet.mspecs(jparams))


def _lstm():
    params = lstm.init(lstm.paper_lstm(), None, device="meta")
    jparams = jax.eval_shape(lambda: jlstm.init(KEY, jlstm.paper_lstm()))
    return (params, lstm.mspecs(params)), (jparams, jlstm.mspecs(jparams))


TREES = {"bench_lm": _lm, "llama_reduced": _llama, "resnet18": _resnet,
         "lstm": _lstm}
WIRE_SETS = {"default": None, "float32": ("float32",), "bfloat16": ("bfloat16",),
             "int8": ("int8",), "int4": ("int4",),
             "all": ("float32", "bfloat16", "int8", "int4")}


def _fields(plan):
    return dataclasses.asdict(plan)


def _both(trees, *, hw, jhw="same", **kw):
    """The port's and the reference's plan for the same arguments; ``hw``
    is the port's link, ``jhw`` the reference's (``"same"``: the same
    figures; ``None``: the reference's default)."""
    (params, specs), (jparams, jspecs) = trees
    if jhw == "same":
        jhw = jautotune.HardwareModel(alpha=hw.alpha, bw=hw.bw)
    got = autotune.autotune(params, specs, hw=hw, **kw)
    want = jautotune.autotune(jparams, jspecs, hw=jhw, **kw)
    return got, want


@pytest.mark.parametrize("wires", sorted(WIRE_SETS))
@pytest.mark.parametrize("name", sorted(TREES))
def test_plan_equals_reference_field_for_field(name, wires):
    trees = TREES[name]()
    (params, specs), (jparams, jspecs) = trees
    r4 = powersgd.compressed_floats_total(params, specs, 4)
    assert r4 == jpsgd.compressed_floats_total(jparams, jspecs, 4)
    n_buckets = len(autotune.autotune(params, specs, bits_budget=r4 * 32,
                                      workers=4, hw=NCCL).decisions)
    kw = {} if WIRE_SETS[wires] is None else {"wire_dtypes": WIRE_SETS[wires]}
    budgets = [1, r4 * 32 // 8, r4 * 32 // 2, r4 * 32 // 3, r4 * 32, 10**15]
    cases = [dict(bits_budget=b, workers=w) for b in budgets for w in (1, 4, 16)]
    cases += [
        dict(bits_budget=r4 * 16, workers=16, ranks=(1, 3, 7, 32)),
        dict(bits_budget=r4 * 16, workers=8, max_chunk_bytes_options=(None, 4096, 2**20)),
        dict(bits_budget=r4 * 16, workers=8, max_chunk_bytes_options=(65536,)),
        dict(bits_budget=r4 * 16, workers=8, tolerance=0.0),
        dict(bits_budget=r4 * 16, workers=8, tolerance=1.0),
        dict(bits_budget=r4 * 16, workers=8, overlap_compute_s=2e-4),
        dict(bits_budget=r4 * 16, workers=8, overlap_compute_s=10.0),
        dict(bits_budget=r4 * 12, workers=8,
             bucket_residuals=[(i * 0.37) % 1.0 for i in range(n_buckets)]),
        dict(bits_budget=r4 * 12, workers=8, bucket_residuals=[0.0] * n_buckets),
    ]
    for case in cases:
        for hw, jhw in ((NCCL, "same"), (ROOFLINE, None),
                        (autotune.HardwareModel.from_backend("gloo_10gbit"), "same")):
            got, want = _both(trees, hw=hw, jhw=jhw, **kw, **case)
            assert _fields(got) == _fields(want), case
            assert type(got.predicted_comm_s) is float
            assert got.rank_tree(params, specs) is not None


def test_hardware_model_and_comm_time_equal_reference():
    for name in ("nccl_10gbit", "gloo_10gbit"):
        hw, jhw = (autotune.HardwareModel.from_backend(name),
                   jautotune.HardwareModel.from_backend(name))
        assert (hw.alpha, hw.bw) == (jhw.alpha, jhw.bw)
        for kind in ("reduce", "broadcast", "gather"):
            for w in (1, 2, 3, 4, 16, 33):
                for nbytes in (0.0, 1.0, 508.0, 2_361_856.0, 5.9e9):
                    assert (hw.collective_time(nbytes, w, kind)
                            == jhw.collective_time(nbytes, w, kind))
    stats, jstats = dist.CollectiveStats(), jdist.CollectiveStats()
    for st in (stats, jstats):
        st.record(1000, itemsize=4, kind="reduce")
        st.record(500, itemsize=2, kind="gather", fanout=8)
        st.record(1000, itemsize=0.5, kind="reduce", overhead=8)
        st.record(857088, itemsize=0.5, kind="gather", fanout=4, overhead=24)
    for w in (1, 4, 16):
        for overlap in (0.0, 1e-4, 1.0):
            assert (autotune.comm_time_from_stats(stats, w, NCCL,
                                                  overlap_compute_s=overlap)
                    == jautotune.comm_time_from_stats(
                        jstats, w, jautotune.HardwareModel.from_backend(
                            "nccl_10gbit"), overlap_compute_s=overlap))


def test_recorded_step_equals_reference_comm_time():
    """The stats of one mixed-rank port step on the bfloat16 wire price as
    the reference's stats of the same step (recorded as it traces)."""
    (params, specs), (jparams, jspecs) = _lm()
    plan, jplan = _both(_lm(), hw=NCCL, bits_budget=powersgd.compressed_floats_total(
        params, specs, 4) * 16, workers=4)
    assert plan.wire_dtype == "bfloat16"
    jcompr = jautotune.make_tuned_compressor(jplan)
    jstats = jdist.CollectiveStats()

    def jstep():
        jstate = jautotune.apply_plan(jplan, jcompr.init(jparams, jspecs, KEY),
                                      jparams, jspecs, KEY)
        grads = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, p.dtype),
                                       jparams)
        return jcompr.step(grads, jstate, jspecs, ctx=jdist.MeshCtx(stats=jstats),
                           key=KEY).agg

    jax.eval_shape(jstep)
    compr = autotune.make_tuned_compressor(plan)
    grads = tree.map(lambda p: torch.randn(p.shape, generator=torch.Generator()
                                           .manual_seed(1)), params)
    state = autotune.apply_plan(
        plan, compr.init(grads, specs, torch.Generator().manual_seed(0)),
        params, specs)
    stats = dist.CollectiveStats()
    out = compr.step(grads, state, specs, ctx=dist.MeshCtx(stats=stats))
    assert out.bits_per_worker == plan.bits_per_step
    assert (stats.sizes, stats.itemsizes) == (jstats.sizes, jstats.itemsizes)
    assert stats.itemsizes == [2, 2]
    assert (autotune.comm_time_from_stats(stats, 4, NCCL)
            == jautotune.comm_time_from_stats(
                jstats, 4, jautotune.HardwareModel.from_backend("nccl_10gbit")))
    assert sum(stats.sizes) * 16 == plan.wire_bits_per_step


def test_from_roofline_and_default_link_raise():
    (params, specs), _ = _lm()
    with pytest.raises(NotImplementedError, match="item 16"):
        autotune.HardwareModel.from_roofline()
    with pytest.raises(NotImplementedError, match="item 16"):
        autotune.autotune(params, specs, bits_budget=10**9, workers=4)
    assert jautotune.HardwareModel.from_roofline().bw == pytest.approx(50e9)


# ---------------------------------------------------------------------------
# applying a plan
# ---------------------------------------------------------------------------

def _np(t):
    return jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x),
                                  t, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("name", ["bench_lm", "llama_reduced"])
def test_apply_plan_bit_equal_in_retained_columns(name):
    trees = TREES[name]()
    (params, specs), (jparams, jspecs) = trees
    r4 = powersgd.compressed_floats_total(params, specs, 4)
    plan, jplan = _both(trees, hw=NCCL, bits_budget=r4 * 16, workers=4)
    assert _fields(plan) == _fields(jplan)
    assert len({d.rank for d in plan.decisions}) > 1
    jcompr = jautotune.make_tuned_compressor(jplan)
    jstate = jcompr.init(jparams, jspecs, KEY)
    want = _np(jautotune.apply_plan(jplan, jstate, jparams, jspecs, KEY))
    state = bridge.to_torch(_np(jstate))
    got = autotune.apply_plan(plan, state, params, specs)
    rank_tree = plan.rank_tree(params, specs)
    for (path, g), w, r, q0 in zip(tree.items(got), tree.leaves(want),
                                   tree.leaves(rank_tree), tree.leaves(state)):
        assert (g is None) == (w is None) == (r is None), path
        if g is None:
            continue
        assert g.shape[-1] == r and g.is_contiguous(), path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        assert torch.equal(g, q0[..., :r]), path


def test_apply_plan_growth_takes_the_callers_draw():
    """A state below the plan's ranks grows; fed the reference's columns
    (``normal(leaf_key(key, path))``) it equals the reference's bit for
    bit, and without a draw it raises."""
    trees = _lm()
    (params, specs), (jparams, jspecs) = trees
    plan, jplan = _both(trees, hw=NCCL, bits_budget=10**12, workers=4)
    jstate = jpsgd.init_state(jpsgd.PowerSGDConfig(rank=1), jparams, jspecs, KEY)
    want = _np(jautotune.apply_plan(jplan, jstate, jparams, jspecs, KEY))

    def draw(path, shape):
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        return torch.tensor(np.asarray(jax.random.normal(
            jengine.leaf_key(KEY, jpath), shape, dtype=jnp.float32)))

    state = bridge.to_torch(_np(jstate))
    got = autotune.apply_plan(plan, state, params, specs, draw)
    for (path, g), w in zip(tree.items(got), tree.leaves(want)):
        if w is not None:
            assert g.shape[-1] > 1, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    with pytest.raises(ValueError, match="draw"):
        autotune.apply_plan(plan, state, params, specs)


def test_apply_plan_transitions_stacked_copies_alike():
    """A factor with a stacked worker dim keeps every copy's columns and
    appends the same columns to each."""
    plan, _ = _both(_lm(), hw=NCCL, bits_budget=10**12, workers=4)
    (params, specs), _ = _lm()
    g = torch.Generator().manual_seed(0)
    state = tree.map(lambda q: None if q is None else
                     torch.randn((3,) + tuple(q.shape[:-1]) + (1,), generator=g),
                     powersgd.init_state(powersgd.PowerSGDConfig(rank=1), params,
                                         specs, device="meta"))
    got = autotune.apply_plan(plan, state, params, specs,
                              lambda path, shape: torch.ones(shape))
    for q0, q in zip(tree.leaves(state), tree.leaves(got)):
        if q0 is not None:
            assert torch.equal(q[..., :1], q0)
            assert torch.equal(q[0, ..., 1:], q[2, ..., 1:])


def test_tuned_compressor_threads_wire_chunk_cap_and_tolerance():
    specs = {f"l{i}": mz.MatrixSpec("matrix", 0) for i in range(2)}
    params = {"l0": torch.empty(32, 16, device="meta"),
              "l1": torch.empty(30, 16, device="meta")}
    for kw in (dict(tolerance=0.0), dict(tolerance=0.25),
               dict(wire_dtypes=("int8",), max_chunk_bytes_options=(64,))):
        plan = autotune.autotune(params, specs, bits_budget=10**9, workers=8,
                                 hw=NCCL, **kw)
        comp = autotune.make_tuned_compressor(plan, track_residual=True)
        assert isinstance(comp, PowerSGDCompressor)
        assert comp.cfg.bucket_pad_tolerance == plan.tolerance
        assert comp.cfg.wire_dtype == comp.wire_dtype == plan.wire_dtype
        assert comp.cfg.max_chunk_bytes == plan.max_chunk_bytes
        assert comp.cfg.track_residual
        assert comp.cfg.rank == max(d.rank for d in plan.decisions)
        real = tree.map(lambda p: torch.randn(p.shape), params)
        state = autotune.apply_plan(
            plan, comp.init(real, specs, torch.Generator().manual_seed(0)),
            params, specs)
        out = comp.step(real, state, specs)   # buckets match the plan's
        assert out.bits_per_worker == plan.bits_per_step


# ---------------------------------------------------------------------------
# the reference's own properties (tests/test_autotune.py), on the port
# ---------------------------------------------------------------------------

def _tree():
    specs = {"big": mz.MatrixSpec("matrix", 0), "big2": mz.MatrixSpec("matrix", 0),
             "small": mz.MatrixSpec("matrix", 0), "v": mz.NONE}
    shapes = {"big": torch.empty(256, 128, device="meta"),
              "big2": torch.empty(250, 128, device="meta"),
              "small": torch.empty(16, 8, device="meta"),
              "v": torch.empty(64, device="meta")}
    return shapes, specs


def _budget(shapes, specs, rank):
    return powersgd.compressed_floats_total(shapes, specs, rank) * 32


def _tune(shapes, specs, **kw):
    kw.setdefault("hw", ROOFLINE)
    return autotune.autotune(shapes, specs, **kw)


def test_budget_monotone_infeasible_and_capped():
    shapes, specs = _tree()
    budget = _budget(shapes, specs, 4)
    plan = _tune(shapes, specs, bits_budget=budget, workers=8)
    assert plan.payload_floats * 32 <= budget - plan.uncompressed_floats * 32
    assert plan.bits_per_step == (plan.payload_floats + plan.uncompressed_floats) * 32
    assert len(plan.decisions) >= 2 and len(plan.leaf_ranks) == 4
    assert plan.leaf_ranks[sorted(shapes).index("v")] is None
    lo = _tune(shapes, specs, bits_budget=_budget(shapes, specs, 2), workers=8)
    hi = _tune(shapes, specs, bits_budget=_budget(shapes, specs, 8), workers=8)
    assert all(dh.rank >= dl.rank for dl, dh in zip(lo.decisions, hi.decisions))
    assert all(d.rank == 1 for d in _tune(shapes, specs, bits_budget=1, workers=8,
                                          ranks=(1, 2, 4)).decisions)
    for d in _tune(shapes, specs, bits_budget=10**9, workers=8).decisions:
        assert d.rank <= min(d.n, d.m) and d.rank * (d.n + d.m) <= d.n * d.m
    assert _tune(shapes, specs, bits_budget=budget, workers=1).predicted_comm_s == 0.0
    assert _tune(shapes, specs, bits_budget=budget, workers=8) == plan


def test_wire_selection_and_chunk_cap():
    shapes, specs = _tree()
    budget = _budget(shapes, specs, 4)
    both = _tune(shapes, specs, bits_budget=budget, workers=8)
    f32 = _tune(shapes, specs, bits_budget=budget, workers=8,
                wire_dtypes=("float32",))
    assert (both.wire_dtype, f32.wire_dtype) == ("bfloat16", "float32")
    assert both.predicted_comm_s < f32.predicted_comm_s
    assert both.bits_per_step == f32.bits_per_step
    assert both.wire_bits_per_step * 2 == f32.wire_bits_per_step
    with pytest.raises(ValueError):
        _tune(shapes, specs, bits_budget=budget, workers=8, wire_dtypes=("auto",))
    assert _tune(shapes, specs, bits_budget=budget, workers=8,
                 max_chunk_bytes_options=(None, 4096)).max_chunk_bytes is None


def test_residuals_steer_and_quantized_wires_buy_rank():
    shapes, specs = _tree()
    budget = _budget(shapes, specs, 3)
    n = len(_tune(shapes, specs, bits_budget=budget, workers=8).decisions)
    ranks = [d.rank for d in _tune(shapes, specs, bits_budget=budget, workers=8,
                                   bucket_residuals=[1.0] + [0.0] * (n - 1)
                                   ).decisions]
    assert ranks[0] == max(ranks), ranks
    tight = _budget(shapes, specs, 1)
    rank_only = _tune(shapes, specs, bits_budget=tight, workers=8,
                      wire_dtypes=("float32",))
    joint = _tune(shapes, specs, bits_budget=tight, workers=8,
                  wire_dtypes=("float32", "int4"))
    assert all(d.rank == 1 for d in rank_only.decisions)
    assert joint.wire_dtype == "int4"
    assert joint.payload_floats > rank_only.payload_floats
    assert joint.wire_bits_per_step < rank_only.wire_bits_per_step
    pays = [_tune(shapes, specs, bits_budget=tight, workers=8,
                  wire_dtypes=(wd,)).payload_floats
            for wd in ("float32", "int8", "int4")]
    assert pays[0] < pays[1] <= pays[2]


def test_tuned_mixed_rank_step_stays_in_budget():
    """The collective budget under a tuned mixed-rank state: one step on
    the plan's wire issues 2 reduces of that wire's itemsize and the plan's
    bits."""
    shapes, specs = _tree()
    plan = _tune(shapes, specs, bits_budget=_budget(shapes, specs, 4) // 2,
                 workers=16)
    comp = autotune.make_tuned_compressor(plan)
    real = tree.map(lambda p: torch.randn(p.shape), shapes)
    state = autotune.apply_plan(plan, comp.init(real, specs), shapes, specs)
    stats = dist.CollectiveStats()
    out = comp.step(real, state, specs, ctx=dist.MeshCtx(stats=stats))
    assert (stats.data_collectives, stats.gather_collectives) == (2, 0)
    assert out.bits_per_worker == plan.bits_per_step
    assert set(stats.itemsizes) == {2}


# ---------------------------------------------------------------------------
# train_lm under a tuned plan, against the reference
# ---------------------------------------------------------------------------

TUNED_STEPS = 5
# The bfloat16 wire rounds each P and Q element to 8 significant bits; the
# packages' float32 rounding (~1e-7 relative) flips such a rounding now and
# then (an element moves by 2⁻⁸ relative), and the flips compound: the
# eval_loss gap is 1.3e-7 relative after 1 step, 1.1e-5 after 5 and 3.3e-4
# after 10 (``python tests/test_torch_autotune.py``; the float32 wire's
# PowerSGD stays within 5.3e-7 over 30 steps).  So 5 steps within 1e-4.
TUNED_RTOL = 1e-4


def _tuned_runs(steps):
    spec, jspec = bench.LMSpec(steps=steps), jbench.LMSpec(steps=steps)
    cfg, jcfg = bench._make_cfg(spec), jbench._make_cfg(jspec)
    jparams = jmodel.init(jax.random.key(jspec.seed), jcfg, 1)
    jshapes, jspecs = _jshapes(jparams), jmodel.mspecs(jcfg)
    comp4 = jpsgd.compressed_floats_total(jshapes, jspecs, 4)
    jhw = jautotune.HardwareModel.from_backend("nccl_10gbit")
    jplan = jautotune.autotune(jshapes, jspecs, bits_budget=comp4 * 32 // 2,
                               workers=jspec.workers, hw=jhw)
    jcompr = jautotune.make_tuned_compressor(jplan)
    key = jax.random.key(jspec.seed)
    want = jbench.train_lm(jcompr, jspec, init_comp_transform=lambda cs:
                           jautotune.apply_plan(jplan, cs, jshapes, jspecs, key))
    jstate = _np(jcompr.init(jparams, jspecs, key))

    shapes, specs = model.init(cfg, None, device="meta"), model.mspecs(cfg)
    plan = autotune.autotune(shapes, specs, bits_budget=comp4 * 32 // 2,
                             workers=spec.workers, hw=NCCL)
    comp = autotune.make_tuned_compressor(plan)
    stats = dist.CollectiveStats()
    got = bench.train_lm(comp, spec, device="cpu",
                         params=bridge.to_torch(_np(jparams)),
                         comp_state=bridge.to_torch(jstate), stats=stats,
                         init_comp_transform=lambda cs: autotune.apply_plan(
                             plan, cs, shapes, specs))
    return got, want, plan, jplan, stats


def test_train_lm_tuned_plan_matches_reference():
    got, want, plan, jplan, stats = _tuned_runs(TUNED_STEPS)
    assert _fields(plan) == _fields(jplan)
    assert plan.wire_dtype == "bfloat16"
    assert len({d.rank for d in plan.decisions}) == 2
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=TUNED_RTOL)
    for k in ("compressor", "bits_per_worker_per_step", "allreduce", "steps",
              "workers", "compressed_floats_total"):
        assert got[k] == want[k], k
    # each leaf counted at its own rank: the plan's payload every step
    assert got["compressed_floats_total"] == TUNED_STEPS * plan.payload_floats
    assert stats.kinds == ["reduce"] * 2 * TUNED_STEPS
    assert set(stats.itemsizes) == {2}
    assert sum(stats.sizes[:2]) * 16 == plan.wire_bits_per_step


if __name__ == "__main__":
    # the gap behind TUNED_RTOL
    for steps in (1, 5, 10):
        got, want, *_ = _tuned_runs(steps)
        print(f"{steps} steps: eval_loss port {got['eval_loss']:.8f}, reference "
              f"{want['eval_loss']:.8f}, relative gap "
              f"{abs(got['eval_loss'] - want['eval_loss']) / want['eval_loss']:.2e}")
