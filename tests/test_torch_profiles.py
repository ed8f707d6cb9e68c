"""The benchmark profiles of the port (``resume_overhead``, ``comm_profile``,
``zoo_transport_profile``, ``sync_mode_profile`` and ``overlap_profile`` of
``repro_torch.bench.tables``, with ``comm_time_from_stats`` and
``resume_profile`` of ``repro_torch.bench.common``) against the JAX
package's ``benchmarks/tables.py`` and ``benchmarks/common.py``.

* ``comm_time_from_stats`` equals the reference's on the same records
  (reduce, gather and broadcast; itemsizes 4, 2, 1 and 0.5; scale
  sidecars; ``overlap_compute_s``), and on each package's own recorded
  traces of the same steps (Top-K on the int4 wire, PowerSGD under
  ``sync_mode="broadcast"`` at W = 4).
* ``comm_profile`` rows equal the reference's on a small tree and on
  reduced Llama-3-8B.
* ``zoo_transport_profile`` with ``_wire_loss_run`` stubbed in both
  packages by one fake: the same calls, and rows equal but for the
  declared C1 entries (``DECLARED_C1``, ROADMAP C1: the port keeps Top-K's
  and Sign+Norm's integer parts in exact chunks of their own, so on the
  float32 wire both send one more gather, and Sign+Norm's signs travel as
  int8, which moves the int8 and int4 rows' ratio to float32 too).
* ``overlap_profile`` with ``_stale_loss_run`` stubbed in both packages:
  the same calls (staleness, workers, steps, each step's scenario
  weights) and rows equal, the modeled arm included.
* ``sync_mode_profile`` with ``subprocess.run`` stubbed (both packages'
  measurement runs through it): the column ``None`` in both, rows equal.
* ``_wire_loss_run`` (int4 wire) and ``_stale_loss_run`` (one-step,
  rotating dropout), 3 steps of reduced Llama-3-8B at W = 4 from the
  reference's initial parameters and factors (``bridge``): losses within
  ``LOSS_RTOL``.
* ``resume_profile`` on the CPU at a few steps: ``resume_full`` bit-exact
  against the uninterrupted run (same ``final_loss_hex``), degraded
  restores finite, the rows' keys and order and the envelope's MB equal
  to the reference's run of the same spec.
* The gloo measurement of ``sync_mode_profile`` (4 processes), 2 steps a
  mode: a positive time for each mode.

``python tests/test_torch_profiles.py`` prints both packages' trace rows
on reduced Llama-3-8B (the tree ``python -m repro_torch.bench.run`` uses)
and the entries that differ; with ``--loss-runs`` also both packages'
60-step PowerSGD runs of ``zoo_transport_profile`` (float32 and int4
wires) from the reference's initial state, a few minutes.
"""

import dataclasses
import functools
import importlib.util
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import dist as jdist
from repro.core import matrixize as jmz
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.bench import common as bench
from repro_torch.bench import tables
from repro_torch.configs import llama3_8b
from repro_torch.core import dist
from repro_torch.core import matrixize as mz
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


def _load_reference_tables():
    """``benchmarks/tables.py`` under a name of its own (it imports
    ``benchmarks.common`` by package name, the repo root on ``sys.path``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "reference_bench_tables_profiles", ROOT / "benchmarks" / "tables.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


jtables = _load_reference_tables()
jcommon = sys.modules["benchmarks.common"]

KEY = jax.random.key(0)
W, LOSS_STEPS = 4, 3
# losses of 3 steps from the reference's state: the packages' float32
# gradients and (int4) quantizer differ in rounding only
LOSS_RTOL = 1e-5

# (algorithm, wire_dtype) → the keys whose values differ from the
# reference's (ROADMAP C1); every other entry of every row is equal
DECLARED_C1 = {
    ("sign_norm", "float32"): {"collectives_per_step", "gather_collectives",
                               "gather_kb_per_step_w16", "modeled_comm_ms_w16"},
    ("sign_norm", "int8"): {"wire_bytes_ratio_vs_float32"},
    ("sign_norm", "int4"): {"wire_bytes_ratio_vs_float32"},
    ("top_k", "float32"): {"collectives_per_step", "gather_collectives",
                           "modeled_comm_ms_w16"},
}


def _items(rows):
    return [list(r.items()) for r in rows]


SHAPES = {"w1": (24, 16), "conv": (8, 4, 3, 3), "stack": (3, 12, 6),
          "bias": (7,), "scale": (5,)}


def _small_tree(names=tuple(SHAPES)):
    """The tree of ``SHAPES`` (its leaves ``names``) in both packages."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(SHAPES[k]).astype(np.float32) for k in names}

    def specs(mod):
        spec = {"w1": mod.MatrixSpec("matrix", 0), "conv": mod.MatrixSpec("conv", 0),
                "stack": mod.MatrixSpec("matrix", 1), "bias": mod.NONE,
                "scale": mod.NONE}
        return {k: spec[k] for k in names}

    return ((jax.tree_util.tree_map(jnp.asarray, params), specs(jmz)),
            (bridge.to_torch(params), specs(mz)))


def _llama_tree():
    jcfg, cfg = jllama.reduced_config(), llama3_8b.reduced_config()
    return ((jmodel.init(KEY, jcfg, 1), jmodel.mspecs(jcfg)),
            (model.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
             model.mspecs(cfg)))


# ---------------------------------------------------------------------------
# comm_time_from_stats
# ---------------------------------------------------------------------------

RECORDS = [(1000, 4, "reduce", 0), (333, 2, "reduce", 0),
           (4096, 1, "gather", 64), (1001, 0.5, "gather", 8),
           (2048, 4, "broadcast", 0), (17, 4, "gather", 0)]


@pytest.mark.parametrize("overlap", [0.0, 1e-4, 0.02])
@pytest.mark.parametrize("workers", [1, 2, 4, 16])
@pytest.mark.parametrize("backend", ["nccl_10gbit", "gloo_10gbit"])
def test_comm_time_from_stats_equals_reference(backend, workers, overlap):
    want_stats, got_stats = jdist.CollectiveStats(), dist.CollectiveStats()
    for size, itemsize, kind, overhead in RECORDS:
        for st in (want_stats, got_stats):
            st.record(size, itemsize, kind=kind,
                      fanout=workers if kind == "gather" else 1,
                      overhead=overhead)
    assert (bench.comm_time_from_stats(got_stats, workers, backend,
                                       overlap_compute_s=overlap)
            == jcommon.comm_time_from_stats(want_stats, workers, backend,
                                            overlap_compute_s=overlap))


class CapturedTraces:
    """Wraps ``comm_time_from_stats`` in both packages' table modules and
    keeps every trace a profile prices, each package's in its own list."""

    def __init__(self, monkeypatch):
        self.want, self.got = [], []
        for mod, seen in ((jcommon, self.want), (tables, self.got)):
            def wrapped(stats, *a, _inner=mod.comm_time_from_stats, _seen=seen,
                        **kw):
                _seen.append(stats)
                return _inner(stats, *a, **kw)
            monkeypatch.setattr(mod, "comm_time_from_stats", wrapped)

    def hold(self, skip=()):
        """Every pair of traces but those at the indices ``skip`` records
        the same collectives, and the port's ``comm_time_from_stats``
        prices each as the reference's does, unrounded, at W = 1, 4, 16
        and with and without an overlap."""
        assert len(self.got) == len(self.want) > 0
        for i, (got, want) in enumerate(zip(self.got, self.want)):
            if i in skip:
                continue
            assert (got.kinds, got.sizes, got.itemsizes, got.overheads) == (
                want.kinds, want.sizes, want.itemsizes, want.overheads)
            for w in (1, 4, 16):
                for overlap in (0.0, 2e-5):
                    assert (bench.comm_time_from_stats(got, w, "gloo_10gbit",
                                                       overlap_compute_s=overlap)
                            == jcommon.comm_time_from_stats(
                                want, w, "gloo_10gbit", overlap_compute_s=overlap))


# ---------------------------------------------------------------------------
# the trace profiles, training and measurement stubbed
# ---------------------------------------------------------------------------

def test_comm_profile_rows_equal_reference():
    (jp, js), (p, s) = _small_tree()
    got = tables.comm_profile(p, s, device="cpu")
    assert _items(got) == _items(jtables.comm_profile(jp, js))
    assert [r["engine"] for r in got] == ["per_leaf", "bucketed"]
    assert got[1]["collectives_per_step"] == 2


class FakeLossRuns:
    """Stands in for ``_wire_loss_run`` / ``_stale_loss_run`` in both
    packages: records each call (with the first 8 steps' scenario weights)
    and returns losses that depend on the call alone."""

    def __init__(self):
        self.calls, self.devices = [], []

    def wire(self, wire_dtype, workers, steps, **kw):
        self.devices.append(kw.pop("device", "not given"))
        assert not kw
        self.calls.append(("wire", wire_dtype, workers, steps))
        return [7.0 - 0.05 * i - len(wire_dtype) / 9.0 for i in range(steps)]

    def stale(self, staleness, workers, steps, weights_for_step=None, **kw):
        self.devices.append(kw.pop("device", "not given"))
        assert not kw
        weights = (None if weights_for_step is None
                   else [np.asarray(weights_for_step(i)).tolist() for i in range(8)])
        self.calls.append(("stale", staleness, workers, steps, weights))
        k = len(self.calls)
        return [7.0 - 0.04 * i + k / 13.0 for i in range(steps)]


def test_zoo_transport_profile_rows_equal_reference_but_declared(monkeypatch):
    # two leaves: each scheme's eager reference step compiles its ops anew
    (jp, js), (p, s) = _small_tree(("w1", "bias"))
    want_fake, got_fake = FakeLossRuns(), FakeLossRuns()
    monkeypatch.setattr(jtables, "_wire_loss_run", want_fake.wire)
    monkeypatch.setattr(tables, "_wire_loss_run", got_fake.wire)
    traces = CapturedTraces(monkeypatch)
    want = jtables.zoo_transport_profile(jp, js)
    got = tables.zoo_transport_profile(p, s, device="cpu")
    assert got_fake.calls == want_fake.calls == [
        ("wire", wd, 4, 60) for wd in ("float32", "int8", "int4")]
    assert [d.type for d in got_fake.devices] == ["cpu"] * 3
    assert [list(r) for r in got] == [list(r) for r in want]
    differ = {}
    for a, b in zip(got, want):
        keys = {k for k in a if a[k] != b[k]}
        if keys:
            differ[(a["algorithm"], a["wire_dtype"])] = keys
    assert differ == DECLARED_C1
    # one trace a row; the float32 rows' records differ (C1), the rest are
    # equal and priced alike (int4's gathers carry scale sidecars)
    assert len(traces.got) == len(got)
    traces.hold(skip={i for i, r in enumerate(got) if r["wire_dtype"] == "float32"
                      and r["algorithm"] in ("sign_norm", "top_k")})
    assert any(sum(st.overheads) > 0 and 0.5 in st.itemsizes
               and "gather" in st.kinds for st in traces.got)
    row = {(r["algorithm"], r["wire_dtype"]): r for r in got}
    for name in ("sign_norm", "top_k"):
        assert row[name, "float32"]["collectives_per_step"] == 3
        assert row[name, "float32"]["gather_collectives"] == 2
    assert (row["top_k", "float32"]["gather_kb_per_step_w16"]
            == {(r["algorithm"], r["wire_dtype"]): r for r in want}[
                "top_k", "float32"]["gather_kb_per_step_w16"])


def test_overlap_profile_rows_and_calls_equal_reference(monkeypatch):
    (jp, js), (p, s) = _small_tree()
    want_fake, got_fake = FakeLossRuns(), FakeLossRuns()
    monkeypatch.setattr(jtables, "_stale_loss_run", want_fake.stale)
    monkeypatch.setattr(tables, "_stale_loss_run", got_fake.stale)
    traces = CapturedTraces(monkeypatch)
    want = jtables.overlap_profile(jp, js, steps=9)
    got = tables.overlap_profile(p, s, steps=9, device="cpu")
    traces.hold()
    assert got_fake.calls == want_fake.calls
    assert [(c[1], c[3]) for c in got_fake.calls] == [
        (st, 9) for _ in range(3) for st in ("none", "one_step")]
    assert [d.type for d in got_fake.devices] == ["cpu"] * 6
    assert _items(got) == _items(want)
    modeled = [r for r in got if r["arm"] == "modeled"]
    assert len(modeled) == 6 and all(r["hidden_comm_pct"] >= 80 for r in modeled)


def test_sync_mode_profile_rows_equal_reference(monkeypatch):
    (jp, js), (p, s) = _small_tree()
    runs = []

    def no_measurement(cmd, **kw):
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="stubbed")

    monkeypatch.setattr(subprocess, "run", no_measurement)
    traces = CapturedTraces(monkeypatch)
    want = jtables.sync_mode_profile(jp, js)
    got = tables.sync_mode_profile(p, s, device="cpu")
    traces.hold()
    assert [st.broadcast_collectives for st in traces.got] == [0, 1]
    assert len(runs) == 2
    assert runs[1][1:] == ["-m", "repro_torch.bench.sync_measure", "--steps", "10"]
    assert _items(got) == _items(want)
    assert [r["measured_step_ms_mesh4x1"] for r in got] == [None, None]
    assert [r["broadcast_collectives"] for r in got] == [0, 1]


# ---------------------------------------------------------------------------
# the measured arms from the reference's initial state
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_numpy_start():
    """The initial parameters and factors (worker 0's) of the reference's
    ``make_sim_train_step`` at W, as its loss runs draw them from
    ``key(0)`` (the draw does not depend on the wire or the staleness)."""
    _, init = jtrain.make_sim_train_step(
        jllama.reduced_config(), JSimMesh(W),
        jtrain.TrainHyper(q_chunk=32, warmup_steps=5, remat=False))
    params, ef = init(KEY)
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x[0]), t,
        is_leaf=lambda x: x is None)
    return first(params), first(ef.comp)


def _reference_start():
    params, comp = _reference_numpy_start()
    return {"params": bridge.to_torch(params), "comp_state": bridge.to_torch(comp)}


def _dropout(step):
    w = np.ones((W,), np.float32)
    w[step % W] = 0.0
    return w


def test_wire_loss_run_int4_matches_reference():
    want = jtables._wire_loss_run("int4", W, LOSS_STEPS)
    got = tables._wire_loss_run("int4", W, LOSS_STEPS, device="cpu",
                                **_reference_start())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_stale_loss_run_one_step_dropout_matches_reference():
    want = jtables._stale_loss_run("one_step", W, LOSS_STEPS, _dropout)
    got = tables._stale_loss_run(
        "one_step", W, LOSS_STEPS, _dropout, device="cpu", **_reference_start())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# resume_profile and the gloo measurement, run
# ---------------------------------------------------------------------------

RESUME_STEPS = 5


def test_resume_profile_bit_exact_keys_as_reference(tmp_path, monkeypatch):
    """The port's profile at 5 steps of the benchmark LM (the kill after
    step 4); the reference's run of the same spec gives the rows' keys and
    the envelope's size, its training step stubbed by one that only counts
    (its compile would cost most of this file's minute)."""
    got = bench.resume_profile(bench.LMSpec(steps=RESUME_STEPS),
                               str(tmp_path / "port"), ckpt_every=2, device="cpu")
    real = jtrain.make_sim_train_step

    def counting_step(*args, **kw):
        _, init = real(*args, **kw)
        step = lambda params, ef, batch, key: (
            params, dataclasses.replace(ef, step=ef.step + 1),
            {"lm_loss": jnp.zeros((W,))})
        return step, init

    monkeypatch.setattr(jtrain, "make_sim_train_step", counting_step)
    want = jcommon.resume_profile(jcommon.LMSpec(steps=RESUME_STEPS),
                                  str(tmp_path / "reference"), ckpt_every=2)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["mode"] for r in got] == [r["mode"] for r in want]
    uninterrupted, full, drop_ef, drop_warm, cost = got
    assert full["bitexact_vs_uninterrupted"] is True
    assert full["final_loss_hex"] == uninterrupted["final_loss_hex"]
    assert full["eval_loss"] == uninterrupted["eval_loss"]
    for row in (drop_ef, drop_warm):
        assert math.isfinite(row["eval_loss"]) and row["post_resume_loss_spike"] >= 0
    keep = ("workers", "steps", "ckpt_every", "ckpt_mb")
    assert {k: cost[k] for k in keep} == {k: want[-1][k] for k in keep}
    assert cost["save_ms_mean"] > 0 and cost["restore_ms"] > 0


def test_sync_measure_gloo_runs():
    measured = tables._sync_measure(steps=2)
    assert sorted(measured) == ["allreduce", "broadcast"]
    assert all(math.isfinite(t) and t > 0 for t in measured.values())


def _print_trace_rows():
    """Both packages' trace rows on reduced Llama-3-8B, the entries that
    differ (the loss runs stubbed with NaN)."""
    (jp, js), (p, s) = _llama_tree()
    for mod in (jtables, tables):
        mod._wire_loss_run = lambda wd, workers, steps, **kw: [math.nan] * steps
        mod._stale_loss_run = lambda *a, **kw: [math.nan] * a[2]
    for name, extra in (("comm_profile", {}), ("zoo_transport_profile", {}),
                        ("overlap_profile", {"steps": 5})):
        want = getattr(jtables, name)(jp, js, **extra)
        got = getattr(tables, name)(p, s, device="cpu", **extra)
        for a, b in zip(got, want):
            diff = {k: (a[k], b[k]) for k in a
                    if a[k] != b[k] and not (a[k] != a[k] and b[k] != b[k])}
            print(name, {k: a[k] for k in list(a)[:3]},
                  "equal" if not diff else f"differs (port, reference): {diff}")


def _print_loss_runs(steps=60):
    """``zoo_transport_profile``'s 60-step PowerSGD runs (float32 and int4
    wires) in both packages from the reference's initial state: the mean
    of the last 5 losses and the largest relative gap over the run."""
    for wd in ("float32", "int4"):
        got = tables._wire_loss_run(wd, W, steps, device="cpu", **_reference_start())
        want = jtables._wire_loss_run(wd, W, steps)
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"{wd}: final5 port {float(np.mean(got[-5:]))!r}, reference "
              f"{float(np.mean(want[-5:]))!r}; first step gap "
              f"{abs(got[0] - want[0]) / abs(want[0]):.2e}, largest {gap:.2e}")


if __name__ == "__main__":
    # python tests/test_torch_profiles.py [--loss-runs]
    _print_trace_rows()
    if "--loss-runs" in sys.argv:
        _print_loss_runs()
