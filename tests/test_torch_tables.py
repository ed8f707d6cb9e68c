"""The paper's table drivers (``repro_torch.bench.tables``), their entry
point (``repro_torch.bench.run``) and the α-β helpers of
``repro_torch.bench.common`` against the JAX package's
``benchmarks/tables.py`` and ``benchmarks/common.py``.

* ``comm_time``, ``broadcast_time`` and ``bytes_per_epoch_mb`` equal the
  reference's exactly.
* Tables 1, 2, 3, 4, 6 and Appendix D with training stubbed in both
  packages by one fake: the same ``make_compressor``/``train_lm``/
  ``_signum_row`` calls in the same order, and rows equal, keys and order
  included.  Table 7 likewise, its fake standing in for the LSTM's
  ``init``/``loss_fn``, error feedback and ``make_compressor``, its loss a
  function of each batch's labels.
* ``bits_per_worker_per_step`` of every (scheme, rank) the drivers train,
  from one probe step at the benchmark LM's shapes, equal to the
  reference's.
* ``_signum_row`` from the reference's initial parameters, its columns
  unrounded in both packages: ``eval_loss`` within rtol 1e-6 of the
  reference after 3 steps (measured 1.0e-7 after 3 steps, 2.4e-7 after
  10: float32 gradients of two packages), the other columns equal.
* Table 5 and Fig. 3 on a small tree: Fig. 3's rows equal; Table 5's
  equal but for ``coding_ms``, which is positive, finite, and W times the
  one-worker time for the gather scheme.
* Table 3 end to end on the port (2 steps, no stubs): the modeled columns
  equal the reference's ``_fmt`` of the reference's bits; losses finite.
* ``adaptive_rank_profile`` with training stubbed in both packages (a
  fake drives each package's own controllers and applies its own plan):
  rows equal, the autotuned row's plan included.
* ``bench/run.py``: ``--out`` required and kept out of
  ``experiments/benchmarks/``; ``--only`` matches parts of names; Table 7
  trains 120 steps, 40 under ``--quick``; the profiles of ROADMAP item 18
  (``tests/test_torch_profiles.py`` holds them against the reference) are
  called with the reference's arguments and their rows written; every
  driver, profile and the entry point default to the CUDA card and raise
  where there is none.
"""

import functools
import hashlib
import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.core import matrixize as jmz
from repro.models import lstm as jlstm
from repro.models import model as jmodel
from repro_torch import bridge, tree
from repro_torch.bench import common as bench
from repro_torch.bench import run, tables
from repro_torch.configs.base import get_config
from repro_torch.core import error_feedback
from repro_torch.core import matrixize as mz
from repro_torch.core.compressors import make_compressor
from repro_torch.models import lstm, model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = ROOT / "experiments" / "benchmarks"


def _load_reference_tables():
    """``benchmarks/tables.py`` under a name of its own.  It imports
    ``benchmarks.common`` by package name (the repo root on ``sys.path``),
    a module apart from the ``reference_bench_common`` other test files
    load by path."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("reference_bench_tables",
                                                  ROOT / "benchmarks" / "tables.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


jtables = _load_reference_tables()
jcommon = sys.modules["benchmarks.common"]

KEY = jax.random.key(0)

# every (registry name, rank) the training drivers build; identity is built
# without a rank
TRAINED = ([("identity", None)]
           + [("powersgd", r) for r in (1, 2, 4, 7, 8, 16, 32)]
           + [("unbiased_rank_k", 1), ("unbiased_rank_k", 2),
              ("powersgd_best_approx", 2), ("powersgd_cold", 2)]
           + [(n, r) for r in (7, 2) for n in ("random_block", "random_k", "top_k")]
           + [("sign_norm", 7), ("spectral_atomo", 2)])
DRIVERS = ["table1_error_feedback", "table2_warm_start", "table3_rank_sweep",
           "table4_compressor_zoo", "table6_other_methods",
           "appendixD_transformer"]
GATHER = {"sign_norm", "top_k", "spectral_atomo", "exact_rank_k"}


def _records_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(RECORDS.iterdir())}


def _items(rows):
    return [list(r.items()) for r in rows]


# ---------------------------------------------------------------------------
# the α-β helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2, 3, 16, 32])
@pytest.mark.parametrize("allreduce", [True, False])
@pytest.mark.parametrize("backend", ["nccl_10gbit", "gloo_10gbit"])
def test_alpha_beta_helpers_equal_reference(backend, allreduce, workers):
    assert bench.BW == jcommon.BW and bench.LATENCY == jcommon.LATENCY
    for nbytes in (0.0, 1.0, 55_808.0, 2_361_856.0, 5.9e9):
        assert (bench.comm_time(nbytes, workers, allreduce, backend)
                == jcommon.comm_time(nbytes, workers, allreduce, backend))
        assert (bench.broadcast_time(nbytes, workers, backend)
                == jcommon.broadcast_time(nbytes, workers, backend))
    for bits in (0, 446_464, 18_894_848, 47_580_839_936):
        assert (bench.bytes_per_epoch_mb(bits, workers)
                == jcommon.bytes_per_epoch_mb(bits, workers))


# ---------------------------------------------------------------------------
# the training drivers, training stubbed
# ---------------------------------------------------------------------------

class FakeTraining:
    """Stands in for ``make_compressor``, ``train_lm`` and ``_signum_row``
    in both packages: records each call and returns a fixed result that
    depends only on the call's scheme, rank and position."""

    def __init__(self):
        self.calls, self.devices = [], []

    def make_compressor(self, name, rank=None, **kw):
        assert not kw
        return ("compressor", name, rank)

    def train_lm(self, comp, spec, *, device="not given"):
        _, name, rank = comp
        self.calls.append(("train_lm", name, rank, spec.steps))
        self.devices.append(device)
        k = len(self.calls)
        return {"compressor": name, "eval_loss": 1.0 + k / 7.0 + 1e-7,
                "eval_ppl": 0.0,
                "bits_per_worker_per_step": 32 * (1000 + 17 * k) * (rank or 3),
                "allreduce": name not in GATHER, "train_time_s": 0.0,
                "steps": spec.steps, "workers": spec.workers,
                "compressed_floats_total": 0}

    def signum_row(self, spec, *, device="not given"):
        self.calls.append(("signum", None, None, spec.steps))
        self.devices.append(device)
        return {"algorithm": "signum", "eval_loss": 2.5, "data_per_epoch_mb": 2.9,
                "allreduce": False, "modeled_comm_ms_w16": 1.25}

    def install(self, monkeypatch, mod):
        monkeypatch.setattr(mod, "make_compressor", self.make_compressor)
        monkeypatch.setattr(mod, "train_lm", self.train_lm)
        monkeypatch.setattr(mod, "_signum_row", self.signum_row)


@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_calls_and_rows_equal_reference(driver, monkeypatch):
    want_fake, got_fake = FakeTraining(), FakeTraining()
    want_fake.install(monkeypatch, jtables)
    got_fake.install(monkeypatch, tables)
    want = getattr(jtables, driver)(jcommon.LMSpec(steps=7))
    got = getattr(tables, driver)(bench.LMSpec(steps=7), device="cpu")
    assert got_fake.calls == want_fake.calls
    assert _items(got) == _items(want)
    assert got_fake.devices == ["cpu"] * len(got_fake.calls)
    trained = {(n, r) for kind, n, r, _ in got_fake.calls if kind == "train_lm"}
    assert trained <= set(TRAINED)


def test_every_trained_scheme_is_listed(monkeypatch):
    """``TRAINED`` (the bits test's cases) is exactly what the drivers
    train."""
    fake = FakeTraining()
    fake.install(monkeypatch, tables)
    for driver in DRIVERS:
        getattr(tables, driver)(bench.LMSpec(steps=1), device="cpu")
    trained = {(n, r) for kind, n, r, _ in fake.calls if kind == "train_lm"}
    assert trained == set(TRAINED)


# ---------------------------------------------------------------------------
# Table 7, training stubbed
# ---------------------------------------------------------------------------

class FakeLSTMTraining:
    """Stands in, in one package, for the LSTM's ``init`` and ``loss_fn``,
    error feedback's ``init_state`` and ``apply_updates`` and
    ``make_compressor``: records each call, returns a loss that is a function
    of the batch's labels alone (their sum mod 997, over 100) and bits that
    depend on the scheme and rank alone."""

    def __init__(self, xp):
        self.xp = xp                      # jnp or torch
        self.calls = []

    def make_compressor(self, name, rank=None, **kw):
        assert not kw
        self.calls.append(("make_compressor", name, rank))
        return ("compressor", name, rank)

    def init(self, *args, **kw):
        cfg = next(a for a in args if isinstance(a, (jlstm.LSTMConfig,
                                                     lstm.LSTMConfig)))
        self.calls.append(("init", cfg.vocab, cfg.embed, cfg.hidden, cfg.layers,
                           cfg.init_scale))
        return {"decoder_b": self.xp.zeros((3,))}

    def loss_fn(self, params, batch, cfg):
        labels = batch["labels"]
        loss = (labels.sum() % 997) / 100.0 + 0.0 * params["decoder_b"].sum()
        if not isinstance(labels, jax.core.Tracer):
            self.calls.append(("loss_fn", tuple(labels.shape)))
        return loss, {"loss": loss}

    def init_state(self, comp, params, specs, *args, **kw):
        self.calls.append(("init_state", comp))
        return error_feedback.EFState(error={}, momentum={}, comp=None)

    def apply_updates(self, comp, params, grads, state, specs, *, lr, momentum,
                      **kw):
        self.calls.append(("apply_updates", comp, lr, momentum))
        _, name, rank = comp
        bits = 32 * (5000 + 13 * len(name)) * (rank or 1)
        return params, state, {"bits_per_worker": bits}

    def install(self, monkeypatch, mod, model, ef):
        monkeypatch.setattr(mod, "make_compressor", self.make_compressor)
        monkeypatch.setattr(model, "init", self.init)
        monkeypatch.setattr(model, "loss_fn", self.loss_fn)
        monkeypatch.setattr(ef, "init_state", self.init_state)
        monkeypatch.setattr(ef, "apply_updates", self.apply_updates)


def test_table7_calls_and_rows_equal_reference(monkeypatch):
    want_fake, got_fake = FakeLSTMTraining(jnp), FakeLSTMTraining(torch)
    want_fake.install(monkeypatch, jtables, jlstm, jef)
    got_fake.install(monkeypatch, tables, lstm, error_feedback)
    want = jtables.table7_lstm(5)
    got = tables.table7_lstm(5, device="cpu")
    assert _items(got) == _items(want)
    # the reference traces its loss once per run under jit; the port calls
    # it every step: compare the calls of each kind apart
    for kind in ("make_compressor", "init", "init_state", "apply_updates"):
        assert ([c for c in got_fake.calls if c[0] == kind]
                == [c for c in want_fake.calls if c[0] == kind]), kind
    assert [c for c in want_fake.calls if c[0] == "loss_fn"] == (
        [("loss_fn", (32, 48))] * 18)
    assert [c for c in got_fake.calls if c[0] == "loss_fn"] == (
        [("loss_fn", (16, 48))] * 5 + [("loss_fn", (32, 48))] * 6) * 3


# ---------------------------------------------------------------------------
# bits at the benchmark LM's shapes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_bits(name, rank):
    """The reference's ``bits_per_worker`` of one step at the benchmark LM's
    shapes: a Python int fixed while the step is traced."""
    comp = (jcomp.make_compressor(name) if rank is None
            else jcomp.make_compressor(name, rank=rank))
    cfg = jcommon._make_cfg(jcommon.LMSpec())
    specs = jmodel.mspecs(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(KEY, cfg, model_shards=1))
    state = comp.init(shapes, specs, KEY)
    bits = []

    def probe(g, s):
        out = comp.step(g, s, specs, key=KEY)
        bits.append(out.bits_per_worker)
        return out.agg

    jax.eval_shape(probe, shapes, state)
    return int(bits[0])


def _port_comp(name, rank):
    return make_compressor(name) if rank is None else make_compressor(name, rank=rank)


def _port_bits(name, rank):
    cfg = bench._make_cfg(bench.LMSpec())
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return bench.probe_bits(_port_comp(name, rank), params, model.mspecs(cfg))


@pytest.mark.parametrize("name,rank", TRAINED)
def test_bits_and_name_at_lm_shapes_equal_reference(name, rank):
    """The probe's bits and the compressor's name (a row's ``algorithm``)."""
    assert _port_bits(name, rank) == _reference_bits(name, rank)
    ref = (jcomp.make_compressor(name) if rank is None
           else jcomp.make_compressor(name, rank=rank))
    assert _port_comp(name, rank).name == ref.name


# ---------------------------------------------------------------------------
# adaptive_rank_profile, training stubbed
# ---------------------------------------------------------------------------

class FakeAdaptive:
    """Stands in for ``make_compressor`` and ``train_lm`` in one package's
    ``adaptive_rank_profile``: a fixed-rank run sends 1000·r floats a step;
    a controller is driven over the run on a one-leaf state of its rank,
    fed ``RESIDUALS``, and sends 1000·rank floats a step; a transform is
    applied to the compressor's fresh state at the LM's shapes and the
    payload counted at the resulting ranks.  ``eval_loss`` depends only on
    the call's position."""

    RESIDUALS = (0.9, 0.9, 0.95, 0.8, 0.1, 0.05, 0.2, 0.1)

    def __init__(self, leaf, fresh, payload):
        self.calls, self.devices = [], []
        self.leaf, self.fresh, self.payload = leaf, fresh, payload

    def make_compressor(self, name, rank=None, **kw):
        assert name == "powersgd" and not kw
        return ("compressor", name, rank)

    def train_lm(self, comp, spec, eval_batches=8, controller=None,
                 init_comp_transform=None, *, device="not given"):
        self.devices.append(device)
        result = {"eval_loss": 1.0 + len(self.calls) / 7.0 + 1e-7}
        if isinstance(comp, tuple):
            floats = 1000 * comp[2] * spec.steps
            self.calls.append(("fixed", comp[2]))
        elif controller is not None:
            state, residual, floats = self.leaf(controller.rank), None, 0
            for i in range(spec.steps):
                state, _ = controller.update(state, i, residual)
                floats += 1000 * controller.rank
                residual = self.RESIDUALS[i % len(self.RESIDUALS)]
            result.update(rank_history=list(controller.history),
                          final_rank=controller.rank)
            self.calls.append(("controller", tuple(controller.history)))
        else:
            per_step, ranks = self.payload(init_comp_transform(self.fresh(comp)))
            floats = per_step * spec.steps
            self.calls.append(("transform", ranks))
        result["compressed_floats_total"] = floats
        return result


def _adaptive_fakes(steps):
    jspec, spec = jcommon.LMSpec(steps=steps), bench.LMSpec(steps=steps)
    jcfg, cfg = jcommon._make_cfg(jspec), bench._make_cfg(spec)
    jparams = jax.eval_shape(lambda: jmodel.init(KEY, jcfg, 1))
    jspecs = jmodel.mspecs(jcfg)
    params, specs = model.init(cfg, None, device="meta"), model.mspecs(cfg)

    def jpayload(state):
        ranks = tuple(None if q is None else q.shape[-1]
                      for q in jax.tree_util.tree_leaves(
                          state, is_leaf=lambda x: x is None))
        return jcommon.payload_floats(jparams, jspecs, state)[0], ranks

    def payload(state):
        ranks = tuple(None if q is None else q.shape[-1] for q in tree.leaves(state))
        return bench.payload_floats(params, specs, state)[0], ranks

    want = FakeAdaptive(lambda r: {"w": jnp.zeros((16, r))},
                        lambda comp: comp.init(jparams, jspecs, KEY), jpayload)
    got = FakeAdaptive(lambda r: {"w": torch.zeros(16, r)},
                       lambda comp: comp.init(params, specs), payload)
    return (jspec, want), (spec, got)


@pytest.mark.parametrize("steps", [24, 150])
def test_adaptive_rank_profile_rows_equal_reference(steps, monkeypatch):
    """The seven rows (fixed ranks 1, 2, 4; both staircases; the residual
    schedule; the autotuned plan) equal the reference's, keys and order
    included, the plan's bucket ranks, wire and modeled ms from each
    package's own autotuner over its own parameter shapes."""
    (jspec, want_fake), (spec, got_fake) = _adaptive_fakes(steps)
    for mod, fake in ((jtables, want_fake), (tables, got_fake)):
        monkeypatch.setattr(mod, "make_compressor", fake.make_compressor)
        monkeypatch.setattr(mod, "train_lm", fake.train_lm)
    want = jtables.adaptive_rank_profile(jspec)
    got = tables.adaptive_rank_profile(spec, device="cpu")
    assert got_fake.calls == want_fake.calls
    assert _items(got) == _items(want)
    assert got_fake.devices == ["cpu"] * 7
    assert [r["schedule"] for r in got] == [
        "fixed_rank1", "fixed_rank2", "fixed_rank4", "staircase_up_1_2_4",
        "staircase_down_4_2_1", "residual_energy", "autotuned_budget50"]
    tuned = got[-1]
    assert tuned["wire_dtype"] == "bfloat16"
    # the reference's record of this row, at 150 steps
    assert tuned["bucket_ranks"] == ("512x128:r1|128x512:r2|256x128:r1|"
                                     "128x256:r1|128x128:r1")
    assert len({r for r in got_fake.calls[-1][1] if r is not None}) == 2


def test_run_writes_adaptive_rank_profile(tmp_path, monkeypatch):
    calls = []
    rows = [{"schedule": "fixed_rank1", "eval_loss": 2.0}]

    def fake(spec, *, device):
        calls.append((spec.steps, spec.workers, device.type))
        return rows

    monkeypatch.setattr(tables, "adaptive_rank_profile", fake)
    before = _records_digest()
    run.main(["--only", "adaptive_rank", "--quick", "--device", "cpu", "--out",
              str(tmp_path)])
    assert calls == [(40, 4, "cpu")]
    assert json.loads((tmp_path / "adaptive_rank_profile.json").read_text()) == rows
    assert _records_digest() == before


# ---------------------------------------------------------------------------
# Signum
# ---------------------------------------------------------------------------

SIGNUM_STEPS, SIGNUM_RTOL = 3, 1e-6


def _signum_rows(steps):
    """(port, reference) Signum rows from the reference's initial
    parameters; call with ``round`` undone in both modules."""
    jspec = jcommon.LMSpec(steps=steps)
    want = jtables._signum_row(jspec)
    params0 = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(jspec.seed),
                                jcommon._make_cfg(jspec), model_shards=1))
    got = tables._signum_row(bench.LMSpec(steps=steps), device="cpu",
                             params=bridge.to_torch(params0))
    return got, want


def test_signum_row_matches_reference(monkeypatch):
    # the rows round eval_loss to 4 decimals, far coarser than the gap
    for mod in (jtables, tables):
        monkeypatch.setattr(mod, "round", lambda x, ndigits=None: x,
                            raising=False)
    got, want = _signum_rows(SIGNUM_STEPS)
    assert list(got) == list(want)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=SIGNUM_RTOL)
    assert {k: v for k, v in got.items() if k != "eval_loss"} == {
        k: v for k, v in want.items() if k != "eval_loss"}


# ---------------------------------------------------------------------------
# Table 5 and Fig. 3 on a small tree
# ---------------------------------------------------------------------------

SHAPES = {"w1": (24, 16), "conv": (8, 4, 3, 3), "stack": (3, 12, 6),
          "bias": (7,), "scale": (5,)}


def _small_tree():
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}

    def specs(mod):
        return {"w1": mod.MatrixSpec("matrix", 0), "conv": mod.MatrixSpec("conv", 0),
                "stack": mod.MatrixSpec("matrix", 1), "bias": mod.NONE,
                "scale": mod.NONE}

    return ((jax.tree_util.tree_map(jnp.asarray, params), specs(jmz)),
            (bridge.to_torch(params), specs(mz)))


def test_fig3_rows_equal_reference():
    (jp, js), (p, s) = _small_tree()
    assert _items(tables.fig3_scaling(p, s, device="cpu")) == _items(
        jtables.fig3_scaling(jp, js))


def test_table5_modeled_columns_equal_reference():
    (jp, js), (p, s) = _small_tree()
    want = jtables.table5_time_breakdown(jp, js)
    got = tables.table5_time_breakdown(p, s, device="cpu")
    drop = lambda rows: [[(k, v) for k, v in r.items() if k != "coding_ms"]
                         for r in rows]
    assert drop(got) == drop(want)
    assert [list(r) for r in got] == [list(r) for r in want]
    for name in ("identity", "powersgd", "sign_norm"):
        mine = [r for r in got if r["algorithm"] == name]
        for r in mine:
            assert math.isfinite(r["coding_ms"]) and r["coding_ms"] > 0, r
        # one worker's coding time, from the 2-worker row (rounding: 5e-4 ms)
        one = mine[0]["coding_ms"] / (1 if mine[0]["allreduce"] else 2)
        for r in mine:
            scale = 1 if r["allreduce"] else r["workers"]
            assert abs(r["coding_ms"] - one * scale) <= 5e-4 * (1 + scale), r


# ---------------------------------------------------------------------------
# one driver end to end on the port
# ---------------------------------------------------------------------------

def test_table3_end_to_end_modeled_columns_equal_reference():
    rows = tables.table3_rank_sweep(bench.LMSpec(steps=2), device="cpu")
    want = [jtables._fmt({"compressor": name, "eval_loss": 0.0,
                          "bits_per_worker_per_step": _reference_bits(name, rank),
                          "allreduce": True}, rank)
            for name, rank in [("identity", None)] + [("powersgd", r)
                                                      for r in (1, 2, 4)]]
    keys = ("algorithm", "data_per_epoch_mb", "allreduce", "modeled_comm_ms_w16")
    assert [[r[k] for k in keys] for r in rows] == [[r[k] for k in keys]
                                                    for r in want]
    assert all(math.isfinite(r["eval_loss"]) for r in rows)


# ---------------------------------------------------------------------------
# bench/run.py
# ---------------------------------------------------------------------------

def test_run_writes_fig3_rows_to_out(tmp_path):
    before = _records_digest()
    run.main(["--only", "fig3", "--device", "cpu", "--out", str(tmp_path)])
    cfg = get_config("llama3-8b", reduced=True)
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = tables.fig3_scaling(params, model.mspecs(cfg), device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fig3_scaling.json"]
    assert json.loads((tmp_path / "fig3_scaling.json").read_text()) == want
    assert _records_digest() == before


@pytest.mark.parametrize("argv", [
    ["--only", "fig3", "--device", "cpu"],
    ["--only", "fig3", "--device", "cpu", "--out", str(RECORDS)],
    ["--only", "fig3", "--device", "cpu", "--out", str(RECORDS / "port")],
], ids=["no-out", "records", "under-records"])
def test_run_refuses_out(argv, capsys):
    before = _records_digest()
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code == 2
    assert "--out" in capsys.readouterr().err
    assert _records_digest() == before
    assert not (RECORDS / "port").exists()


PROFILES = {"resume_overhead": "resume_overhead", "comm_profile": "comm_profile",
            "overlap": "overlap_profile"}


@pytest.mark.parametrize("only,item", [("resume_overhead", "item 18"),
                                       ("comm_profile", "item 18"),
                                       ("overlap", "item 18")])
def test_run_unported_tables_raise(only, item, tmp_path, monkeypatch):
    """The profiles of ROADMAP queue A, ``item`` (ported since): ``--only``
    calls each with the reference's arguments (``resume_overhead`` the
    tables' LMSpec, checkpointing every 20 steps, 10 under ``--quick``;
    the others reduced Llama-3-8B's tree and specs) on ``--device`` and
    writes its rows; ``experiments/benchmarks/`` stays untouched."""
    name = PROFILES[only]
    calls = []
    rows = [{"profile": name, "row": 1}, {"profile": name, "row": 2}]

    def fake(*args, device, **kw):
        calls.append((args, kw, device.type))
        return rows

    monkeypatch.setattr(tables, name, fake)
    before = _records_digest()
    for quick in (False, True):
        run.main(["--only", only, "--device", "cpu", "--out", str(tmp_path)]
                 + (["--quick"] if quick else []))
        assert json.loads((tmp_path / f"{name}.json").read_text()) == rows, item
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{name}.json"]
    assert _records_digest() == before
    assert [c[2] for c in calls] == ["cpu", "cpu"]
    if name == "resume_overhead":
        assert [(a[0].steps, a[0].workers, a[0].batch_per_worker, kw)
                for a, kw, _ in calls] == [(150, 4, 4, {"ckpt_every": 20}),
                                           (40, 4, 4, {"ckpt_every": 10})]
        return
    cfg = get_config("llama3-8b", reduced=True)
    want = model.init(cfg, None, device="meta")
    for (params, specs), kw, _ in calls:
        assert not kw
        assert specs == model.mspecs(cfg)
        assert [(path, tuple(x.shape)) for path, x in tree.items(params)] == [
            (path, tuple(x.shape)) for path, x in tree.items(want)]


@pytest.mark.parametrize("quick,steps", [(True, 40), (False, 120)])
def test_run_trains_table7_at_its_steps(quick, steps, tmp_path, monkeypatch):
    calls = []
    rows = [{"algorithm": "identity", "eval_ppl": 1.5, "data_per_epoch_mb": 2.0}]

    def fake(spec_steps, *, device):
        calls.append((spec_steps, device.type))
        return rows

    monkeypatch.setattr(tables, "table7_lstm", fake)
    run.main(["--only", "table7", "--device", "cpu", "--out", str(tmp_path)]
             + (["--quick"] if quick else []))
    assert calls == [(steps, "cpu")]
    assert json.loads((tmp_path / "table7_lstm.json").read_text()) == rows


DEFAULT_DEVICE_CALLS = {
    **{d: lambda fn: fn(bench.LMSpec(steps=1)) for d in DRIVERS},
    "_signum_row": lambda fn: fn(bench.LMSpec(steps=1)),
    "table7_lstm": lambda fn: fn(1),
    "adaptive_rank_profile": lambda fn: fn(bench.LMSpec(steps=1)),
    **{d: lambda fn: fn(_small_tree()[1][0], _small_tree()[1][1])
       for d in ("table5_time_breakdown", "fig3_scaling", "comm_profile",
                 "zoo_transport_profile", "sync_mode_profile", "overlap_profile")},
    "resume_overhead": lambda fn: fn(bench.LMSpec(steps=1)),
    "_wire_loss_run": lambda fn: fn("int4", 4, 1),
    "_stale_loss_run": lambda fn: fn("one_step", 4, 1),
}


@pytest.mark.parametrize("driver", sorted(DEFAULT_DEVICE_CALLS))
def test_drivers_default_to_the_card(driver):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[driver](getattr(tables, driver))


def test_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--only", "fig3", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


if __name__ == "__main__":
    # the Signum gaps quoted above, and the bits of every trained scheme
    for mod in (jtables, tables):
        mod.round = lambda x, ndigits=None: x
    for steps in (SIGNUM_STEPS, 10):
        got, want = _signum_rows(steps)
        print(f"signum, {steps} steps: eval_loss {got['eval_loss']!r} against "
              f"{want['eval_loss']!r}, relative gap "
              f"{abs(got['eval_loss'] - want['eval_loss']) / want['eval_loss']:.2e}")
    for name, rank in TRAINED:
        print(f"{name}, rank {rank}: bits_per_worker_per_step "
              f"{_port_bits(name, rank)} (reference {_reference_bits(name, rank)})")
