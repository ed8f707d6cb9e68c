"""The paper's table drivers (``repro_torch.bench.tables``), their entry
point (``repro_torch.bench.run``) and the α-β helpers of
``repro_torch.bench.common`` against the JAX package's
``benchmarks/tables.py`` and ``benchmarks/common.py``.

* ``comm_time``, ``broadcast_time`` and ``bytes_per_epoch_mb`` equal the
  reference's exactly.
* Tables 1, 2, 3, 4, 6 and Appendix D with training stubbed in both
  packages by one fake: the same ``make_compressor``/``train_lm``/
  ``_signum_row`` calls in the same order, and rows equal, keys and order
  included.
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
* ``bench/run.py``: ``--out`` required and kept out of
  ``experiments/benchmarks/``; ``--only`` matches parts of names; the
  unported tables raise naming their ROADMAP item; every driver and the
  entry point default to the CUDA card and raise where there is none.
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
from repro.core import matrixize as jmz
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.bench import common as bench
from repro_torch.bench import run, tables
from repro_torch.configs.base import get_config
from repro_torch.core import matrixize as mz
from repro_torch.core.compressors import make_compressor
from repro_torch.models import model

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


@pytest.mark.parametrize("only,item", [("table7", "item 15"),
                                       ("comm_profile", "item 18"),
                                       ("overlap", "item 18")])
def test_run_unported_tables_raise(only, item, tmp_path):
    before = _records_digest()
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}\\)"):
        run.main(["--only", only, "--device", "cpu", "--out", str(tmp_path)])
    assert _records_digest() == before


DEFAULT_DEVICE_CALLS = {
    **{d: lambda fn: fn(bench.LMSpec(steps=1)) for d in DRIVERS},
    "_signum_row": lambda fn: fn(bench.LMSpec(steps=1)),
    **{d: lambda fn: fn(_small_tree()[1][0], _small_tree()[1][1])
       for d in ("table5_time_breakdown", "fig3_scaling")},
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
