"""Tensor parallelism: the (data, model) grid of
``repro_torch.launch.train.make_train_step(..., mesh=...)`` on 4 gloo
processes, held per (data, model) coordinate against the JAX package's
``shard_map`` step on a (2, 2) mesh of 4 host devices.

The reference runs in two processes of its own, ``python
tests/test_torch_tp.py --reference <dir> a|b`` (XLA fixes the device
count at its first use), beside the port's 4 ranks; one module fixture
starts them all before the first test.  The reference's coordinates are read off ``mesh.devices``.

* (1) Partition records: ``train_state_partition`` against the reference's
  on reduced and full-width Llama-3-8B, for PowerSGD, Top-K and identity,
  synchronous and one-step; ``partition_mismatches`` on the sound trees and
  on one broken tree of each kind.  Spec logic, in this process.
* (2) Per-rank gradients of ``loss_fn`` against the reference's
  ``shard_map(jax.grad(loss_fn))``, with ``tp_grad_sync`` on and off (off
  gives the reference's per-rank partial gradients), within 1e-5 absolute
  (gloo's sums against XLA's fused reductions).
* (3) 3 ``make_train_step`` steps of reduced Llama-3-8B on (2, 2): PowerSGD
  bucketed and per leaf, Top-K on the int4 wire, PowerSGD under
  ``sync_mode="broadcast", track_drift=True`` (every drift exactly 0.0),
  and (4) PowerSGD under ``staleness="one_step"``.  Parameters within 2e-6,
  momentum, error buffers, Q factors (model-LOCAL ones per model rank) and
  the in-flight aggregate within 1e-5, losses within rtol 1e-5 (the
  tolerances of ``tests/test_torch_dist.py``), the data-axis records of a
  step equal to the reference's trace, and the model-axis calls of a step
  equal to the count the model code predicts.
* (2b) ``tp_local_kv``: the kv heads split over the model axis,
  gradients as in (2), and no model-axis gather in the forward and
  backward pass (4 without it).
* (5) Padded heads and vocabulary at M = 2: ``num_heads=3`` (one kv head;
  three query heads on two kv heads is no GQA layout, and the reference's
  out-of-range ``take`` gives NaN) and ``vocab_size=1023``: gradients as
  in (2), the padded head's and the padded vocabulary entry's gradients
  exactly 0.
* (6) Port only: the gradient on a model axis of 2, gathered to global
  shapes, equals the whole model's within 2e-6 relative, ‖x − y‖ / ‖y‖
  per leaf: the sharded products sum in another order, and the measured
  gap, 1.1–1.3e-6 on every leaf, is float32's noise for this model.

* (7) Checkpoints of the grid: after the bucketed and one-step runs each
  package writes its (2, 2) envelope (the port through
  ``canonicalize_mesh``, the reference through its ``canonicalize_mesh``
  + ``save_train_state``): the same leaf paths, dtypes and shapes, the
  values within the step tolerances, each model-LOCAL factor stacked with
  distinct entries.  The reference restores the port's envelope
  (``restore_train_state`` + ``replicate_mesh``, placed as its step
  places state) and every port rank restores it as the CLI does: bit for
  bit at every coordinate.  The checkpoint's gathers count in neither
  ``dist.CALLS`` nor ``dist.MODEL_CALLS``, and only the writer, rank 0,
  gets the canonical tree back.
* (8) A growth of the bucketed run's factors 2 → 4: fed the reference's
  columns at global shape, against the reference's ``transition_state``
  of its global sharded factors; and, port only, the joined local growths
  against the growth of the joined factors, bit for bit.

Feeding draws through ``Compressor.draw`` is not needed for the steps:
PowerSGD's warm start and Top-K draw nothing.  ``python tests/test_torch_tp.py``
prints the largest gaps behind the tolerances.
"""

import dataclasses
import datetime
import functools
import os
import pickle
import queue
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import bridge, tree
from repro_torch.checkpoint import train_state as ts
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist, engine, powersgd
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.sharding import gather_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.timeout(180)

D, M = 2, 2
W = D * M
BATCH, SEQ, STEPS = 8, 32, 3
PATHS = ("bucketed", "per_leaf", "top_k", "sync", "stale")
GRAD_CASES = ("sync_on", "sync_off", "padded", "local_kv")
# the reference's work in two processes at once, about even: (paths, cases)
REFERENCE_PARTS = {"a": (PATHS[:3], ()), "b": (PATHS[3:], GRAD_CASES)}
RENDEZVOUS_S = 60
RESULTS_S = 170
LOSS_RTOL, PARAM_ATOL, STATE_ATOL = 1e-5, 2e-6, 1e-5
GRAD_ATOL = 1e-5
# (7) the paths whose state after STEPS steps each package writes as a (2, 2)
# envelope, and the rank the bucketed path's factors then grow to
CKPT_PATHS = ("bucketed", "stale")
GROW_RANK, GROW_SEED = 4, 41
# Top-K/int4 under the rule chip_smoke.py holds it to (its flip rule): float32
# rounding between the packages can move a coordinate across the top-k
# boundary or an int4 code across a rounding boundary (ROADMAP C3), which
# moves one element of the update by a code step, far more than rounding.
# From the JAX package's own draw of the initial state, one model rank's
# parameters came 1.4e-3 apart after 3 steps.  So all but TOPK_FLIP_SHARE of
# the parameters within PARAM_ATOL (momentum and error buffers within
# STATE_ATOL), none beyond TOPK_FLIP_ATOL (an error-buffer element beyond the
# buffer's largest magnitude: a flipped selection moves a whole element).
TOPK_FLIP_SHARE, TOPK_FLIP_ATOL = 1e-4, 1e-2
# (6): float32 noise between two summation orders of the same model, not a
# model difference: the gathered gradient sits 1.1-1.3e-6 from the whole
# one by ‖x − y‖ / ‖y‖, every leaf alike (python tests/test_torch_tp.py)
GATHER_RTOL = 2e-6


def _padded_cfg(cfg):
    return dataclasses.replace(cfg, num_heads=3, num_kv_heads=1,
                               vocab_size=1023)


def _case_cfg(cfg, case):
    """The model of a gradient case: the padded one, the one that keeps its
    kv heads local (``tp_local_kv``: 2 kv heads split over 2 model ranks,
    no K/V gather), or ``cfg``."""
    if case == "padded":
        return _padded_cfg(cfg)
    if case == "local_kv":
        return dataclasses.replace(cfg, tp_local_kv=True)
    return cfg


def _cfg(case="sync_on"):
    return _case_cfg(llama3_8b.reduced_config(), case)


def _hyper_kw(path):
    kw = {"q_chunk": 16, "warmup_steps": 2}
    if path == "per_leaf":
        kw["bucketing"] = "off"
    if path == "sync":
        kw.update(sync_mode="broadcast", track_drift=True)
    if path == "stale":
        kw["staleness"] = "one_step"
    return kw


def _batches(vocab, steps, seed=0):
    data = MarkovLM(vocab=vocab, seed=seed, order=1)
    out = []
    for i in range(steps):
        toks = data.sample(BATCH, SEQ, step=i)
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


def _row(b, d):
    """Data row ``d``'s shard of a global batch (the reference's
    ``P("data", None)``)."""
    return {k: v.reshape((D, -1) + v.shape[1:])[d] for k, v in b.items()}


def _records(stats):
    return (list(stats.kinds), list(stats.sizes), list(stats.itemsizes),
            list(stats.fanouts), list(stats.overheads),
            stats.bytes_per_collective())


def predicted_model_calls(cfg, *, drift=False):
    """Model-axis calls of one training step with ``tp_grad_sync`` on, as
    the model code issues them, forward and backward.  Per layer: the
    attention's and the MLP's *g* (an ``all_reduce`` backward each), the
    K and V gathers (an ``all_gather`` forward and an ``all_reduce``
    backward each), the *f* after ``wo`` and after ``w_down`` (an
    ``all_reduce`` forward each).  Once: the embedding's *f*, the head's
    *g*, the cross-entropy's max and two sums (``all_reduce`` each), and the
    loss metric's mean; the four drift probes' max under ``track_drift``."""
    layers = cfg.num_layers
    all_reduce = 6 * layers + 5 + 1 + (4 if drift else 0)
    return {"all_reduce": all_reduce, "all_gather": 2 * layers}


# ---------------------------------------------------------------------------
# the reference, in a process of its own with 4 host devices
# ---------------------------------------------------------------------------

def _reference_main(directory, part):
    """The reference's share ``part`` of :data:`REFERENCE_PARTS`, written to
    ``<directory>/reference_<part>.pkl``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro import checkpoint as jckpt
    from repro.configs import llama3_8b as jllama
    from repro.core import compressors as jcomp
    from repro.core import dist as jdist
    from repro.core import powersgd as jpowersgd
    from repro.core.error_feedback import EFState as JEF
    from repro.launch import train as jtrain
    from repro.models import model as jmodel

    with open(os.path.join(directory, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = jax.make_mesh((D, M), ("data", "model"))
    coord = {}
    for (d, m), dev in np.ndenumerate(mesh.devices):
        coord[dev] = (int(d), int(m))

    def local(x, lead_data=False):
        """Every device's shard of a global array, stacked on a leading
        ``(D, M)`` grid of coordinates."""
        grid = [[None] * M for _ in range(D)]
        for s in x.addressable_shards:
            d, m = coord[s.device]
            a = np.asarray(s.data)
            grid[d][m] = a[0] if lead_data else a
        return np.stack([np.stack(row) for row in grid])

    out = {"coords": {str(k): v for k, v in coord.items()}, "steps": {},
           "grads": {}, "restored": {}}
    placed = {}     # path: (params, ef, partition, shardings) after the steps
    cfg = jllama.reduced_config()
    paths, cases = REFERENCE_PARTS[part]
    for path in paths:
        stats = jdist.CollectiveStats()
        jtrain.MeshCtx = functools.partial(jdist.MeshCtx, stats=stats)
        hyper = jtrain.TrainHyper(remat=False, **_hyper_kw(path))
        comp = (jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
                if path == "top_k" else None)
        step, abstract, _ = jtrain.make_train_step(cfg, mesh, hyper,
                                                   compressor=comp)
        with jax.set_mesh(mesh):
            # as the reference's CLI makes its state: on the mesh
            start = jax.tree_util.tree_map(jnp.array, inputs["start"])
            params = start["params"]
            zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
            ef = JEF(error=jax.tree_util.tree_map(
                         lambda p: jnp.zeros((D,) + p.shape, p.dtype), params),
                     momentum=zeros(params),
                     comp=None if path == "top_k" else start["comp"],
                     step=jnp.zeros((), jnp.int32),
                     inflight=zeros(params) if path == "stale" else None)
            # placed as the step returns them, so that it compiles once
            place = lambda t, sds: jax.device_put(t, jax.tree_util.tree_map(
                lambda x: x.sharding, sds))
            params, ef = (place(x, sds) for x, sds in zip((params, ef),
                                                          abstract()))
        losses, drifts = [], []
        for i, b in enumerate(inputs["batches"]):
            with jax.set_mesh(mesh):
                params, ef, m = step(params, ef, b, jax.random.key(i))
            losses.append(float(np.asarray(m["lm_loss"])))
            drifts.append({k: float(np.asarray(v)) for k, v in m.items()
                           if k.startswith("drift_")})
        out["steps"][path] = {
            "losses": losses, "drifts": drifts,
            "records": _records(stats), **_locals(local, params, ef)}
        if path in CKPT_PATHS:
            # (7): the envelope of the state after the steps
            parts = jtrain.train_state_partition(cfg, mesh, None, hyper.staleness)
            p_c, ef_c = jckpt.canonicalize_mesh(mesh, params, ef, parts)
            jckpt.save_train_state(
                os.path.join(directory, f"reference_{path}"), jckpt.TrainState(
                    params=p_c, ef=ef_c, key=jax.random.key(0),
                    data_step=jnp.asarray(STEPS, jnp.int32)),
                model_axis_size=M, mesh_shape={"data": D, "model": M})
            with jax.set_mesh(mesh):
                placed[path] = (params, ef, parts, abstract())
        if path == "bucketed":
            # (8): a growth of the global sharded factors, the columns drawn
            # from the key the port's controller is fed; outside the mesh
            # context, as its CLI's host loop transitions them
            grown = jpowersgd.transition_state(ef.comp, GROW_RANK,
                                               jax.random.key(GROW_SEED))
            grown = jax.tree_util.tree_map(
                lambda g, q: g if g.sharding == q.sharding
                else jax.device_put(g, q.sharding), grown, ef.comp)
            out["grown"] = jax.tree_util.tree_map(local, grown)
    jtrain.MeshCtx = jdist.MeshCtx

    for case in cases:
        gcfg = _case_cfg(cfg, case)
        ctx = jdist.MeshCtx(data_axes=("data",), model_axis="model",
                            tp_grad_sync=case != "sync_off")
        params = inputs["grad_start"][case]
        ps = jmodel.pspecs(gcfg)

        def grads(p, bb, gcfg=gcfg, ctx=ctx):
            g, m = jax.grad(lambda q: jmodel.loss_fn(
                q, bb, gcfg, ctx, q_chunk=16, remat=False), has_aux=True)(p)
            return (jax.tree_util.tree_map(lambda x: x[None, None], g),
                    m["lm_loss"][None, None])

        every = jax.tree_util.tree_map(lambda s: JP("data", "model"), ps,
                                       is_leaf=lambda x: isinstance(x, JP))
        fn = jax.jit(jax.shard_map(
            grads, mesh=mesh,
            in_specs=(ps, {"tokens": JP("data", None), "labels": JP("data", None)}),
            out_specs=(every, JP("data", "model")), check_vma=False))
        g, loss = fn(params, inputs["grad_batch"][case])
        g = jax.tree_util.tree_map(np.asarray, g)
        out["grads"][case] = {
            "loss": np.asarray(loss),
            "grads": {(d, m): jax.tree_util.tree_map(lambda x: x[d, m], g)
                      for d in range(D) for m in range(M)}}
    for path, (params, ef, parts, sds) in placed.items():
        # (7): the port's envelope of the same path, restored as the
        # reference's CLI restores one and placed as its step places state
        port_dir = os.path.join(directory, f"port_{path}")
        deadline = time.monotonic() + RESULTS_S
        while jckpt.latest_step(port_dir) != STEPS:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no port envelope in {port_dir}")
            time.sleep(0.2)
        template = jckpt.TrainState(
            params=params, ef=jckpt.stack_model_template(ef, parts, M),
            key=jax.random.key(0), data_step=jnp.zeros((), jnp.int32))
        state, _ = jckpt.restore_train_state(port_dir, template,
                                             model_axis_size=M)
        with jax.set_mesh(mesh):
            rp, ref_ef = jckpt.replicate_mesh(mesh, state.params, state.ef, parts)
        rp, ref_ef = (jax.device_put(x, jax.tree_util.tree_map(
            lambda a: a.sharding, y)) for x, y in zip((rp, ref_ef), sds))
        out["restored"][path] = _locals(local, rp, ref_ef)
    with open(os.path.join(directory, f"reference_{part}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _locals(local, params, ef):
    """Every coordinate's arrays of the reference's state (``local`` reads a
    global array's shards off the devices)."""
    import jax

    tm = lambda t, **kw: None if t is None else jax.tree_util.tree_map(
        lambda x: local(x, **kw), t)
    return {"params": tm(params), "momentum": tm(ef.momentum),
            "error": tm(ef.error, lead_data=True), "q": tm(ef.comp),
            "inflight": tm(ef.inflight)}


def _reference_inputs():
    """The initial global state both packages start from, drawn by the
    port (``model.init`` at ``model_shards=M``, then PowerSGD's factors;
    the reference's own draw compiles for seconds), and the batches, as
    numpy."""
    def start(cfg):
        gen = torch.Generator().manual_seed(0)
        params = model.init(cfg, gen, "cpu", model_shards=M)
        comp = compressors.PowerSGDCompressor(rank=2).init(
            params, model.mspecs(cfg), gen)
        return bridge.to_numpy(params), bridge.to_numpy(comp)

    cfg = _cfg()
    params, comp = start(cfg)
    padded = start(_cfg("padded"))[0]
    return {"start": {"params": params, "comp": comp},
            "grow_cols": _grow_columns(comp),
            "batches": _batches(cfg.vocab_size, STEPS),
            "grad_start": {"sync_on": params, "sync_off": params,
                           "padded": padded, "local_kv": params},
            "grad_batch": {"sync_on": _batches(cfg.vocab_size, 1, 3)[0],
                           "sync_off": _batches(cfg.vocab_size, 1, 3)[0],
                           "padded": _batches(1023, 1, 4)[0],
                           "local_kv": _batches(cfg.vocab_size, 1, 3)[0]}}


def _grow_columns(comp):
    """The reference's fresh columns of a growth of the global factors
    ``comp`` to GROW_RANK under ``jax.random.key(GROW_SEED)``, keyed by
    leaf path, at global shape: ``normal(leaf_key(key, path), (m, extra))``
    as its ``transition_state`` draws them."""
    import jax
    import jax.numpy as jnp
    from repro.core import engine as jengine

    key = jax.random.key(GROW_SEED)
    return {path: np.asarray(jax.random.normal(
        jengine.leaf_key(key, tuple(jax.tree_util.DictKey(k) for k in path)),
        (q.shape[-2], GROW_RANK - q.shape[-1]), dtype=jnp.float32))
        for path, q in tree.items(comp) if q is not None}


class _FedController(powersgd.RankController):
    """The port's controller fed the reference's columns (``cols``, keyed by
    leaf path, at the global shape a model-sharded factor asks for)."""

    def __init__(self, schedule, cols):
        super().__init__(schedule)
        self.cols = cols

    def draw(self, switch, path, shape):
        cols = self.cols[tuple(path)]
        assert cols.shape == tuple(shape), (path, cols.shape, shape)
        return torch.from_numpy(cols.copy())


# ---------------------------------------------------------------------------
# what each port rank runs
# ---------------------------------------------------------------------------

def _rank_ckpt(mesh, cfg, staleness, params, ef, directory):
    """(7): the state after the steps through ``canonicalize_mesh`` (the
    step's call counts read around it), written by rank 0, then restored on
    every rank as the CLI restores it: ``global_template`` →
    ``stack_model_template`` → ``restore_train_state`` →
    ``replicate_mesh``."""
    comp = compressors.PowerSGDCompressor(rank=2)
    parts = train.train_state_partition(cfg, mesh, comp, staleness)
    calls = dict(dist.CALLS), dict(dist.MODEL_CALLS)
    p_c, ef_c = ts.canonicalize_mesh(mesh, params, ef, parts)
    moved = (dict(dist.CALLS), dict(dist.MODEL_CALLS)) != calls
    if mesh.rank == 0:
        ts.save_train_state(directory, ts.TrainState(params=p_c, ef=ef_c,
                                                     data_step=STEPS),
                            model_axis_size=M, mesh_shape={"data": D, "model": M})
    tdist.barrier()
    p_t, ef_t = train.global_template(cfg, mesh, comp, staleness)
    state, _ = ts.restore_train_state(
        directory, ts.TrainState(params=p_t, ef=ts.stack_model_template(
            ef_t, parts, M)), model_axis_size=M)
    p_r, ef_r = ts.replicate_mesh(mesh, state.params, state.ef, parts,
                                  device="cpu")
    np_ = lambda t: None if t is None else bridge.to_numpy(t)
    return {"ckpt_calls_moved": moved,
            "holds_canonical": (p_c is not None, ef_c is not None),
            "restored": {
        "params": np_(p_r), "momentum": np_(ef_r.momentum),
        "error": np_(ef_r.error), "q": np_(ef_r.comp),
        "inflight": np_(ef_r.inflight)}}


def _rank_growth(mesh, cfg, comp_state, cols):
    """(8): the local factors grown 2 → GROW_RANK by a controller given the
    partition and the model coordinate: fed the reference's columns, and
    drawing its own."""
    parts = train.train_state_partition(cfg, mesh).comp
    schedule = f"2@0,{GROW_RANK}@1"
    out = {}
    for name, ctl in (("grown_fed", _FedController(schedule, cols)),
                      ("grown_own", powersgd.RankController(schedule))):
        grown, changed = ctl.update(comp_state, 1, partition=parts,
                                    model_coord=mesh.coords["model"])
        assert changed
        out[name] = bridge.to_numpy(grown)
    return out


def _rank_steps(mesh, path, inputs):
    cfg = _cfg()
    stats = dist.CollectiveStats()
    hyper = train.TrainHyper(**_hyper_kw(path))
    comp = (compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
            if path == "top_k" else None)
    step, init_state = train.make_train_step(cfg, hyper, comp, stats=stats,
                                             device="cpu", mesh=mesh)
    start = inputs["start"]
    params, ef = init_state(global_state=(
        bridge.to_torch(start["params"]),
        None if path == "top_k" else bridge.to_torch(start["comp"])))
    d = mesh.coord[0]
    losses, drifts = [], []
    for b in inputs["batches"]:
        stats.reset()
        dist.reset_model_calls()
        shard = {k: torch.from_numpy(v.copy()) for k, v in _row(b, d).items()}
        params, ef, m = step(params, ef, shard)
        losses.append(m["lm_loss"].item())
        drifts.append({k: v.item() for k, v in m.items() if k.startswith("drift_")})
    np_ = lambda t: None if t is None else bridge.to_numpy(t)
    out = {"losses": losses, "drifts": drifts, "records": _records(stats),
           "model_calls": dict(dist.MODEL_CALLS), "params": np_(params),
           "momentum": np_(ef.momentum), "error": np_(ef.error),
           "q": np_(ef.comp), "inflight": np_(ef.inflight)}
    if path in CKPT_PATHS:
        out.update(_rank_ckpt(mesh, cfg, hyper.staleness, params, ef,
                              os.path.join(inputs["dir"], f"port_{path}")))
    if path == "bucketed":
        out.update(_rank_growth(mesh, cfg, ef.comp, inputs["grow_cols"]))
    return out


def _grads(cfg, params, batch, ctx):
    b = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    g, m = train.grad_with_aux(model.loss_fn)(params, b, cfg, ctx, q_chunk=16)
    return bridge.to_numpy(g), m["lm_loss"].item()


def _rank_grads(mesh, inputs):
    out = {}
    for case in GRAD_CASES:
        cfg = _cfg(case)
        ctx = dist.MeshCtx(model_axis="model", model_group=mesh.model_group,
                           tp_grad_sync=case != "sync_off")
        params = bridge.to_torch_local(inputs["grad_start"][case],
                                       model.pspecs(cfg), mesh)
        dist.reset_model_calls()
        out[case] = _grads(cfg, params, _row(inputs["grad_batch"][case],
                                             mesh.coord[0]), ctx)
        out[case + " calls"] = dict(dist.MODEL_CALLS)
    return out


def _rank_main(rank, rdzv, inputs, results):
    torch.set_num_threads(1)
    try:
        tdist.init_process_group(
            "gloo", init_method=f"file://{rdzv}", world_size=W, rank=rank,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
        mesh = mesh_lib.make_test_mesh()
        out = {"coord": mesh.coord, "info": mesh_lib.mesh_info(mesh),
               "grads": _rank_grads(mesh, inputs)}
        for path in PATHS:
            out[path] = _rank_steps(mesh, path, inputs)
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: both runs side by side
# ---------------------------------------------------------------------------

def _start(tmp):
    """Launch the reference's processes and the port's ranks; returns what
    :func:`_finish` collects."""
    inputs = dict(_reference_inputs(), dir=tmp)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    refs = {part: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", tmp, part],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for part in REFERENCE_PARTS}
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(
        _rank_main, args=(os.path.join(tmp, "rdzv"), inputs, results),
        nprocs=W, join=False, start_method="spawn")
    return {"tmp": tmp, "inputs": inputs, "refs": refs, "procs": procs,
            "results": results, "deadline": time.monotonic() + RESULTS_S}


def _stop(state):
    for p in state["procs"].processes:
        if p.is_alive():
            p.terminate()
        p.join(timeout=10)
    for ref in state["refs"].values():
        if ref.poll() is None:
            ref.kill()
            ref.communicate()


def _finish(state):
    """Wait for both runs; {"inputs", "ranks", "reference"}."""
    deadline, ranks = state["deadline"], {}
    try:
        while len(ranks) < W:
            try:
                rank, out = state["results"].get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                pytest.fail(f"ranks {sorted(set(range(W)) - set(ranks))} "
                            f"sent no result within {RESULTS_S} s")
            if isinstance(out, str):
                pytest.fail(f"rank {rank} failed:\n{out}")
            ranks[rank] = out
        for p in state["procs"].processes:
            p.join(timeout=10)
            assert not p.is_alive() and p.exitcode == 0, (p.pid, p.exitcode)
        for ref in state["refs"].values():
            said, _ = ref.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert ref.returncode == 0, said
    finally:
        _stop(state)
    reference = {"steps": {}, "grads": {}, "restored": {}}
    for part in REFERENCE_PARTS:
        with open(os.path.join(state["tmp"], f"reference_{part}.pkl"), "rb") as f:
            got = pickle.load(f)
        reference["coords"] = got["coords"]
        for key in ("steps", "grads", "restored"):
            reference[key].update(got[key])
        if "grown" in got:
            reference["grown"] = got["grown"]
    return {"inputs": state["inputs"], "ranks": ranks, "reference": reference,
            "dir": state["tmp"]}


@pytest.fixture(autouse=True, scope="module")
def _launched():
    """Both runs start before the module's first test, so the tests that
    need neither (the partition records) run while they do."""
    if not (tdist.is_available() and tdist.is_gloo_available()):
        yield None
        return
    with tempfile.TemporaryDirectory() as tmp:
        state = _start(tmp)
        try:
            yield state
        finally:
            _stop(state)


@pytest.fixture(scope="module")
def run(_launched):
    if _launched is None:
        pytest.skip("torch.distributed with gloo is not available")
    return _finish(_launched)


def _by_coord(run):
    """{(d, m): rank's result}; the reference's coordinates come from its
    ``mesh.devices``, the port's from its mesh."""
    return {tuple(out["coord"]): out for out in run["ranks"].values()}


def _gap(a, b):
    worst = 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        if x is None and y is None:
            continue
        assert np.shape(x) == np.shape(y), (np.shape(x), np.shape(y))
        worst = max(worst, float(np.max(np.abs(np.asarray(x, np.float64) - y),
                                        initial=0.0)))
    return worst


def _flips(a, b, atol):
    """(elements beyond ``atol``, elements, largest gap) over two trees."""
    flips = n = 0
    worst = 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        d = np.abs(np.asarray(x, np.float64) - y)
        flips, n = flips + int((d > atol).sum()), n + d.size
        worst = max(worst, float(d.max(initial=0.0)))
    return flips, n, worst


def _rel(x, y):
    """‖x − y‖ / ‖y‖ (Frobenius)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-300))


def _at(t, c):
    return tree.map(lambda x: None if x is None else x[c], t)


# ---------------------------------------------------------------------------
# (1) partition records — spec logic, no devices
# ---------------------------------------------------------------------------

class _AxisNames:
    """What ``train_state_partition`` reads of a mesh in both packages."""

    axis_names = ("data", "model")
    shape = {"data": D, "model": M}


PARTITION_CASES = [(size, comp, stale) for size in ("reduced", "full")
                   for comp in ("powersgd", "top_k", "identity")
                   for stale in ("none", "one_step")]


def _partition_pair(size, comp_name, staleness):
    import jax
    from repro.configs import llama3_8b as jllama
    from repro.core import compressors as jcomp
    from repro.launch import train as jtrain

    jcfg = jllama.reduced_config() if size == "reduced" else jllama.config()
    cfg = llama3_8b.reduced_config() if size == "reduced" else llama3_8b.config()
    jparts = jtrain.train_state_partition(
        jcfg, _AxisNames(), jcomp.make_compressor(comp_name, rank=2), staleness)
    parts = train.train_state_partition(
        cfg, _AxisNames(), compressors.make_compressor(comp_name, rank=2),
        staleness)
    return jparts, parts, jcfg, cfg


def _jflat(jparts):
    import jax
    from repro.core.engine import StatePartition as JSP

    flat = jax.tree_util.tree_flatten_with_path(
        jparts, is_leaf=lambda x: isinstance(x, JSP))[0]
    return {jax.tree_util.keystr(p): (tuple(x.spec), x.model)
            for p, x in flat if isinstance(x, JSP)}


def _flat(parts):
    return {p: (tuple(x.spec), x.model)
            for p, x in engine._items_with_path(parts)
            if isinstance(x, engine.StatePartition)}


def _norm_spec(spec):
    """A spec's entries with one-axis tuples unwrapped (JAX may store
    ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("size,comp,staleness", PARTITION_CASES,
                         ids=[f"{s}-{c}-{t}" for s, c, t in PARTITION_CASES])
def test_partition_records_match_reference(size, comp, staleness):
    jparts, parts, _, _ = _partition_pair(size, comp, staleness)
    want = {p: (_norm_spec(s), r) for p, (s, r) in _jflat(jparts).items()}
    got = {p: (_norm_spec(s), r) for p, (s, r) in _flat(parts).items()}
    assert got == want
    if comp == "powersgd":
        rel = {p: r for p, (_, r) in got.items() if p.startswith(".comp")}
        assert rel[".comp['blocks']['slot0']['mixer']['wo']"] == engine.MODEL_LOCAL
        assert rel[".comp['blocks']['slot0']['mixer']['wq']"] == engine.MODEL_SHARDED
        assert rel[".comp['embed']"] == engine.MODEL_LOCAL


def _states(jcfg, cfg, staleness):
    """Global-shape states (the reference's layout: error buffers with a
    leading data dim) for the audit: ShapeDtypeStructs and meta tensors."""
    import jax
    import jax.numpy as jnp
    from repro.core import compressors as jcomp
    from repro.core.error_feedback import EFState as JEF
    from repro.models import model as jmodel

    jp = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg, M))
    jq = jax.eval_shape(lambda: jcomp.PowerSGDCompressor(rank=2).init(
        jp, jmodel.mspecs(jcfg), jax.random.key(1)))
    sds = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)
    jstate = JEF(error=jax.tree_util.tree_map(lambda p: sds((D,) + p.shape), jp),
                 momentum=jp, comp=jq, step=sds(()),
                 inflight=jp if staleness == "one_step" else None)
    p = model.init(cfg, None, "meta", model_shards=M)
    q = compressors.PowerSGDCompressor(rank=2).init(p, model.mspecs(cfg))
    meta = lambda s: torch.empty(s, device="meta")
    state = train.EFState(
        error=tree.map(lambda x: meta((D,) + tuple(x.shape)), p), momentum=p,
        comp=q, step=0, inflight=p if staleness == "one_step" else None)
    return jstate, state


def _break(parts, kind, P):
    """One broken copy of a partition tree (``P`` the package's spec)."""
    comp = dict(parts.comp)
    if kind == "unclassified":
        comp["embed"] = None
    elif kind == "spec-rank":
        comp["head"] = dataclasses.replace(comp["head"],
                                           spec=P(None, None, None, "model"))
    elif kind == "unknown-axis":
        comp["head"] = dataclasses.replace(comp["head"], spec=P("pod", "model"))
    elif kind == "model-mismatch":
        comp["embed"] = dataclasses.replace(comp["embed"], model="sharded")
    return dataclasses.replace(parts, comp=comp)


@pytest.mark.parametrize("kind", ["sound", "unclassified", "spec-rank",
                                  "unknown-axis", "model-mismatch"])
@pytest.mark.parametrize("staleness", ["none", "one_step"])
def test_partition_mismatches_match_reference(kind, staleness):
    from jax.sharding import PartitionSpec as JP
    from repro.core import engine as jengine

    from repro_torch.sharding import P

    jparts, parts, jcfg, cfg = _partition_pair("reduced", "powersgd", staleness)
    jstate, state = _states(jcfg, cfg, staleness)
    if kind != "sound":
        jparts, parts = _break(jparts, kind, JP), _break(parts, kind, P)
    axes = ("data", "model")
    want = [(p, k) for p, k, _ in jengine.partition_mismatches(
        jstate, jparts, mesh_axes=axes)]
    got = [(p, k) for p, k, _ in engine.partition_mismatches(
        state, parts, mesh_axes=axes)]
    assert got == want
    assert bool(got) == (kind != "sound")
    if kind != "sound":
        assert {k for _, k in got} == {kind}


def test_bucket_model_sharded_marks_local_and_sharded_buckets():
    """``MatrixPayloads.build(partition=)`` flags every bucket that holds a
    model-sharded or model-local factor, as the reference's does."""
    import jax
    from repro.core import compressors as jcomp
    from repro.core import engine as jengine
    from repro.models import model as jmodel

    jparts, parts, jcfg, cfg = _partition_pair("reduced", "powersgd", "none")
    jp = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg, M))
    jq = jax.eval_shape(lambda: jcomp.PowerSGDCompressor(rank=2).init(
        jp, jmodel.mspecs(jcfg), jax.random.key(1)))
    box = {}

    def build(p, q):   # traced, not run: the flags are found at trace time
        box["want"] = jengine.MatrixPayloads.build(
            p, q, jmodel.mspecs(jcfg), dtype=np.float32,
            partition=jparts.comp).bucket_model_sharded
        return 0
    jax.eval_shape(build, jp, jq)
    params = model.init(cfg, None, "meta", model_shards=M)
    q = compressors.PowerSGDCompressor(rank=2).init(params, model.mspecs(cfg))
    got = engine.MatrixPayloads.build(params, q, model.mspecs(cfg),
                                      partition=parts.comp).bucket_model_sharded
    assert got == box["want"] and any(got)
    assert engine.MatrixPayloads.build(
        params, q, model.mspecs(cfg)).bucket_model_sharded is None


# ---------------------------------------------------------------------------
# the grid and the gradients
# ---------------------------------------------------------------------------

def test_grid_layout(run):
    coords = {r: tuple(out["coord"]) for r, out in run["ranks"].items()}
    assert coords == {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}
    # the reference's mesh lays its devices out the same way
    assert sorted(run["reference"]["coords"].values()) == sorted(coords.values())
    assert run["ranks"][0]["info"] == {"data_parallel": D, "model_parallel": M,
                                       "chips": W, "axis_names": ("data", "model")}


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_reference(run, case):
    ref = run["reference"]["grads"][case]
    for c, out in _by_coord(run).items():
        grads, loss = out["grads"][case]
        np.testing.assert_allclose(loss, ref["loss"][c], rtol=LOSS_RTOL)
        assert _gap(grads, ref["grads"][c]) <= GRAD_ATOL, (c, case)


def test_local_kv_heads_need_no_gather(run):
    for out in run["ranks"].values():
        assert out["grads"]["local_kv calls"]["all_gather"] == 0
        assert out["grads"]["sync_on calls"]["all_gather"] == 2 * _cfg().num_layers


def test_legacy_switch_gives_partial_gradients(run):
    """``tp_grad_sync=False``: a replicated weight's gradient differs
    between the two model ranks of a data row (each holds its partial
    sum), where the synced gradient is the same on both."""
    by = _by_coord(run)
    for d in range(D):
        on = [by[(d, m)]["grads"]["sync_on"][0]["final_norm"] for m in range(M)]
        off = [by[(d, m)]["grads"]["sync_off"][0]["final_norm"] for m in range(M)]
        np.testing.assert_array_equal(on[0], on[1])
        assert not np.allclose(off[0], off[1])


def test_padded_heads_and_vocab_get_zero_gradient(run):
    cfg = _cfg("padded")
    hd = cfg.resolved_head_dim
    for (d, m), out in _by_coord(run).items():
        g = out["grads"]["padded"][0]
        mixer = g["blocks"]["slot0"]["mixer"]
        if m == M - 1:
            # global head 3 is local head 1 of the last model rank; global
            # vocabulary entry 1023 is its last local row / column
            assert not mixer["wq"][:, :, hd:].any()
            assert not mixer["wo"][:, hd:, :].any()
            assert not g["embed"][-1].any() and not g["head"][:, -1].any()
        assert mixer["wq"][:, :, :hd].any()


def test_gathered_gradient_equals_whole_model(run):
    """(6): the model ranks' gradients of one data row, gathered to global
    shapes, against the gradient of the whole model on that row."""
    cfg = _cfg()
    inputs = run["inputs"]
    params = bridge.to_torch(inputs["grad_start"]["sync_on"])
    by = _by_coord(run)
    for d in range(D):
        pieces = [bridge.to_torch(by[(d, m)]["grads"]["sync_on"][0])
                  for m in range(M)]
        gathered = bridge.to_numpy(gather_tree(pieces, model.pspecs(cfg)))
        whole, _ = _grads(cfg, params, _row(inputs["grad_batch"]["sync_on"], d),
                          dist.SINGLE)
        for x, y in zip(tree.leaves(gathered), tree.leaves(whole)):
            assert _rel(x, y) <= GATHER_RTOL


# ---------------------------------------------------------------------------
# (3), (4) the training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_steps_match_reference(run, path):
    ref = run["reference"]["steps"][path]
    for c, out in _by_coord(run).items():
        got = out[path]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
        if path == "top_k":
            for name, atol in (("params", PARAM_ATOL), ("momentum", STATE_ATOL),
                               ("error", STATE_ATOL)):
                want = _at(ref[name], c)
                # a selection flip moves a whole error-buffer element
                size = TOPK_FLIP_ATOL if name != "error" else max(
                    float(np.abs(x).max()) for x in tree.leaves(want))
                flips, n, worst = _flips(got[name], want, atol)
                assert flips <= TOPK_FLIP_SHARE * n and worst <= size, (
                    c, name, flips, worst)
            continue
        assert _gap(got["params"], _at(ref["params"], c)) <= PARAM_ATOL, c
        for name in ("momentum", "error", "q", "inflight"):
            if ref[name] is None:
                assert got[name] is None
                continue
            assert _gap(got[name], _at(ref[name], c)) <= STATE_ATOL, (c, name)


def test_model_local_factors_differ_between_model_ranks(run):
    """A row-parallel weight's Q is per model rank (model-LOCAL): the two
    model ranks of a data row hold different factors, each the
    reference's for its coordinate (held in test_steps_match_reference)."""
    by = _by_coord(run)
    q0 = by[(0, 0)]["bucketed"]["q"]["blocks"]["slot0"]["mixer"]["wo"]
    q1 = by[(0, 1)]["bucketed"]["q"]["blocks"]["slot0"]["mixer"]["wo"]
    assert q0.shape == q1.shape and not np.allclose(q0, q1)
    np.testing.assert_array_equal(
        q0, by[(1, 0)]["bucketed"]["q"]["blocks"]["slot0"]["mixer"]["wo"])


@pytest.mark.parametrize("path", PATHS)
def test_data_records_match_reference(run, path):
    ref = run["reference"]["steps"][path]["records"]
    for out in run["ranks"].values():
        assert tuple(out[path]["records"]) == tuple(ref)


@pytest.mark.parametrize("path", PATHS)
def test_model_calls_per_step(run, path):
    want = predicted_model_calls(_cfg(), drift=path == "sync")
    assert want == train.tp_calls_per_step(
        _cfg(), train.TrainHyper(**_hyper_kw(path)))
    assert want == {"all_reduce": 22 if path == "sync" else 18, "all_gather": 4}
    for out in run["ranks"].values():
        assert out[path]["model_calls"] == want


def test_broadcast_drift_is_exactly_zero(run):
    ref = run["reference"]["steps"]["sync"]["drifts"]
    for out in run["ranks"].values():
        drifts = out["sync"]["drifts"]
        assert len(drifts) == STEPS and set(drifts[0]) == {
            "drift_params", "drift_momentum", "drift_error", "drift_q"}
        for got, want in zip(drifts, ref):
            for k in ("drift_params", "drift_momentum", "drift_q"):
                assert got[k] == 0.0 and want[k] == 0.0


def test_replicas_of_a_model_rank_agree(run):
    """The two data replicas of each model coordinate end bit-identical
    (parameters, momentum, factors) on every path."""
    by = _by_coord(run)
    for path in PATHS:
        for m in range(M):
            a, b = by[(0, m)][path], by[(1, m)][path]
            for name in ("params", "momentum", "q"):
                for x, y in zip(tree.leaves(a[name] or {}), tree.leaves(b[name] or {})):
                    if x is not None:
                        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# (7) the (2, 2) envelopes, (8) a growth
# ---------------------------------------------------------------------------

def _envelope_leaves(directory):
    from repro_torch.checkpoint import decode_leaf, load_envelope

    env = load_envelope(directory, STEPS)
    np_ = lambda x: None if x is None else np.asarray(x)
    return env["meta"], {d["path"]: (d["dtype"] if d["kind"] == "array" else None,
                                     tuple(d.get("shape", ())), np_(decode_leaf(d)))
                         for d in env["leaves"]}


@pytest.mark.parametrize("path", CKPT_PATHS)
def test_envelope_matches_reference(run, path):
    """Each package's envelope of its state after the steps: the same leaf
    paths, dtypes and shapes and grid record; parameters within PARAM_ATOL,
    the rest of the float state within STATE_ATOL, the integer leaves
    equal; each model-LOCAL factor stacked with distinct entries."""
    meta, got = _envelope_leaves(os.path.join(run["dir"], f"port_{path}"))
    want_meta, want = _envelope_leaves(os.path.join(run["dir"], f"reference_{path}"))
    assert list(got) == list(want)
    assert {k: v[:2] for k, v in got.items()} == {k: v[:2] for k, v in want.items()}
    for key in ("model_axis_size", "mesh_shape", "workers"):
        assert meta[key] == want_meta[key]
    assert meta["model_axis_size"] == M
    local = 0
    for leaf, (dtype, shape, x) in got.items():
        y = want[leaf][2]
        if x is None:
            continue
        if dtype.startswith("<f"):
            atol = PARAM_ATOL if leaf.startswith("['params']") else STATE_ATOL
            assert _gap(x, y) <= atol, leaf
        else:
            np.testing.assert_array_equal(x, y, err_msg=leaf)
        if leaf in ("['ef'].comp['embed']",
                    "['ef'].comp['blocks']['slot0']['mixer']['wo']",
                    "['ef'].comp['blocks']['slot0']['ffn']['w_down']"):
            local += 1
            assert shape[0] == M and not np.allclose(x[0], x[1]), leaf
    assert local == 3


@pytest.mark.parametrize("path", CKPT_PATHS)
def test_restores_agree_across_packages(run, path):
    """The port's envelope restored by the reference
    (``restore_train_state`` + ``replicate_mesh``, placed as its step places
    state) and by each port rank (``stack_model_template`` →
    ``restore_train_state`` → ``replicate_mesh``): the same arrays at every
    coordinate, bit for bit, and the port's its pre-save local state."""
    ref = run["reference"]["restored"][path]
    for c, out in _by_coord(run).items():
        got = out[path]["restored"]
        for name in ("params", "momentum", "error", "q", "inflight"):
            if ref[name] is None:
                assert got[name] is None and out[path][name] is None
                continue
            for (leaf, x), y, z in zip(tree.items(got[name]),
                                       tree.leaves(_at(ref[name], c)),
                                       tree.leaves(out[path][name])):
                if x is None:
                    assert y is None and z is None
                    continue
                np.testing.assert_array_equal(x, y, err_msg=f"{c} {name} {leaf}")
                np.testing.assert_array_equal(x, z, err_msg=f"{c} {name} {leaf}")


def test_checkpoint_gathers_leave_the_step_counts(run):
    """``canonicalize_mesh``'s gathers count in neither ``dist.CALLS`` nor
    ``dist.MODEL_CALLS``: a save between steps leaves the counts that
    test_model_calls_per_step holds as they are."""
    for out in run["ranks"].values():
        for path in CKPT_PATHS:
            assert out[path]["ckpt_calls_moved"] is False


def test_only_the_writer_holds_the_canonical_tree(run):
    """``canonicalize_mesh`` gathers to rank 0 (coordinate (0, 0), the
    writer) and gives the other ranks ``(None, None)``: no other process
    builds the canonical tree."""
    for c, out in _by_coord(run).items():
        for path in CKPT_PATHS:
            want = c == (0, 0)
            assert out[path]["holds_canonical"] == (want, want), (c, path)


def test_growth_matches_reference(run):
    """(8): the local factors after 3 bucketed steps grown 2 → GROW_RANK by
    a controller fed the reference's columns at global shape, against the
    reference's ``transition_state`` of its global sharded factors: the new
    columns bit for bit, the kept ones within STATE_ATOL (the factors'
    tolerance)."""
    ref = run["reference"]["grown"]
    for c, out in _by_coord(run).items():
        for (leaf, x), y in zip(tree.items(out["bucketed"]["grown_fed"]),
                                tree.leaves(_at(ref, c))):
            if x is None:
                continue
            assert x.shape == y.shape, (c, leaf)
            np.testing.assert_array_equal(x[..., 2:], y[..., 2:], err_msg=str(leaf))
            assert _gap(x[..., :2], y[..., :2]) <= STATE_ATOL, (c, leaf)


def test_gathered_growth_is_the_global_transition(run):
    """(8), port only: the model ranks' own growths of a data row, joined
    (``assemble_mesh``), equal ``transition_factor`` of the joined factors
    with the controller's columns at global shape, bit for bit; a LOCAL
    factor's stack entries each grow by the same columns."""
    cfg = _cfg()
    parts = train.train_state_partition(cfg, _AxisNames())
    ctl = powersgd.RankController(f"2@0,{GROW_RANK}@1")
    draw = lambda path, shape: ctl.draw(0, path, shape)
    by = _by_coord(run)
    shape = {"data": 1, "model": M}
    for d in range(D):
        def joined(key):
            pieces = {}
            for m in range(M):
                out = by[(d, m)]["bucketed"]
                params = bridge.to_torch(out["params"])
                pieces[(0, m)] = (params, train.EFState(
                    error=bridge.to_torch(out["error"]),
                    momentum=bridge.to_torch(out["momentum"]),
                    comp=bridge.to_torch(out[key]), step=STEPS))
            return ts.assemble_mesh(pieces, parts, shape)[1].comp
        before, after = joined("q"), joined("grown_own")
        for (path, q), part, x in zip(tree.items(before), tree.leaves(parts.comp),
                                      tree.leaves(after)):
            if q is None:
                continue
            if part.model == engine.MODEL_LOCAL:
                want = torch.stack([powersgd.transition_factor(
                    p, GROW_RANK, draw, path) for p in q])
            else:
                want = powersgd.transition_factor(q, GROW_RANK, draw, path)
            assert torch.equal(x, want), (d, path)


# ---------------------------------------------------------------------------
# the entry point's rules
# ---------------------------------------------------------------------------

def test_group_and_mesh_are_exclusive():
    with pytest.raises(ValueError, match="a group or a mesh"):
        train.make_train_step(_cfg(), train.TrainHyper(), group=object(),
                              mesh=object(), device="cpu")


def test_cli_grid_rule():
    assert [mesh_lib.cli_shape(w) for w in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2)]
    with pytest.raises(ValueError):
        mesh_lib.cli_shape(5)


def _print_gaps(run):
    by = _by_coord(run)
    for case in GRAD_CASES:
        ref = run["reference"]["grads"][case]
        print(f"grads {case}: " + ", ".join(
            f"{c} {_gap(out['grads'][case][0], ref['grads'][c]):.3g}"
            for c, out in sorted(by.items())))
    cfg, inputs = _cfg(), run["inputs"]
    params = bridge.to_torch(inputs["grad_start"]["sync_on"])
    for d in range(D):
        pieces = [bridge.to_torch(by[(d, m)]["grads"]["sync_on"][0])
                  for m in range(M)]
        gathered = bridge.to_numpy(gather_tree(pieces, model.pspecs(cfg)))
        whole, _ = _grads(cfg, params, _row(inputs["grad_batch"]["sync_on"], d),
                          dist.SINGLE)
        gap = max(_rel(x, y) for x, y in zip(tree.leaves(gathered),
                                               tree.leaves(whole)))
        print(f"gathered against whole, data row {d}: relative gap {gap:.3g}")
    for path in PATHS:
        ref = run["reference"]["steps"][path]
        for c, out in sorted(by.items()):
            got = out[path]
            gaps = {n: _gap(got[n], _at(ref[n], c)) for n in
                    ("params", "momentum", "error", "q", "inflight")
                    if ref[n] is not None}
            loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
            print(f"{path} {c}: loss rel {loss:.3g}, " + ", ".join(
                f"{k} {v:.3g}" for k, v in gaps.items()))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--reference":
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            _print_gaps(_finish(_start(tmp)))
