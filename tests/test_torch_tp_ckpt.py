"""The canonical layout of a (data, model) grid, in one process:
``repro_torch.checkpoint.train_state``'s pure assembly
(``assemble_mesh``/``split_mesh``) and ``stack_model_template``, and the
model-axis rank transition of ``repro_torch.core.powersgd``, held against
the JAX package where it has a twin.  No process group: the collective
wrappers (``canonicalize_mesh``/``replicate_mesh``) run on 4 gloo ranks in
``tests/test_torch_tp.py`` and the CLI's in ``tests/test_torch_tp_cli.py``.

* (a) Every partition class on a small hand-built tree at M = 2 and M = 1:
  model-replicated leaves, leaves sharded on dims 0, 1 and 2, a Q factor
  sharded on its m dim and one on a batch dim, a replicated Q, a
  model-LOCAL Q, error buffers and the in-flight aggregate.  The round trip
  local → canonical → local (and back) is bit for bit, each piece is the
  slice ``shard_tree`` cuts, LOCAL factors are stacked per model rank (at
  M = 1 stored as they are), every re-sliced leaf owns its storage, and a
  data axis of 2 rescaled to 1 and 4 equals the reference's
  ``rescale_error_buffers`` (grow bit for bit, shrink within rtol 1e-6, as
  ``tests/test_torch_warmup.py`` holds it).
* ``stack_model_template`` on reduced Llama-3-8B's global state
  (``launch.train.global_template``) against the reference's
  ``stack_model_template`` of its ``init_state`` shapes on its own
  ``train_state_partition``: paths, shapes and dtypes, M = 2 and M = 1; and
  an envelope of the canonical tree restored into that meta template bit
  for bit.
* A growth of the local factors with ``partition`` and ``model_coord``,
  joined, equals the growth of the joined factors bit for bit (columns of
  a model-sharded m dim drawn at global shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint import train_state as ts
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, engine, powersgd
from repro_torch.core.engine import (MODEL_LOCAL, MODEL_REPLICATED,
                                     MODEL_SHARDED, StatePartition)
from repro_torch.core.error_feedback import EFState
from repro_torch.launch import train
from repro_torch.sharding import P, shard, shard_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


R = 3
# name: (global parameter shape, its spec, Q factor shape (None: not
# compressed), Q's spec, Q's class)
TOY = {
    "rep": ((4, 6), P(None, None), (6, R), P(None, None), MODEL_REPLICATED),
    "row": ((8, 6), P("model", None), (6, R), P(None, None), MODEL_LOCAL),
    "col": ((2, 6, 8), P(None, None, "model"), (2, 8, R), P(None, "model", None),
            MODEL_SHARDED),
    "bat": ((4, 6, 3), P("model", None, None), (4, 3, R), P("model", None, None),
            MODEL_SHARDED),
    "vec": ((6,), P(None), None, None, None),
}


def _dims(spec):
    model = MODEL_SHARDED if "model" in tuple(spec) else MODEL_REPLICATED
    return StatePartition(spec=spec, model=model)


def _toy_partition():
    params = {k: _dims(v[1]) for k, v in TOY.items()}
    return EFState(
        error={k: StatePartition(spec=P(("data",), *v[1]), model=params[k].model)
               for k, v in TOY.items()},
        momentum=params,
        comp={k: None if v[2] is None else StatePartition(spec=v[3], model=v[4])
              for k, v in TOY.items()},
        step=StatePartition(spec=P(), model=MODEL_REPLICATED), inflight=params)


def _toy_canonical(d_size, m_size, seed=0):
    """A canonical tree of the toy state (LOCAL factors stacked at M > 1)."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda shape: torch.randn(shape, generator=g)
    stack = (m_size,) if m_size > 1 else ()
    params = {k: rand(v[0]) for k, v in TOY.items()}
    return params, EFState(
        error={k: rand((d_size,) + v[0]) for k, v in TOY.items()},
        momentum={k: rand(v[0]) for k, v in TOY.items()},
        comp={k: None if v[2] is None else
              rand((stack if v[4] == MODEL_LOCAL else ()) + v[2])
              for k, v in TOY.items()},
        step=7, inflight={k: rand(v[0]) for k, v in TOY.items()})


def _equal(a, b):
    """Two (params, ef) pairs bit for bit (``None`` leaves alike)."""
    (pa, ea), (pb, eb) = a, b
    assert ea.step == eb.step
    for name in ("error", "momentum", "comp", "inflight"):
        for (path, x), y in zip(tree.items(getattr(ea, name)),
                                tree.leaves(getattr(eb, name))):
            assert (x is None) == (y is None), (name, path)
            if x is not None:
                assert x.shape == y.shape and torch.equal(x, y), (name, path)
    for (path, x), y in zip(tree.items(pa), tree.leaves(pb)):
        assert torch.equal(x, y), path


def _leaves(state):
    params, ef = state
    return [x for t in (params, ef.error, ef.momentum, ef.comp, ef.inflight)
            for x in tree.leaves(t) if x is not None]


def _split_all(canonical, shape):
    params, ef = canonical
    return {(d, m): ts.split_mesh(params, ef, _toy_partition(), (d, m), shape)
            for d in range(shape["data"]) for m in range(shape["model"])}


@pytest.mark.parametrize("m_size", [2, 1])
def test_round_trip_is_bit_for_bit(m_size):
    shape = {"data": 2, "model": m_size}
    canonical = _toy_canonical(2, m_size)
    pieces = _split_all(canonical, shape)
    _equal(ts.assemble_mesh(pieces, _toy_partition(), shape), canonical)
    # and the other way: the pieces, joined and cut again, are themselves
    again = _split_all(ts.assemble_mesh(pieces, _toy_partition(), shape), shape)
    for c, (p, ef) in pieces.items():
        _equal(again[c], (p, ef))


@pytest.mark.parametrize("m_size", [2, 1])
def test_pieces_are_the_shards_and_local_factors_stack(m_size):
    shape = {"data": 2, "model": m_size}
    params, ef = canonical = _toy_canonical(2, m_size)
    specs = {k: v[1] for k, v in TOY.items()}
    qspecs = {k: v[3] for k, v in TOY.items()}
    for (d, m), (p, e) in _split_all(canonical, shape).items():
        where = {"model": (m, m_size)}
        _equal((p, EFState(error=e.error, momentum=e.momentum, comp=e.comp,
                           step=7, inflight=e.inflight)),
               (shard_tree(params, specs, where), EFState(
                   error=shard_tree({k: x[d] for k, x in ef.error.items()},
                                    specs, where),
                   momentum=shard_tree(ef.momentum, specs, where),
                   comp={k: None if x is None else
                         x[m] if m_size > 1 and TOY[k][4] == MODEL_LOCAL
                         else shard(x, qspecs[k], where)
                         for k, x in ef.comp.items()},
                   step=7, inflight=shard_tree(ef.inflight, specs, where))))
        assert e.comp["row"].shape == (6, R)
    assert ef.comp["row"].shape == ((m_size,) if m_size > 1 else ()) + (6, R)


@pytest.mark.parametrize("m_size", [2, 1])
def test_split_leaves_own_their_storage(m_size):
    shape = {"data": 2, "model": m_size}
    canonical = _toy_canonical(2, m_size)
    held = {x.untyped_storage().data_ptr() for x in _leaves(canonical)}
    for piece in _split_all(canonical, shape).values():
        for x in _leaves(piece):
            assert x.is_contiguous()
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
            assert x.untyped_storage().data_ptr() not in held


@pytest.mark.parametrize("d_new", [1, 4])
def test_data_axis_rescale_matches_reference(d_new):
    from repro.core import error_feedback as jef

    params, ef = _toy_canonical(2, 2)
    shape = {"data": d_new, "model": 2}
    want = jef.rescale_error_buffers(
        {k: jnp.asarray(x.numpy()) for k, x in ef.error.items()}, d_new)
    specs = {k: v[1] for k, v in TOY.items()}
    for (d, m), (_, e) in _split_all((params, ef), shape).items():
        ref = shard_tree({k: torch.from_numpy(np.array(x[d])) for k, x in want.items()},
                         specs, {"model": (m, 2)})
        for k, x in e.error.items():
            if d_new > 2:        # grow: each buffer repeated, bit for bit
                np.testing.assert_array_equal(x.numpy(), ref[k].numpy())
            else:                # shrink: the mean of the absorbed buffers
                np.testing.assert_allclose(x.numpy(), ref[k].numpy(), rtol=1e-6,
                                           atol=0)


class _Grid:
    """What ``train_state_partition`` and ``global_template`` read of a mesh
    in both packages."""

    axis_names = ("data", "model")

    def __init__(self, d_size, m_size):
        self.shape = {"data": d_size, "model": m_size}


def _shapes(items):
    return {p: (tuple(x.shape), str(np.dtype(x.dtype)) if not isinstance(
        x.dtype, torch.dtype) else str(x.dtype).replace("torch.", ""))
        for p, x in items if x is not None and not isinstance(x, int)}


@pytest.mark.parametrize("m_size", [2, 1])
def test_stack_model_template_matches_reference(m_size):
    from repro import checkpoint as jckpt
    from repro.configs import llama3_8b as jllama
    from repro.core import compressors as jcomp
    from repro.core.error_feedback import EFState as JEF
    from repro.launch import train as jtrain
    from repro.models import model as jmodel

    d_size = 2
    grid = _Grid(d_size, m_size)
    jcfg, cfg = jllama.reduced_config(), llama3_8b.reduced_config()
    jparts = jtrain.train_state_partition(jcfg, grid, jcomp.PowerSGDCompressor(rank=2),
                                          "one_step")
    jp = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg, m_size))
    jq = jax.eval_shape(lambda: jcomp.PowerSGDCompressor(rank=2).init(
        jp, jmodel.mspecs(jcfg), jax.random.key(1)))
    sds = lambda lead: jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(lead + x.shape, x.dtype), jp)
    jef = jckpt.stack_model_template(
        JEF(error=sds((d_size,)), momentum=jp, comp=jq,
            step=jax.ShapeDtypeStruct((), jnp.int32), inflight=jp),
        jparts, m_size)
    want = _shapes((jax.tree_util.keystr(p), x) for p, x in
                   jax.tree_util.tree_flatten_with_path(jef)[0])

    comp = compressors.PowerSGDCompressor(rank=2)
    parts = train.train_state_partition(cfg, grid, comp, "one_step")
    _, ef = train.global_template(cfg, grid, comp, "one_step")
    stacked = ts.stack_model_template(ef, parts, m_size)
    got = _shapes(engine._items_with_path(stacked))
    want.pop(".step")
    assert got == want
    local = [p for p, x in engine._items_with_path(parts.comp)
             if x is not None and x.model == MODEL_LOCAL]
    assert len(local) == 3        # embed, wo, w_down
    if m_size == 1:
        assert stacked is ef
    for x in tree.leaves(stacked.comp):
        assert x is None or x.device.type == "meta"


def test_restore_into_the_meta_template(tmp_path):
    """A (2, 2) envelope of the canonical tree restores into
    ``stack_model_template``'s meta template as new CPU tensors, bit for
    bit, and refuses model degree 1 naming both sizes."""
    params, ef = _toy_canonical(2, 2)
    ts.save_train_state(str(tmp_path), ts.TrainState(params=params, ef=ef, seed=5,
                                                     data_step=7),
                        model_axis_size=2, mesh_shape={"data": 2, "model": 2})
    meta = lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
    template_ef = dataclasses.replace(
        ef, error=tree.map(meta, ef.error),
        momentum=tree.map(meta, ef.momentum), inflight=tree.map(meta, ef.inflight),
        comp={k: None if x is None else meta(x[0] if TOY[k][4] == MODEL_LOCAL else x)
              for k, x in ef.comp.items()})
    template = ts.TrainState(
        params=tree.map(meta, params),
        ef=ts.stack_model_template(template_ef, _toy_partition(), 2))
    state, got_meta = ts.restore_train_state(str(tmp_path), template,
                                             model_axis_size=2)
    assert got_meta["mesh_shape"] == {"data": 2, "model": 2}
    assert state.seed == 5 and state.data_step == 7
    _equal((state.params, state.ef), (params, ef))
    assert all(x.device.type == "cpu" for x in _leaves((state.params, state.ef)))
    with pytest.raises(ts.CheckpointError,
                       match="model_axis_size=2.*model_axis_size=1"):
        ts.restore_train_state(str(tmp_path), template, model_axis_size=1)


def test_growth_of_the_pieces_is_the_global_growth():
    """Each model rank's factors grown 2 → 4 with the partition and its
    model coordinate, joined, are the joined factors grown, bit for bit:
    a model-sharded m dim draws its columns at global shape, a LOCAL or
    replicated factor at its own m (each stack entry alike)."""
    m_size = 2
    params, ef = _toy_canonical(1, m_size, seed=3)
    comp = {k: None if x is None else x[..., :2].contiguous()
            for k, x in ef.comp.items()}
    ef = dataclasses.replace(ef, comp=comp)
    shape = {"data": 1, "model": m_size}
    parts = _toy_partition()
    pieces = _split_all((params, ef), shape)
    grown = {}
    for c, (p, e) in pieces.items():
        ctl = powersgd.RankController("2@0,4@1")
        ctl.update(e.comp, 0)
        new, changed = ctl.update(e.comp, 1, partition=parts.comp,
                                  model_coord=(c[1], m_size))
        assert changed
        grown[c] = (p, dataclasses.replace(e, comp=new))
    joined = ts.assemble_mesh(grown, parts, shape)[1].comp
    ctl = powersgd.RankController("2@0,4@1")
    draw = lambda path, shape_: ctl.draw(0, path, shape_)
    for k, x in comp.items():
        if x is None:
            assert joined[k] is None
            continue
        if TOY[k][4] == MODEL_LOCAL:
            want = torch.stack([powersgd.transition_factor(q, 4, draw, (k,))
                                for q in x])
        else:
            want = powersgd.transition_factor(x, 4, draw, (k,))
        assert joined[k].shape == want.shape and torch.equal(joined[k], want), k
    # the model-sharded m dim's pieces hold different rows of the draw
    a, b = (grown[(0, m)][1].comp["col"][..., 2:] for m in range(m_size))
    assert not torch.equal(a, b)
