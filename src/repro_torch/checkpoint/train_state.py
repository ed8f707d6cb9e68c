"""The resumable algorithm state (port of ``repro.checkpoint.train_state``).

PowerSGD's trajectory depends on more than the parameters: the error
buffers, the momentum, the warm-started Q factors, the step counter, the
rank controller, the base seed of the shared-seed draws and the data
cursor all carry across steps.  :class:`TrainState` holds them and
:func:`save_train_state` writes them as the JAX package's ``TrainState``
envelope, leaf for leaf:

    ['data_step'], ['ef'].error[...], ['ef'].momentum[...], ['ef'].comp[...],
    ['ef'].step, ['ef'].inflight, ['key_data'], ['params'][...]

(the fields of the JAX package's ``EFState`` in declaration order).  The
port counts steps in a Python ``int``, written as an int32 scalar at
``['ef'].step``.  ``['ef'].inflight`` is a ``none`` record for a
synchronous run and the in-flight aggregate of a one-step-stale run
(``staleness="one_step"``).  Host scalars go in ``meta``: the worker
count, the :class:`~repro_torch.core.powersgd.RankController` state and
any caller extras.

Envelopes cross between pipeline modes as in the JAX package
(:func:`_splice_inflight`, noted in ``meta["inflight"]``): restored into a
one-step template, an envelope without an in-flight aggregate gives
zeros (``"zero_filled"``: one more pipeline bubble); restored into a
synchronous template, one with an aggregate drops it (``"dropped"``); a v1
envelope without the record restores into a synchronous template
(``"absent"``).

Canonical worker layout: what is identical on every worker (parameters,
momentum, Q factors, step, the in-flight aggregate) is stored once; the
per-worker error buffers are stacked ``(W, ...)``.  The simulated step
already holds its state so (:func:`canonicalize_sim`); the distributed
step keeps each rank's own buffer, which :func:`canonicalize_mesh`
gathers over the data group; on a model axis > 1 it also joins
the model-sharded leaves to global shape and stacks each model-LOCAL Q
factor per model rank on a leading ``(M,)`` dim, as the JAX package's
envelope holds them; :func:`stack_model_template` and
:func:`replicate_mesh` undo it at a resume on a grid of the same model
degree.  Restoring into another worker count rescales the buffers
(:func:`repro_torch.core.error_feedback.rescale_error_buffers`; same-W is
bit-exact), and the template's factors may sit at another rank than the
checkpoint's (the checkpoint's win).

The base key: the port's steps take an int base seed, written as
``key_data = [0, seed]`` (uint32) with ``key_dtype = "key<fry>"``, the bytes
of ``jax.random.key(seed)``, so either package restores the other's key.
Declared divergence: the two packages draw different streams from the same
key (torch cannot reproduce threefry), which only draws after the
initialization see (rank-switch columns, Random-K and Random Block
indices); PowerSGD's warm-started steps draw nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch import tree
from repro_torch.checkpoint.msgpack_ckpt import (
    MODEL_AXIS_KEY, CheckpointError, ZeroBytes, check_model_axis, dtype_token,
    flatten_with_paths, load_envelope, restore_tree, save_checkpoint)
from repro_torch.core import error_feedback
from repro_torch.core.engine import MODEL_LOCAL, StatePartition
from repro_torch.core.error_feedback import EFState
from repro_torch.sharding import P, mentions, shard

TRAIN_STATE_VERSION = 2
KEY_DTYPE = "key<fry>"   # the JAX package's tag of jax.random.key's data

# envelope paths whose shapes may differ from the template's
_COMP_PREFIX = "['ef'].comp"
_ERROR_PREFIX = "['ef'].error"
_INFLIGHT_PATH = "['ef'].inflight"


@dataclasses.dataclass
class TrainState:
    """The whole resumable algorithm state: parameters and the EF state in
    the canonical worker layout, the run's base seed and the data
    cursor."""

    params: Any
    ef: EFState
    seed: int = 0        # base seed of the shared-seed draws
    data_step: int = 0   # the batch-stream cursor


@dataclasses.dataclass
class _EFRecord:
    """The JAX package's ``EFState`` layout, fields in its order."""

    error: Any
    momentum: Any
    comp: Any
    step: Any
    inflight: Any = None


def seed_to_key_data(seed: int) -> np.ndarray:
    """``[0, seed]`` as uint32: the data of ``jax.random.key(seed)``."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"base seed {seed} is outside [0, 2**32): the "
                         f"envelope stores it as jax.random.key(seed)'s data")
    return np.array([0, seed], np.uint32)


def seed_from_key_data(data, tag: str) -> int:
    """The int seed of an envelope's key: ``[0, seed]`` tagged
    ``key<fry>`` (or ``raw``)."""
    words = [int(x) for x in np.asarray(data).reshape(-1)]
    if tag not in (KEY_DTYPE, "raw") or len(words) != 2 or words[0] != 0:
        raise CheckpointError(
            f"PRNG key {words} ({tag}) is not jax.random.key of a 32-bit "
            f"seed: the port keys its draws by an int seed and can restore "
            f"only such keys")
    return words[1]


def _as_tree(state: TrainState) -> dict:
    ef = state.ef
    return {"params": state.params,
            "ef": _EFRecord(error=ef.error, momentum=ef.momentum,
                            comp=ef.comp,
                            step=np.asarray(int(ef.step), np.int32),
                            inflight=ef.inflight),
            "key_data": seed_to_key_data(state.seed),
            "data_step": np.asarray(int(state.data_step), np.int32)}


def _error_workers(ef) -> Optional[int]:
    leaves = tree.leaves(ef.error)
    return int(leaves[0].shape[0]) if leaves else None


def save_train_state(directory: str, state: TrainState, *,
                     controller=None, keep: int = 3,
                     extra_meta: Optional[dict] = None,
                     model_axis_size: int = 1,
                     mesh_shape: Optional[dict] = None) -> str:
    """Write one checkpoint at ``state.ef.step``.

    ``state`` is in the canonical worker layout (:func:`canonicalize_sim`,
    :func:`canonicalize_mesh`).  ``controller``
    is the run's :class:`~repro_torch.core.powersgd.RankController`, saved
    in ``meta`` so that a resume continues the schedule.
    ``model_axis_size`` and ``mesh_shape`` record the (data, model) grid
    the state was gathered on, as the JAX package records them; a restore's
    degree guard (:func:`~repro_torch.checkpoint.msgpack_ckpt.
    check_model_axis`) reads the former."""
    meta = {
        "train_state_version": TRAIN_STATE_VERSION,
        "workers": _error_workers(state.ef),
        "key_dtype": KEY_DTYPE,
        "controller": None if controller is None else controller.state_dict(),
        MODEL_AXIS_KEY: int(model_axis_size),
        "mesh_shape": mesh_shape,
    }
    meta.update(extra_meta or {})
    return save_checkpoint(directory, int(state.ef.step), _as_tree(state),
                           keep=keep, meta=meta)


def _splice_inflight(payload: dict, t_tree) -> Tuple[dict, Optional[str]]:
    """Align the envelope's records with the template tree ``t_tree`` at
    ``['ef'].inflight``, so that envelopes cross between pipeline modes
    (and versions), as the JAX package's ``_splice_inflight`` does:

    * the envelope's in-flight records are the template's: they pass
      through (note ``None``; the restore is bit-exact);
    * the template has an in-flight tree the envelope lacks (a
      synchronous or v1 envelope into a one-step template): zero records,
      whose bytes are not built (:class:`ZeroBytes`) — the restore zeroes
      the template's tensors (``"zero_filled"``);
    * the envelope has an in-flight tree the template has no room for: its
      records are dropped, never read (``"dropped"``);
    * a v1 envelope without the record, into a synchronous template: the
      ``none`` record is added (``"absent"``).

    Returns ``(payload, note)``; a mismatch outside ``['ef'].inflight``
    passes through for :func:`restore_tree` to report."""
    t_pairs = flatten_with_paths(t_tree)
    t_paths = [p for p, _ in t_pairs]
    enc = payload["leaves"]

    def is_inflight(path):
        return (path or "").startswith(_INFLIGHT_PATH)

    enc_inflight = {d.get("path"): d for d in enc if is_inflight(d.get("path"))}
    if set(enc_inflight) == {p for p in t_paths if is_inflight(p)}:
        return payload, None
    others = [d for d in enc if not is_inflight(d.get("path"))]
    if len(others) != sum(1 for p in t_paths if not is_inflight(p)):
        return payload, None
    others = iter(others)
    spliced, zero_filled = [], False
    for path, want in t_pairs:
        if not is_inflight(path):
            spliced.append(next(others))
        elif path in enc_inflight:
            spliced.append(enc_inflight[path])
        elif want is None:
            spliced.append({"kind": "none", "path": path})
        else:
            zero_filled = True
            spliced.append({"kind": "array", "dtype": dtype_token(want),
                            "shape": [int(n) for n in want.shape],
                            "data": ZeroBytes(want.numel() * want.element_size()),
                            "path": path})
    dropped = bool(set(enc_inflight) - set(t_paths))
    note = ("zero_filled" if zero_filled
            else "dropped" if dropped else "absent")
    return {**payload, "leaves": spliced}, note


def restore_train_state(directory: str, template: TrainState,
                        step: Optional[int] = None, *,
                        model_axis_size: Optional[int] = None
                        ) -> Tuple[TrainState, dict]:
    """Restore a :class:`TrainState`, adapting rank and worker count.

    ``template`` gives structure, dtypes and devices (a freshly initialized
    state at the configured rank and the current worker count, canonical
    layout).  Leaves whose shapes agree are read into the template's
    tensors in place; the factors keep the checkpoint's rank, and error
    buffers saved at another worker count are rescaled
    (``meta["ef_rescale"]`` names the path).  Returns ``(state, meta)``.
    Raises :class:`CheckpointError` on truncation, corruption, a model
    degree other than ``model_axis_size`` or any other mismatch."""
    payload = load_envelope(directory, step)
    meta = dict(payload["meta"])
    if "train_state_version" not in meta:
        raise CheckpointError(
            f"checkpoint in {directory} is not a TrainState envelope "
            f"(plain save_checkpoint tree?) — no train_state_version in "
            f"meta")
    if model_axis_size is not None:
        check_model_axis(meta, model_axis_size)

    def shape_ok(tpath, gs, ws):
        if tpath.startswith(_COMP_PREFIX):
            return gs[:-1] == ws[:-1]    # rank (last dim) may move
        if tpath.startswith(_ERROR_PREFIX):
            return gs[1:] == ws[1:]      # worker count (dim 0) may move
        return False

    t_tree = _as_tree(template)
    payload, inflight_note = _splice_inflight(payload, t_tree)
    if inflight_note:
        meta["inflight"] = inflight_note
    restored = restore_tree(payload, t_tree, shape_ok=shape_ok)
    rec = restored["ef"]
    error = rec.error
    w_new, w_old = _error_workers(template.ef), _error_workers(rec)
    if w_new is not None:
        meta["ef_rescale"] = {
            "from": w_old, "to": w_new,
            "path": error_feedback.rescale_path(w_old, w_new)}
        error = error_feedback.rescale_error_buffers(error, w_new)
    ef = EFState(error=error, momentum=rec.momentum, comp=rec.comp,
                 step=int(rec.step), inflight=rec.inflight)
    state = TrainState(
        params=restored["params"], ef=ef,
        seed=seed_from_key_data(restored["key_data"],
                                meta.get("key_dtype", "raw")),
        data_step=int(restored["data_step"]))
    return state, meta


# ---------------------------------------------------------------------------
# step layouts ⇄ canonical layout
# ---------------------------------------------------------------------------

def canonicalize_sim(sim, params, ef: EFState) -> Tuple[Any, EFState]:
    """A :class:`~repro_torch.core.simmesh.SimMesh` run's state in the
    canonical layout: the port's simulated step already holds parameters,
    momentum, factors and the in-flight aggregate once and the error
    buffers stacked ``(W, ...)``, so this checks the worker dim and passes
    the state through."""
    w = _error_workers(ef)
    if w is not None and w != sim.workers:
        raise ValueError(f"error buffers carry {w} workers, the mesh has "
                         f"{sim.workers}")
    return params, ef


def replicate_sim(sim, params, ef: EFState) -> Tuple[Any, EFState]:
    """The canonical state onto ``sim``, which may have another worker
    count than the state was saved at: the error buffers are rescaled,
    the rest (held once) passes through."""
    return params, dataclasses.replace(
        ef, error=error_feedback.rescale_error_buffers(ef.error, sim.workers))


# ---------------------------------------------------------------------------
# the (data, model) grid ⇄ canonical layout
# ---------------------------------------------------------------------------
#
# The canonical tree of a grid is the JAX package's envelope tree, leaf for
# leaf: parameters, momentum and the in-flight aggregate at global shape
# (joined along their model-sharded dims), error buffers (D, global shape),
# model-sharded Q factors joined along the dim their spec names,
# model-replicated leaves once, and model-LOCAL Q factors (a row-parallel
# weight's, each model rank's own content behind a replicated-shaped spec)
# stacked on a leading (M,) dim.  The layout is read off the partition
# records of ``repro_torch.launch.train.train_state_partition``.
# :func:`assemble_mesh` / :func:`split_mesh` are the pure halves, one process
# holding every coordinate's pieces; :func:`canonicalize_mesh` /
# :func:`replicate_mesh` are the collective wrappers, one process per
# coordinate.

def _model_size(shape, model_axis: str) -> int:
    return int(shape.get(model_axis, 1))


def _is_local(part, size: int) -> bool:
    """A model-LOCAL leaf on a model axis > 1 (at degree 1 the class has one
    copy and is stored as it is)."""
    return size > 1 and isinstance(part, StatePartition) and part.model == MODEL_LOCAL


def _sharded_dim(spec, model_axis: str) -> Optional[int]:
    dims = [d for d, e in enumerate(tuple(spec)) if mentions(e, model_axis)]
    if len(dims) > 1:
        raise ValueError(f"{spec} carries {model_axis!r} on more than one dim")
    return dims[0] if dims else None


def _join(xs, part, size: int, model_axis: str) -> torch.Tensor:
    """One leaf's pieces of model ranks 0 … M−1 → its canonical leaf."""
    if _is_local(part, size):
        return torch.stack(list(xs))
    dim = _sharded_dim(part.spec, model_axis)
    return xs[0] if dim is None else torch.cat(list(xs), dim)


def _piece(x, part, m: int, size: int, model_axis: str) -> torch.Tensor:
    """Model rank ``m``'s piece of a canonical leaf (a view)."""
    if _is_local(part, size):
        return x[m]
    return shard(x, part.spec, {model_axis: (m, size)})


def _own(x: torch.Tensor, device=None) -> torch.Tensor:
    """``x`` in contiguous storage of its own, on ``device`` (``None``:
    where it is)."""
    return x.to(device=x.device if device is None else device, copy=True,
                memory_format=torch.contiguous_format)


def _row_records(partition: EFState):
    """The error buffers' records without their leading data-axes entry: a
    rank's own buffer has no worker dim."""
    return tree.map(lambda p: StatePartition(spec=P(*tuple(p.spec)[1:]),
                                             model=p.model), partition.error)


def _leafwise(fn, records, *trees):
    """``fn(record, *leaves)`` over trees aligned with a record tree;
    ``None`` leaves stay ``None``."""
    return tree.map(lambda part, *xs: None if xs[0] is None else fn(part, *xs),
                    records, *trees)


def assemble_mesh(pieces, partition: EFState, shape,
                  model_axis: str = "model") -> Tuple[Any, EFState]:
    """The canonical tree of a grid from its local trees, in one process:
    ``pieces[(d, m)]`` is coordinate ``(d, m)``'s ``(params, ef)`` (its
    error buffers its own, without a worker dim), ``shape`` ``{"data": D,
    model_axis: M}`` and ``partition`` the run's
    ``train_state_partition``.  Replicated trees are read off data row 0;
    the error buffers of every coordinate are joined per data row and
    stacked ``(D, …)``.  At M = 1 model-LOCAL leaves are stored as they
    are."""
    d_size, size = int(shape["data"]), _model_size(shape, model_axis)
    join = lambda part, *xs: _join(xs, part, size, model_axis)
    row0 = [pieces[(0, m)] for m in range(size)]
    field = lambda name: [getattr(ef, name) for _, ef in row0]
    rows = _row_records(partition)
    per_row = [_leafwise(join, rows, *[pieces[(d, m)][1].error for m in range(size)])
               for d in range(d_size)]
    ef0 = row0[0][1]
    return _leafwise(join, partition.momentum, *[p for p, _ in row0]), EFState(
        error=tree.map(lambda *xs: torch.stack(xs), *per_row),
        momentum=_leafwise(join, partition.momentum, *field("momentum")),
        comp=_leafwise(join, partition.comp, *field("comp")),
        step=ef0.step,
        inflight=(None if ef0.inflight is None
                  else _leafwise(join, partition.inflight, *field("inflight"))))


def split_mesh(params, ef: EFState, partition: EFState, coord, shape,
               model_axis: str = "model", device=None) -> Tuple[Any, EFState]:
    """Coordinate ``coord = (d, m)``'s local trees from a canonical tree,
    the inverse of :func:`assemble_mesh`: every leaf a copy in storage of
    its own on ``device`` (``None``: where the canonical leaf is), never a
    view into the canonical tensor.  The error buffers are first rescaled
    to D workers (:func:`repro_torch.core.error_feedback.
    rescale_error_buffers`) when the canonical tree was saved at another
    worker count, then row ``d`` taken."""
    d, m = (int(c) for c in coord)
    d_size, size = int(shape["data"]), _model_size(shape, model_axis)
    take = lambda part, x: _own(_piece(x, part, m, size, model_axis), device)
    error = error_feedback.rescale_error_buffers(ef.error, d_size)
    return _leafwise(take, partition.momentum, params), EFState(
        error=_leafwise(take, _row_records(partition),
                        tree.map(lambda e: e[d], error)),
        momentum=_leafwise(take, partition.momentum, ef.momentum),
        comp=_leafwise(take, partition.comp, ef.comp),
        step=ef.step,
        inflight=(None if ef.inflight is None
                  else _leafwise(take, partition.inflight, ef.inflight)))


def _gather(x: torch.Tensor, group) -> Optional[torch.Tensor]:
    """Every rank of ``group``'s ``x`` stacked in group-rank order, on the
    group's rank 0; ``None`` on its other ranks.  A group of one gives
    ``x[None]`` with no collective.  A checkpoint's collective, so not
    counted in :data:`repro_torch.core.dist.CALLS`: a save between steps
    leaves the step's counts as they are."""
    n = tdist.get_world_size(group)
    if n == 1:
        return x[None]
    x = x.contiguous()
    dst = tdist.get_global_rank(group, 0)
    if tdist.get_rank(group) != 0:
        tdist.gather(x, None, dst=dst, group=group)
        return None
    out = x.new_empty((n,) + tuple(x.shape))
    tdist.gather(x, list(out.unbind(0)), dst=dst, group=group)
    return out


def canonicalize_mesh(mesh, params, ef: EFState, partition: EFState,
                      model_axis: str = "model") -> Tuple[Any, EFState]:
    """This grid's state in the canonical layout, for
    :func:`save_train_state` (:func:`assemble_mesh` over the processes).
    ``mesh`` is the run's :class:`~repro_torch.launch.mesh.Mesh`,
    ``params``/``ef`` this rank's local trees and ``partition`` the run's
    ``train_state_partition``.  A collective: every rank calls it; the
    canonical tree comes back on rank 0 of the default group (coordinate
    (0, 0), which writes it) and ``(None, None)`` on the others.

    Leaf by leaf, a model-sharded or model-LOCAL leaf is gathered over
    ``mesh.model_group`` to its model rank 0, and an error buffer then over
    ``mesh.data_group`` to data rank 0; each leaf a gather built goes to the
    host at once, so a card holds one gathered leaf at a time on top of its
    own shards, and only the writer's host holds the gathered tree.  A
    leaf no gather touched (model-replicated, or any leaf but an error
    buffer at model degree 1) is rank 0's own tensor, where it lies.  The
    gathers are not counted in :data:`repro_torch.core.dist.CALLS` or
    ``MODEL_CALLS``."""
    size = _model_size(mesh.shape, model_axis)
    d, m = mesh.coord
    differs = lambda part: _is_local(part, size) or (
        size > 1 and _sharded_dim(part.spec, model_axis) is not None)

    def row(part, x):
        """This data row's joined leaf on its model rank 0, else None."""
        if not differs(part):
            return x if m == 0 else None
        xs = _gather(x, mesh.model_group)
        return None if xs is None else _join(xs.unbind(0), part, size, model_axis)

    def joined(part, x):
        if d != 0:
            return None
        y = row(part, x)
        return y if y is None or not differs(part) else y.to("cpu")

    def error(part, x):
        y = row(part, x)
        if y is None:
            return None
        ys = _gather(y, mesh.data_group)
        if ys is None:
            return None
        gathered = differs(part) or mesh.shape["data"] > 1
        return ys.to("cpu") if gathered else ys

    ef_c = EFState(
        error=_leafwise(error, _row_records(partition), ef.error),
        momentum=_leafwise(joined, partition.momentum, ef.momentum),
        comp=_leafwise(joined, partition.comp, ef.comp),
        step=ef.step,
        inflight=(None if ef.inflight is None
                  else _leafwise(joined, partition.inflight, ef.inflight)))
    p_c = _leafwise(joined, partition.momentum, params)
    return (p_c, ef_c) if mesh.rank == 0 else (None, None)


def replicate_mesh(mesh, params, ef: EFState, partition: EFState,
                   model_axis: str = "model", device=None
                   ) -> Tuple[Any, EFState]:
    """The inverse of :func:`canonicalize_mesh`: this rank's local trees
    (:func:`split_mesh` at ``mesh.coord``), each leaf in storage of its own
    on ``device``; a model-LOCAL leaf gives each model rank its own
    pre-save copy back.  The error buffers are rescaled when the grid's
    data size differs from the saved worker count.  No collective.  The stack's leading dim
    must be the grid's model degree, which
    :func:`restore_train_state`'s ``model_axis_size`` guard enforces."""
    return split_mesh(params, ef, partition, mesh.coord, mesh.shape,
                      model_axis, device)


def stack_model_template(ef: EFState, partition: EFState,
                         model_axis_size: int) -> EFState:
    """A restore template in the canonical layout: ``ef`` (global shapes)
    with each model-LOCAL Q factor given the leading ``(model_axis_size,)``
    dim the envelope stores it with, as an empty tensor on the ``meta``
    device (:func:`restore_train_state` reads such a leaf into a new CPU
    tensor).  Degree 1 is the identity."""
    size = int(model_axis_size)
    if size <= 1:
        return ef

    def stack(part, x):
        if not _is_local(part, size):
            return x
        return torch.empty((size,) + tuple(x.shape), dtype=x.dtype, device="meta")

    return dataclasses.replace(ef, comp=_leafwise(stack, partition.comp, ef.comp))
