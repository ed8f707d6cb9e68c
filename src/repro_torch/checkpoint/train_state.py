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
step keeps each rank's own buffer, which :func:`canonicalize_dist`
gathers.  Restoring into another worker count rescales the buffers
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

from repro_torch import tree
from repro_torch.checkpoint.msgpack_ckpt import (
    MODEL_AXIS_KEY, CheckpointError, ZeroBytes, check_model_axis, dtype_token,
    flatten_with_paths, load_envelope, restore_tree, save_checkpoint)
from repro_torch.core import error_feedback
from repro_torch.core.dist import DistBackend
from repro_torch.core.error_feedback import EFState

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
    :func:`canonicalize_dist`).  ``controller`` is the run's
    :class:`~repro_torch.core.powersgd.RankController`, saved in ``meta``
    so that a resume continues the schedule.  ``model_axis_size`` and
    ``mesh_shape`` are recorded as the JAX package records them; the port
    has no model axis (ROADMAP queue A, item 14), so the degree is 1."""
    if int(model_axis_size) != 1:
        raise NotImplementedError(
            "a model axis (tensor parallelism) is not ported yet (ROADMAP "
            "queue A, item 14): the port saves at model_axis_size=1")
    meta = {
        "train_state_version": TRAIN_STATE_VERSION,
        "workers": _error_workers(state.ef),
        "key_dtype": KEY_DTYPE,
        "controller": None if controller is None else controller.state_dict(),
        MODEL_AXIS_KEY: 1,
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


def canonicalize_dist(params, ef: EFState, group=None
                      ) -> Tuple[Any, EFState]:
    """A distributed run's state (each rank's own error buffer, no worker
    dim) in the canonical layout: every rank's buffers gathered into
    ``(W, ...)`` stacks in rank order, the counterpart of the JAX
    package's global error arrays; parameters, momentum, factors and the
    in-flight aggregate, identical on every rank, pass through.  A
    collective: every rank of ``group`` calls it (rank 0 then writes the
    envelope)."""
    backend = DistBackend(group)
    return params, dataclasses.replace(
        ef, error=tree.map(backend.all_gather, ef.error))


def replicate_dist(params, ef: EFState, group=None) -> Tuple[Any, EFState]:
    """The canonical state onto this rank of ``group``: the error buffers
    rescaled to the group's size (if it differs from the saved worker
    count) and this rank's row taken, in storage of its own; the rest
    passes through."""
    import torch.distributed as tdist

    rank, world = tdist.get_rank(group), tdist.get_world_size(group)
    stacked = error_feedback.rescale_error_buffers(ef.error, world)
    return params, dataclasses.replace(
        ef, error=tree.map(lambda e: e[rank].clone(), stacked))


def canonicalize_mesh(*args, **kwargs):
    raise NotImplementedError(
        "model-parallel checkpoints (canonicalize_mesh) wait for tensor "
        "parallelism, ROADMAP queue A, item 14")


def replicate_mesh(*args, **kwargs):
    raise NotImplementedError(
        "model-parallel checkpoints (replicate_mesh) wait for tensor "
        "parallelism, ROADMAP queue A, item 14")


def stack_model_template(*args, **kwargs):
    raise NotImplementedError(
        "model-parallel checkpoints (stack_model_template) wait for tensor "
        "parallelism, ROADMAP queue A, item 14")
