"""Partition specs of the optimizer and compressor state (port of the state
half of ``repro.launch.specs``).

:func:`ef_partition` is the single source of the state's partition
records: the step builder slices the initial state by their specs
(:func:`partition_specs`) and hands the compressor's part to the bucketed
engine; the mesh-aware checkpoints read them too
(:func:`repro_torch.checkpoint.train_state.canonicalize_mesh`,
:func:`~repro_torch.checkpoint.train_state.replicate_mesh`,
:func:`~repro_torch.checkpoint.train_state.stack_model_template`).

The rest of the reference module (``batch_pspecs``, ``batch_specs``,
``with_sharding``, ``decode_layout``, ``abstract_cache``) serves the
dry-run and serving and waits for ROADMAP queue A, item 16.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch import tree
from repro_torch.core import matrixize, powersgd
from repro_torch.core.engine import (MODEL_REPLICATED, MODEL_SHARDED,
                                     StatePartition)
from repro_torch.core.error_feedback import EFState
from repro_torch.sharding import P, mentions


def qstate_pspec(param_spec, mspec: matrixize.MatrixSpec) -> Optional[P]:
    """The spec of one parameter's PowerSGD Q factor: batch dims keep their
    entries, the m dim is model-sharded iff one of the parameter's m dims
    is (the model-LOCAL class lives in :func:`powersgd.factor_partition`,
    which this dims-only view cannot express)."""
    part = powersgd.factor_partition(param_spec, mspec)
    return None if part is None else part.spec


def qstate_pspecs(param_pspecs, mspecs):
    return tree.map(qstate_pspec, param_pspecs, mspecs)


def _dims_partition(spec, model_axis: str = "model") -> StatePartition:
    """The record of a leaf whose dims say all of its content (parameters,
    momentum, error buffers): model-sharded iff a dim carries the axis,
    never model-local."""
    sharded = any(mentions(e, model_axis) for e in tuple(spec))
    return StatePartition(spec=spec,
                          model=MODEL_SHARDED if sharded else MODEL_REPLICATED)


def ef_partition(param_pspecs, mspecs, dp_axes: Tuple[str, ...],
                 compressor=None, stateful: bool = True,
                 staleness: str = "none") -> EFState:
    """Per-leaf :class:`~repro_torch.core.engine.StatePartition` tree of the
    whole error-feedback state.  Error buffers gain a leading data-axes dim
    (the reference's global layout; a port rank holds its own buffer
    without it) and inherit their parameter's model sharding; momentum
    mirrors the parameter; ``comp`` is the compressor's own
    :meth:`~repro_torch.core.compressors.Compressor.state_partition`
    (PowerSGD's otherwise); under ``staleness="one_step"`` the in-flight
    aggregate is classified like the parameters it will be applied to."""
    error = tree.map(lambda s: _dims_partition(P(*((dp_axes,) + tuple(s)))),
                     param_pspecs)
    momentum = tree.map(_dims_partition, param_pspecs)
    if compressor is not None:
        comp = compressor.state_partition(param_pspecs, mspecs)
    elif stateful:
        comp = powersgd.state_partition(param_pspecs, mspecs)
    else:
        comp = None
    inflight = (tree.map(_dims_partition, param_pspecs)
                if staleness == "one_step" else None)
    return EFState(error=error, momentum=momentum, comp=comp,
                   step=StatePartition(spec=P(), model=MODEL_REPLICATED),
                   inflight=inflight)


def partition_specs(partition):
    """The dims-spec tree of a partition tree (an ``EFState`` of records,
    or one tree of records); ``None`` stays ``None``."""
    spec = lambda p: None if p is None else p.spec
    if isinstance(partition, EFState):
        return EFState(error=tree.map(spec, partition.error),
                       momentum=tree.map(spec, partition.momentum),
                       comp=(None if partition.comp is None
                             else tree.map(spec, partition.comp)),
                       step=spec(partition.step),
                       inflight=(None if partition.inflight is None
                                 else tree.map(spec, partition.inflight)))
    return tree.map(spec, partition)


def ef_pspecs(param_pspecs, mspecs, dp_axes: Tuple[str, ...],
              stateful: bool = True) -> EFState:
    """The specs of the error-feedback state (the dims view of
    :func:`ef_partition`); ``stateful=False`` gives ``comp=None``."""
    return partition_specs(
        ef_partition(param_pspecs, mspecs, dp_axes, stateful=stateful))
