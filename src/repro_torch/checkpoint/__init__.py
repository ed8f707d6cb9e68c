"""Checkpoints of the port: the JAX package's v2 envelope
(:mod:`~repro_torch.checkpoint.msgpack_ckpt`, over the MessagePack codec of
:mod:`~repro_torch.checkpoint.codec`) and the resumable train state
(:mod:`~repro_torch.checkpoint.train_state`)."""

from repro_torch.checkpoint.msgpack_ckpt import (
    MODEL_AXIS_KEY, CheckpointError, all_steps, check_model_axis,
    checkpoint_meta, decode_leaf, latest_step, load_envelope,
    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.train_state import (
    TrainState, canonicalize_mesh, canonicalize_sim, replicate_mesh,
    replicate_sim, restore_train_state, save_train_state,
    stack_model_template)
