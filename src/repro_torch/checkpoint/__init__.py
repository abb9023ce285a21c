"""Crash-atomic checkpoints of theta and of the run's random streams."""
from .ckpt import (CorruptCheckpointError, job_checkpoint_metadata, load_checkpoint,
                   protocol_state_metadata, restore_protocol_state, restore_pytree,
                   save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "restore_pytree",
           "CorruptCheckpointError", "protocol_state_metadata",
           "restore_protocol_state", "job_checkpoint_metadata"]
