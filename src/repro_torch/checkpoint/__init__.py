"""Atomic step checkpoints, the engine's write cadence, per-machine stores
and the elastic restart onto a mesh (``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    CheckpointPolicy,
    MachineCheckpoints,
    reshard_checkpoint,
)

__all__ = ["CheckpointManager", "CheckpointPolicy", "MachineCheckpoints",
           "reshard_checkpoint"]
