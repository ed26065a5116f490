"""Atomic step checkpoints, the engine's write cadence and per-machine
stores (``repro.checkpoint``, without ``reshard_checkpoint``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    CheckpointPolicy,
    MachineCheckpoints,
)

__all__ = ["CheckpointManager", "CheckpointPolicy", "MachineCheckpoints"]
