"""Optimizer substrate of the port (``repro.optim``): AdamW with float32
master weights, the cosine schedule and int8 gradient compression."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "cosine_schedule",
    "compress_int8",
    "decompress_int8",
]
