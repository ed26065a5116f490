"""LR schedules (pure functions of the step counter), ported from
``src/repro/optim/schedule.py``."""
import math

import torch


def cosine_schedule(step, *, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio``. Returns a float32
    scale in [0, 1] for the base lr; ``step`` is a 0-d integer tensor (or
    an int), read as float32 as the reference reads it."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
