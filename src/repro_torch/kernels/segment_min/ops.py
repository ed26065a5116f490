"""Public segment_min op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INT
from repro_torch.kernels.segment_min.kernel import check_key_space, segment_min_cuda
from repro_torch.kernels.segment_min.ref import segment_min_ref


def kernel_path(device) -> str:
    """``"cuda"`` where the op launches the kernel, ``"ref"`` on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "ref"
    raise ValueError(f"no segment_min path for device {device}")


def segment_min(keys: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """min(keys) per segment id; empty segments -> INF32; ids outside
    ``[0, num_segments)`` are dropped. keys, ids: int32[E], one device."""
    if keys.dim() != 1 or keys.shape != ids.shape:
        raise ValueError(
            f"keys and ids must be 1-D of one length: {tuple(keys.shape)} "
            f"vs {tuple(ids.shape)}")
    if keys.dtype != INT or ids.dtype != INT:
        raise TypeError(f"keys/ids must be int32, got {keys.dtype}/{ids.dtype}")
    if keys.device != ids.device:
        raise ValueError(f"keys on {keys.device}, ids on {ids.device}")
    if not (keys.is_contiguous() and ids.is_contiguous()):
        raise ValueError("keys and ids must be contiguous")
    check_key_space(keys.shape[0], num_segments)
    if kernel_path(keys.device) == "cuda":
        return segment_min_cuda(keys, ids, num_segments)
    return segment_min_ref(keys, ids, num_segments)
