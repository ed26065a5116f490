"""Launch wrapper of the Hopper segment-min kernel.

Replaces ``src/repro/kernels/segment_min/kernel.py::segment_min_pallas``.
The CUDA kernel (``csrc/connectivity_rounds.cu::segment_min_kernel``) is
one thread per key: skip ``INF32`` keys and out-of-range ids, else
``atomicMin(&out[id], key)``. It is bound by bytes: 8 B per key read once
plus 4 B per segment written.
"""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INF32, INT
from repro_torch.kernels import cuda_lib

# The JAX kernel's tile sizes; check_key_space keeps its limits so both
# packages accept and reject the same shapes.
EDGE_BLOCK = 1024
SEG_BLOCK = 512


def check_key_space(e: int, num_segments: int) -> None:
    """Reject shapes whose int32 keys/ids could collide with the INF32
    sentinel or wrap int32 (the JAX package's limits and messages)."""
    if e > INF32 - EDGE_BLOCK:
        raise ValueError(
            f"edge buffer of {e} slots overflows the int32 edge-key space "
            f"(limit {INF32 - EDGE_BLOCK}); shard the buffer first")
    if num_segments > INF32 - SEG_BLOCK:
        raise ValueError(
            f"{num_segments} segments overflows the int32 segment-id space "
            f"(limit {INF32 - SEG_BLOCK})")


def segment_min_cuda(keys: torch.Tensor, ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors validated by ``ops.segment_min``."""
    out = torch.full((num_segments,), INF32, dtype=INT, device=keys.device)
    e = keys.numel()
    if e and num_segments:
        cuda_lib.launch("repro_segment_min", keys.device, keys.data_ptr(),
                        ids.data_ptr(), out.data_ptr(), e, num_segments)
        segment_min_cuda.launches += 1
    return out


segment_min_cuda.launches = 0
