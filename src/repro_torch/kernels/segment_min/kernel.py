"""Launch wrapper of the Hopper segment-min kernel.

Replaces ``src/repro/kernels/segment_min/kernel.py::segment_min_pallas``.
Its bytes (8 B a key read once, 4 B a segment written) take less time on
the card than one launch at the pipeline's shapes. The first op was a
PyTorch fill of ``out``, a gap, then its kernel; on an H100 the kernel's
scattered reads and ``atomicMin``-s of ``out`` in L2 take most of the card's
time, but where the host dispatches the second launch while the card waits
(the pipeline's case) the gap is as long as the kernel. The CUDA kernel
(``csrc/connectivity_rounds.cu::segment_min_vec_kernel``) is therefore one
cooperative launch: it fills ``out`` with ``INF32``, waits at one
grid-wide barrier, then reads four keys and four ids per thread with
16-byte loads, skips ``INF32`` keys and out-of-range ids, and
``atomicMin``-s each live key into ``out[id]`` after a read that skips
keys no smaller. The scattered updates hold it above its byte bound.
``filled_segment_min`` runs the same body after a fill by PyTorch (two
launches: the alternative measured beside it), ``previous_segment_min``
the first kernel (one thread per key, after the same fill); no op reaches
either.
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


def _launch(entry: str, keys, ids, out, num_segments: int, *extra) -> None:
    cuda_lib.launch(entry, keys.device, keys.data_ptr(), ids.data_ptr(),
                    out.data_ptr(), keys.numel(), num_segments, *extra)


def _filled(keys, num_segments: int) -> torch.Tensor:
    return torch.full((num_segments,), INF32, dtype=INT, device=keys.device)


def segment_min_cuda(keys: torch.Tensor, ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors validated by ``ops.segment_min``:
    one launch that fills ``out`` too."""
    if not (keys.numel() and num_segments):
        return _filled(keys, num_segments)
    out = torch.empty((num_segments,), dtype=INT, device=keys.device)
    _launch("repro_segment_min", keys, ids, out, num_segments, 1)
    segment_min_cuda.launches += 1
    return out


segment_min_cuda.launches = 0


def filled_segment_min(keys, ids, num_segments: int) -> torch.Tensor:
    """The same kernel's body after PyTorch's fill of ``out`` (two
    launches), on validated CUDA tensors: a yardstick outside every op, its
    launches not counted."""
    out = _filled(keys, num_segments)
    if keys.numel() and num_segments:
        _launch("repro_segment_min", keys, ids, out, num_segments, 0)
    return out


def previous_segment_min(keys, ids, num_segments: int) -> torch.Tensor:
    """The first kernel (one thread per key) after PyTorch's fill of
    ``out``, on validated CUDA tensors: a yardstick outside every op, its
    launches not counted."""
    out = _filled(keys, num_segments)
    if keys.numel() and num_segments:
        _launch("repro_segment_min_v1", keys, ids, out, num_segments)
    return out
