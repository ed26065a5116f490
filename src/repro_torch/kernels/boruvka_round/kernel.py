"""Launch wrapper of the Hopper Borůvka-round kernel.

Replaces ``src/repro/kernels/boruvka_round/kernel.py::boruvka_round_pallas``
(body ``_boruvka_round_kernel``, streaming ``_stream_chunks``). The CUDA
kernel (``csrc/connectivity_rounds.cu::boruvka_round_kernel``) makes one
grid-stride pass, one thread per edge slot: test ``mask`` and
``src != dst``, gather both endpoint labels (the int32[n] label array stays
in L2), and where they differ ``atomicMin`` the slot index into both
labels' entries of ``best``. It is bound by bytes: the 9 B edge slot read
once, plus 4 B per label read and 4 B per output written.
"""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INF32, INT
from repro_torch.kernels import cuda_lib


def boruvka_round_cuda(src, dst, mask, labels, num_segments: int):
    """Launch the kernel on CUDA tensors validated by ``ops.boruvka_round``."""
    best = torch.full((num_segments,), INF32, dtype=INT, device=src.device)
    e = src.numel()
    if e and num_segments:
        cuda_lib.launch("repro_boruvka_round", src.device, src.data_ptr(),
                        dst.data_ptr(), mask.data_ptr(), labels.data_ptr(),
                        best.data_ptr(), e, labels.numel(), num_segments)
        boruvka_round_cuda.launches += 1
    return best


boruvka_round_cuda.launches = 0
