"""Launch wrapper of the Hopper embedding-bag kernel.

``embedding_bag_cuda`` replaces ``src/repro/kernels/embedding_bag/kernel.py::
embedding_bag_pallas`` (body ``_bag_kernel``). The CUDA kernel
(``csrc/embedding_bag.cu::embedding_bag_kernel``) gives one warp to each
(bag, block of 64 columns): the lanes run across the columns, the bag's
(index, mask) pairs are loaded once, 32 at a time, and broadcast by warp
shuffles, and the pooled sums stay in float32 registers. It is bound by
bytes: the sectors of the distinct rows it reads
(``ops.embedding_bag_bytes_read``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

MODES = ("sum", "mean", "max")
#: table dtypes the kernel takes, by the code its C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag_cuda(table, indices, mask, mode: str):
    """Launch the kernel on CUDA tensors validated by ``ops.embedding_bag``;
    ``mask`` may be None (every entry valid)."""
    n_bags, bag_len = indices.shape
    n_rows, dim = table.shape
    out = torch.empty((n_bags, dim), dtype=table.dtype, device=table.device)
    if n_bags and dim:
        cuda_lib.launch(
            "repro_embedding_bag", table.device, table.data_ptr(),
            indices.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), n_bags, bag_len, n_rows, dim, MODES.index(mode),
            DTYPES[table.dtype])
        embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
