"""Launch wrapper of the Hopper embedding-bag kernels.

``embedding_bag_cuda`` replaces ``src/repro/kernels/embedding_bag/kernel.py::
embedding_bag_pallas`` (body ``_bag_kernel``). Its C entry
(``csrc/embedding_bag.cu::repro_embedding_bag``) has two kernels and picks
one by the number of work items, (bag, block of 64 columns) pairs, against
``BLOCK_ITEMS_MAX``:

- up to it, ``embedding_bag_block_kernel``: one block of 8 warps per item,
  each warp loading its own entries (w, w + 8, ...) and all their rows
  before it sums, the warps' partials combined in shared memory in warp
  order. At one bag (SASRec's retrieval step) the call is bound by latency,
  not bytes: the rows of a bag are one round trip deep.
- above it, ``embedding_bag_kernel``, the first kernel of the port: one warp
  per item, the lanes across the columns, the bag's (index, mask) pairs
  loaded 32 at a time and broadcast by warp shuffles. Bound by bytes: the
  sectors of the distinct rows it reads (``ops.embedding_bag_bytes_read``).

``previous_embedding_bag`` launches the first kernel at every size (a
yardstick no op reaches), ``block_embedding_bag`` the block kernel at every
size (for the threshold's sweep), ``launch_floor`` an empty kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

MODES = ("sum", "mean", "max")
#: table dtypes the kernel takes, by the code its C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most work items that go to the block kernel: ``chip_smoke.py``'s
#: sweep (bags of 50, D 50, mean) on an H100 80GB HBM3 at 700 W had the
#: block kernel ahead up to 4,096 bags and behind from 8,192
BLOCK_ITEMS_MAX = 4096


def _launch(entry: str, table, indices, mask, mode: str, *extra):
    n_bags, bag_len = indices.shape
    n_rows, dim = table.shape
    out = torch.empty((n_bags, dim), dtype=table.dtype, device=table.device)
    launched = bool(n_bags and dim)
    if launched:
        cuda_lib.launch(
            entry, table.device, table.data_ptr(), indices.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), n_bags,
            bag_len, n_rows, dim, MODES.index(mode), DTYPES[table.dtype],
            *extra)
    return out, launched


def embedding_bag_cuda(table, indices, mask, mode: str):
    """Launch the kernel on CUDA tensors validated by ``ops.embedding_bag``;
    ``mask`` may be None (every entry valid)."""
    out, launched = _launch("repro_embedding_bag", table, indices, mask,
                            mode, BLOCK_ITEMS_MAX)
    embedding_bag_cuda.launches += launched
    return out


embedding_bag_cuda.launches = 0


def block_embedding_bag(table, indices, mask, mode: str):
    """The block kernel at any number of bags, on validated CUDA tensors;
    launches not counted."""
    return _launch("repro_embedding_bag", table, indices, mask, mode,
                   2 ** 62)[0]


def previous_embedding_bag(table, indices, mask, mode: str):
    """The first kernel (one warp per work item) at any number of bags, on
    validated CUDA tensors: a yardstick outside every op, launches not
    counted."""
    return _launch("repro_embedding_bag_v1", table, indices, mask, mode)[0]


def launch_floor(device) -> None:
    """Launch an empty kernel through the same path as the others."""
    cuda_lib.launch("repro_noop", device)
