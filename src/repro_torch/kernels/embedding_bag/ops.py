"""Public embedding_bag op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import (
    DTYPES,
    MODES,
    embedding_bag_cuda,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.segment_min.ops import kernel_path

__all__ = ["embedding_bag", "embedding_bag_bytes", "embedding_bag_bytes_read",
           "kernel_path"]

#: bytes of one device-memory sector, the unit a gathered row is read in
SECTOR_BYTES = 32


def embedding_bag_bytes(n_bags: int, bag_len: int, dim: int,
                        itemsize: int = 4) -> int:
    """Bytes of one call counted per lookup: the ``n_bags * bag_len``
    gathered rows of ``dim`` elements, the int32 index and the mask byte of
    each entry, and the ``[n_bags, dim]`` result. A row gathered twice
    counts twice, so this exceeds what the call must move."""
    entries = n_bags * bag_len
    return entries * dim * itemsize + entries * 5 + n_bags * dim * itemsize


def embedding_bag_bytes_read(table: torch.Tensor, indices: torch.Tensor,
                             mask: torch.Tensor | None = None,
                             mode: str = "sum") -> int:
    """Bytes one call on these inputs must move: the 32-byte sectors of the
    distinct table rows it reads, each once, the indices and mask once and
    the ``[B, D]`` result once. ``sum`` and ``mean`` read the row of every
    entry (a masked NaN row still reaches the bag), ``max`` only the valid
    entries'; negative ids wrap and out-of-range ids read no row."""
    n_rows, dim = table.shape
    ids = indices.long()
    if mode == "max" and mask is not None:
        ids = ids[mask]
    ids = torch.where(ids < 0, ids + n_rows, ids)
    rows = torch.unique(ids[(ids >= 0) & (ids < n_rows)])  # sorted
    row_bytes = dim * table.element_size()
    first = (table.data_ptr() + rows * row_bytes) // SECTOR_BYTES
    last = (table.data_ptr() + (rows + 1) * row_bytes - 1) // SECTOR_BYTES
    # rows are sorted, so a sector two rows share is one row's last and the
    # next row's first
    shared = int((first[1:] == last[:-1]).sum())
    sectors = int((last - first + 1).sum()) - shared
    entries = indices.numel()
    return (sectors * SECTOR_BYTES + entries * indices.element_size()
            + (0 if mask is None else entries)
            + indices.shape[0] * dim * table.element_size())


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Pool ``table[indices[b, l]]`` over l under ``mask``: ``sum``,
    ``mean`` (divided by max(count, 1)) or ``max`` (an empty bag gives 0).
    table: [V, D] float, contiguous; indices: int32[B, L]; mask: bool[B, L]
    or None (every entry valid) -> [B, D] in the table's dtype. Semantics
    of ``ref.embedding_bag_ref``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be 2-D and contiguous, got shape "
                         f"{tuple(table.shape)}")
    if not table.dtype.is_floating_point:
        raise TypeError(f"table must be floating, got {table.dtype}")
    if indices.dim() != 2 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32[B, L], got "
                        f"{indices.dtype}{list(indices.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != indices.shape):
        raise TypeError(f"mask must be bool{list(indices.shape)}, got "
                        f"{mask.dtype}{list(mask.shape)}")
    tensors = (table, indices) + (() if mask is None else (mask,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, indices and mask must lie on one device")
    if kernel_path(table.device) == "cuda":
        if table.dtype not in DTYPES:
            raise TypeError(f"the kernel takes tables of {list(DTYPES)}, got "
                            f"{table.dtype}")
        if max(table.shape[0], indices.numel()) >= 2 ** 31:
            raise ValueError("the kernel indexes rows and entries with int32")
        indices = indices.contiguous()
        mask = None if mask is None else mask.contiguous()
        return embedding_bag_cuda(table, indices, mask, mode)
    return embedding_bag_ref(table, indices, mask, mode)
