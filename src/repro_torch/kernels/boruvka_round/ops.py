"""Public connectivity-round ops (the Borůvka round and the scan-first
frontier round): the Hopper kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else; a dry run's fake tensor
(``launch/dryrun.py``) gets the results' shapes and dtypes only."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INT, is_fake
from repro_torch.kernels.boruvka_round.kernel import (
    boruvka_round_cuda,
    frontier_round_cuda,
)
from repro_torch.kernels.boruvka_round.ref import (
    boruvka_round_ref,
    frontier_round_ref,
)
from repro_torch.kernels.segment_min.kernel import check_key_space
from repro_torch.kernels.segment_min.ops import kernel_path

#: bytes per edge slot of the raw buffer: src int32 + dst int32 + mask byte
EDGE_SLOT_BYTES = 9


def boruvka_round_bytes(e: int, n: int, live: int) -> int:
    """Bytes one Borůvka round must move over ``e`` slots of which ``live``
    have their mask set: every slot's mask byte, src and dst of the live
    slots (a full 9 B slot), the int32[n] labels read once and the int32[n]
    result written once."""
    return live * EDGE_SLOT_BYTES + (e - live) + 4 * n + 4 * n


def frontier_round_bytes(e: int, n: int, live: int) -> int:
    """Bytes one frontier round must move over ``e`` slots of which
    ``live`` have their mask set: every slot's mask byte, src and dst of
    the live slots (a full 9 B slot), the bool[n] ``frontier`` and
    ``visited`` read once, and the two int32[n] results written once."""
    return live * EDGE_SLOT_BYTES + (e - live) + 2 * n + 8 * n


def _check_edges(src, dst, mask, per_vertex: dict, num_segments: int):
    """The validation both round ops share: 1-D int32 ``src``/``dst`` and
    bool ``mask`` of one length, per-vertex arrays 1-D, non-empty where
    there are slots and of the dtype given, one device, contiguous, and
    the key space of ``check_key_space``."""
    if src.dim() != 1 or src.shape != dst.shape or src.shape != mask.shape:
        raise ValueError(
            f"src, dst, mask must be 1-D of one length: {tuple(src.shape)}, "
            f"{tuple(dst.shape)}, {tuple(mask.shape)}")
    if src.dtype != INT or dst.dtype != INT:
        raise TypeError(f"src/dst must be int32, got {src.dtype}/{dst.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    for name, (t, dtype) in per_vertex.items():
        if t.dim() != 1 or (src.numel() and t.numel() == 0):
            raise ValueError(f"{name} must be 1-D and non-empty, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    tensors = [src, dst, mask] + [t for t, _ in per_vertex.values()]
    names = "src, dst, mask, " + ", ".join(per_vertex)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{names} must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{names} must be contiguous")
    check_key_space(src.shape[0], num_segments)


def boruvka_round(src, dst, mask, labels, num_segments: int):
    """Fused Borůvka hooking round (contract: ``ref.boruvka_round_ref``).

    src, dst: int32[E]; mask: bool[E]; labels: int32[n]; one device.
    """
    _check_edges(src, dst, mask, {"labels": (labels, INT)}, num_segments)
    if is_fake(src):
        # a dry run's fake tensors: the result's shape and dtype only
        return src.new_empty((num_segments,))
    if kernel_path(src.device) == "cuda":
        return boruvka_round_cuda(src, dst, mask, labels, num_segments)
    return boruvka_round_ref(src, dst, mask, labels, num_segments)


def frontier_round(src, dst, mask, frontier, visited, num_segments: int):
    """Fused scan-first-search frontier round (contract:
    ``ref.frontier_round_ref``). Returns ``(best_p, best_e)``.

    src, dst: int32[E]; mask: bool[E]; frontier, visited: bool[n] of one
    length; one device.
    """
    _check_edges(src, dst, mask, {"frontier": (frontier, torch.bool),
                                  "visited": (visited, torch.bool)},
                 num_segments)
    if frontier.shape != visited.shape:
        raise ValueError(f"frontier and visited differ in length: "
                         f"{tuple(frontier.shape)} vs {tuple(visited.shape)}")
    if is_fake(src):
        return src.new_empty((num_segments,)), src.new_empty((num_segments,))
    if kernel_path(src.device) == "cuda":
        return frontier_round_cuda(src, dst, mask, frontier, visited,
                                   num_segments)
    return frontier_round_ref(src, dst, mask, frontier, visited, num_segments)
