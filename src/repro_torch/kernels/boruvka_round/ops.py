"""Public Borůvka-round op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INT
from repro_torch.kernels.boruvka_round.kernel import boruvka_round_cuda
from repro_torch.kernels.boruvka_round.ref import boruvka_round_ref
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


def boruvka_round(src, dst, mask, labels, num_segments: int):
    """Fused Borůvka hooking round (contract: ``ref.boruvka_round_ref``).

    src, dst: int32[E]; mask: bool[E]; labels: int32[n]; one device.
    """
    if src.dim() != 1 or src.shape != dst.shape or src.shape != mask.shape:
        raise ValueError(
            f"src, dst, mask must be 1-D of one length: {tuple(src.shape)}, "
            f"{tuple(dst.shape)}, {tuple(mask.shape)}")
    if labels.dim() != 1 or (src.numel() and labels.numel() == 0):
        raise ValueError(f"labels must be 1-D and non-empty, got "
                         f"{tuple(labels.shape)}")
    if src.dtype != INT or dst.dtype != INT or labels.dtype != INT:
        raise TypeError(f"src/dst/labels must be int32, got {src.dtype}/"
                        f"{dst.dtype}/{labels.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if len({t.device for t in (src, dst, mask, labels)}) != 1:
        raise ValueError("src, dst, mask and labels must share one device")
    if not all(t.is_contiguous() for t in (src, dst, mask, labels)):
        raise ValueError("src, dst, mask and labels must be contiguous")
    check_key_space(src.shape[0], num_segments)
    if kernel_path(src.device) == "cuda":
        return boruvka_round_cuda(src, dst, mask, labels, num_segments)
    return boruvka_round_ref(src, dst, mask, labels, num_segments)
