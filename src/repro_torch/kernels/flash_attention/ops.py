"""Public flash_attention op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    DTYPES,
    HEAD_DIMS,
    Q_TILE,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_min.ops import kernel_path

__all__ = ["attention_bytes", "attention_flops", "flash_attention",
           "kernel_path"]


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs one head scores: every pair, or under causal
    masking those with key <= query + (skv - sq)."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(max(0, min(skv, r + off + 1)) for r in range(sq))


def attention_flops(b: int, sq: int, skv: int, hq: int, d: int,
                    causal: bool) -> int:
    """Operations of the two products (scores and output): 2 * d each per
    visible pair and query head."""
    return 4 * d * b * hq * visible_pairs(sq, skv, causal)


def attention_bytes(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                    itemsize: int) -> int:
    """Bytes one call must move: q, k and v read once and out written
    once."""
    return itemsize * d * b * (2 * sq * hq + 2 * skv * hkv)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] (the JAX layout), one
    dtype, Hq a multiple of Hkv -> [B, Sq, Hq, D] in q's dtype. Sq may
    differ from Skv: causal masking aligns the last query row with the last
    key. Semantics of ``ref.attention_ref``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, Hq, D] and k, v one shape "
                         f"[B, Skv, Hkv, D]: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype.is_floating_point):
        raise TypeError(f"q, k, v must share one float dtype: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")
    scale = (d ** -0.5) if scale is None else float(scale)
    if kernel_path(q.device) == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"the kernel takes head sizes {HEAD_DIMS}, "
                             f"got {d}")
        if q.dtype not in DTYPES:
            raise TypeError(f"the kernel takes {list(DTYPES)}, got {q.dtype}")
        if -(-sq // Q_TILE) > 65535:
            raise ValueError(f"{sq} query rows exceed the kernel's grid")
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale)
    return attention_ref(q, k, v, causal=causal, scale=scale)
