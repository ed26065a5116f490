"""Public flash_attention op: the Hopper kernel of the dtype for CUDA
tensors (bf16: ``flash_attention_mma``; float32:
``flash_attention_tf32x3``), the plain version for CPU tensors, and nothing
else; and the gate that holds a kernel's output against the plain
version's."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS,
    KERNEL_OF,
    MAX_Q_TILES,
    Q_TILE,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_min.ops import kernel_path

__all__ = ["ATTN_GATES", "attention_bytes", "attention_flops",
           "attention_gate", "flash_attention", "kernel_path"]

#: flash_attention's gate by dtype: every element within ``ulps`` units in
#: the last place of the plain version's value plus ``floor`` times the
#: case's largest |value|, and the relative L2 error under ``rel_l2``. An
#: output row averages thousands of values (|value| ≈ 0.01 at 8,192 keys),
#: so the gate scales with the output: a fixed atol would pass a halved
#: output.
ATTN_GATES = {torch.bfloat16: {"ulps": 2, "floor": 1e-3, "rel_l2": 1e-2},
              torch.float32: {"ulps": 2, "floor": 1e-5, "rel_l2": 1e-4}}


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


def attention_gate(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``got`` against ``want`` under ``ATTN_GATES[want.dtype]``: the max
    abs error, the worst element's error over its limit, the relative L2
    error, and whether all three hold (``got`` finite too)."""
    gate = ATTN_GATES[want.dtype]
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    tiny = torch.finfo(want.dtype).tiny
    ulp = torch.finfo(want.dtype).eps * torch.exp2(
        torch.floor(torch.log2(mag.clamp_min(tiny))))
    limit = gate["ulps"] * ulp + gate["floor"] * float(mag.max())
    worst = float((diff / limit).max())
    rel_l2 = float(diff.norm() / mag.norm())
    return {"max_abs_err": float(diff.max()), "worst_over_limit": worst,
            "rel_l2": rel_l2,
            "pass": bool(torch.isfinite(got).all()) and worst <= 1
            and rel_l2 < gate["rel_l2"]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] (the JAX layout), one
    dtype, Hq a multiple of Hkv -> [B, Sq, Hq, D] in q's dtype. Sq may
    differ from Skv: causal masking aligns the last query row with the last
    key; Skv = 0 raises ``ValueError``, as the JAX oracle does. Semantics
    of ``ref.attention_ref``."""
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
    if k.shape[1] == 0:  # the oracle's max over no keys raises too
        raise ValueError(f"k/v {tuple(k.shape)} hold no keys")
    scale = (d ** -0.5) if scale is None else float(scale)
    if kernel_path(q.device) == "cuda":
        if q.dtype not in KERNEL_OF:
            raise TypeError(f"the kernels take {list(KERNEL_OF)}, got "
                            f"{q.dtype}")
        name = KERNEL_OF[q.dtype]
        if d not in HEAD_DIMS:
            raise ValueError(f"{name} takes head sizes {HEAD_DIMS}, got {d}")
        if -(-sq // Q_TILE) > MAX_Q_TILES:
            raise ValueError(f"{name}'s grid takes at most {MAX_Q_TILES} "
                             f"tiles of {Q_TILE} query rows: {sq} rows")
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale)
    return attention_ref(q, k, v, causal=causal, scale=scale)
