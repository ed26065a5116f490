"""Plain PyTorch version of flash_attention (the kernel's contract): the
JAX package's ``attention_ref``, causal and grouped-query attention in
float32."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]; Hq % Hkv == 0. Causal
    masking aligns the last query row with the last key; masked scores are
    -inf, so a row that sees no key is NaN. Float32 math, output in q's
    dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, sq, hkv, g, d)
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return out.reshape(b, sq, hq, d).to(q.dtype)
