"""Shared model layers of the port (``src/repro/models/layers.py``):
RMSNorm, RoPE, the chunked causal attention of training and prefill, the
dense attention of decode against a KV cache, SwiGLU, the chunked cross
entropy, and ``shard``.

Everything accumulates in float32 and stores in the input's dtype. The
constants are the JAX layer's (-1e30 for a masked score, 1e-30 as the
least denominator, ``eps`` 1e-6, ``theta`` 1e6): these functions are not
kernels, and follow the layer, not the flash-attention oracle.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def shard(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The identity. In the reference this is ``with_sharding_constraint``,
    a hint that GSPMD should lay ``x`` out by ``spec`` on the active mesh.
    The port has no global array: a rank computes on its local tensor,
    whose layout its code already chose, so there is nothing to constrain.
    ``spec`` is a partition spec in the port's tuple form (one entry per
    dimension: ``None``, an axis name or a tuple of names)."""
    return x


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_freq(dh: int, theta: float = 1e6, device=None) -> torch.Tensor:
    """float32[dh // 2]: ``theta ** (-arange(half) / half)`` with the bits
    the jitted reference computes. XLA folds the division by the constant
    ``half`` into a product with its float32 reciprocal (for a ``half``
    that is no power of two, d_head 160's 80, 15 of its 80 exponents then
    differ by an ulp from a true division, and JAX's own eager and jitted
    ``rope`` disagree by 1e-3 at position 32,767), and its float32 power is
    correctly rounded: the exponent is that product in float32, the power
    is taken in float64 and rounded once. The same bits on every device."""
    half = dh // 2
    inv = float(np.float32(1) / np.float32(half))  # float32's reciprocal
    expo = torch.arange(half, dtype=torch.float32, device=device) * -inv
    return torch.pow(float(theta), expo.double()).float()


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> tuple:
    """q, k: [..., S, H, Dh]; positions: int[..., S] (broadcastable)."""
    freq = rope_freq(q.shape[-1], theta, q.device)
    ang = positions[..., None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


# static-triangle threshold: below this many chunks the (i, j <= i) block
# triangle is one loop with only the diagonal block masked; above it the
# JAX package either loops over the triangle with absolute-position masks
# (inference) or scans every key chunk with a full mask (training, since
# reverse-mode AD cannot cross a dynamic loop bound). In eager PyTorch all
# three are plain loops; the branches are kept so that each matches its JAX
# counterpart's arithmetic.
_MAX_STATIC_CHUNKS = 8


def _attn_block(qi, kj, vj, m, l, acc, g, mask=None):
    """One (q-chunk x k-chunk) online-softmax block update.

    qi: [B, qc, Hq, Dh] (pre-scaled by dh^-0.5); kj, vj: [B, kc, Hkv, Dh];
    m, l: [B, qc, Hq]; acc: [B, qc, Hq, Dh]; mask: bool[qc, kc] or None.
    GQA repeats each kv head ``g`` times (``jnp.repeat``).
    """
    if g > 1:
        kj = kj.repeat_interleave(g, dim=2)  # [B, kc, Hq, Dh]
        vj = vj.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bqhk", qi, kj)  # [B, qc, Hq, kc]
    if mask is not None:
        logits = torch.where(mask[None, :, None, :], logits, -1e30)
    m_cur = torch.maximum(m, logits.amax(-1))
    alpha = torch.exp(m - m_cur)
    p = torch.exp(logits - m_cur[..., None])
    l_cur = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vj)
    return m_cur, l_cur, acc


def chunked_causal_attention(q, k, v, chunk: int = 1024, unroll: bool = False,
                             differentiable: bool = True):
    """Online-softmax causal attention without the S x S score matrix.

    q: [B, S, Hq, Dh]; k, v: [B, S, Hkv, Dh] -> [B, S, Hq, Dh] in q's dtype.
    With ``nch = S // chunk`` chunks: at most ``_MAX_STATIC_CHUNKS`` (or
    ``unroll``) the block triangle with a mask on the diagonal block only;
    above it and not ``differentiable`` the same triangle with
    absolute-position masks; else every key chunk for every query with a
    full causal mask. The dh^-0.5 scale is folded into q once.
    """
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    nch = max(s // chunk, 1)
    chunk = s // nch
    qf = (q.float() * (dh ** -0.5)).reshape(b, nch, chunk, hq, dh)
    kc = k.float().reshape(b, nch, chunk, hkv, dh)
    vc = v.float().reshape(b, nch, chunk, hkv, dh)
    pos = torch.arange(chunk, device=q.device)
    diag_mask = pos[None, :] <= pos[:, None]  # intra-block causal [qc, kc]

    def init(rows):
        return (torch.full((b, rows, hq), -1e30, device=q.device),
                torch.zeros((b, rows, hq), device=q.device),
                torch.zeros((b, rows, hq, dh), device=q.device))

    if unroll or nch <= _MAX_STATIC_CHUNKS:
        outs = []
        for i in range(nch):
            qi = qf[:, i]
            m, l, acc = init(chunk)
            for j in range(i):  # off-diagonal: fully visible, no mask
                m, l, acc = _attn_block(qi, kc[:, j], vc[:, j], m, l, acc, g)
            m, l, acc = _attn_block(qi, kc[:, i], vc[:, i], m, l, acc, g,
                                    mask=diag_mask)
            outs.append(acc / l[..., None].clamp_min(1e-30))
        return torch.stack(outs, dim=1).reshape(b, s, hq, dh).to(q.dtype)

    if not differentiable:
        # the triangle, each block under its absolute-position mask
        outs = []
        for i in range(nch):
            m, l, acc = init(chunk)
            for j in range(i + 1):
                msk = (j * chunk + pos)[None, :] <= (i * chunk + pos)[:, None]
                m, l, acc = _attn_block(qf[:, i], kc[:, j], vc[:, j], m, l,
                                        acc, g, mask=msk)
            outs.append(acc / l[..., None].clamp_min(1e-30))
        return torch.stack(outs, dim=1).reshape(b, s, hq, dh).to(q.dtype)

    # every key chunk for every query row, under the full causal mask
    q_pos = torch.arange(s, device=q.device)
    qfull = qf.reshape(b, s, hq, dh)
    m, l, acc = init(s)
    for j in range(nch):
        mask = (j * chunk + pos)[None, :] <= q_pos[:, None]  # [S, chunk]
        m, l, acc = _attn_block(qfull, kc[:, j], vc[:, j], m, l, acc, g,
                                mask=mask)
    return (acc / l[..., None].clamp_min(1e-30)).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len):
    """Short-q attention against a long KV cache, dense scores.

    q: [B, Sq, Hq, Dh]; caches: [B, Smax, Hkv, Dh]; ``valid_len`` (an int
    or a 0-d tensor) the valid positions after this step: query i sits at
    absolute position ``valid_len - Sq + i`` and sees the cache rows at or
    before it. Scores are [B, Sq, Hkv, g, Smax] in float32, the dh^-0.5
    scale applied to them after the product, as in the reference.
    """
    b, sq, hq, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qf,
                          k_cache.float()) * dh ** -0.5
    kv_pos = torch.arange(smax, device=q.device)
    q_pos = valid_len - sq + torch.arange(sq, device=q.device)
    mask = kv_pos[None, :] <= q_pos[:, None]  # [Sq, Smax]
    logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    out = out / p.sum(-1)[..., None].clamp_min(1e-30)
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def swiglu(x, w_gate, w_in, w_out):
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def _chunk_loss(xi, ti, embed):
    """Summed cross entropy of one chunk: xi [B, c, D], ti int[B, c]. A
    target outside ``[0, V)`` (after wrapping ``[-V, -1]``) reads a NaN
    logit, as ``take_along_axis``'s fill mode does."""
    logits = xi.float() @ embed.float().T  # [B, c, V]
    v = logits.shape[-1]
    wrapped = torch.where(ti < 0, ti + v, ti).long()
    gold = logits.gather(-1, wrapped.clamp(0, v - 1)[..., None])[..., 0]
    gold = torch.where((wrapped >= 0) & (wrapped < v), gold, float("nan"))
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(x, embed, targets, n_chunks: int = 8):
    """Mean cross entropy without the [B, S, V] logits: S in chunks.

    x: [B, S, D] final hidden states; embed: [V, D] (tied head); targets:
    int[B, S]. Each chunk's [B, S/c, V] logits live only inside its
    checkpointed loss, recomputed in the backward pass (``jax.checkpoint``
    in the reference); the chunks' sums add in order.
    """
    b, s, d = x.shape
    n_chunks = min(n_chunks, s)
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        tot = tot + checkpoint(_chunk_loss, x[:, i * c:(i + 1) * c],
                               targets[:, i * c:(i + 1) * c], embed,
                               use_reentrant=False)
    return tot / (b * s)
