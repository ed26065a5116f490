"""Shared model layers of the port (``src/repro/models/layers.py``): the
chunked causal attention that the JAX package's models use, and ``shard``.

Everything accumulates in float32 and stores in the input's dtype. The
constants are the JAX layer's (-1e30 for a masked score, 1e-30 as the
least denominator): this function is not a kernel, and follows the layer,
not the flash-attention oracle.
"""
from __future__ import annotations

import torch

def shard(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The identity. In the reference this is ``with_sharding_constraint``,
    a hint that GSPMD should lay ``x`` out by ``spec`` on the active mesh.
    The port has no global array: a rank computes on its local tensor,
    whose layout its code already chose, so there is nothing to constrain.
    ``spec`` is a partition spec in the port's tuple form (one entry per
    dimension: ``None``, an axis name or a tuple of names)."""
    return x


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
