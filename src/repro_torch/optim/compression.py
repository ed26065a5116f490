"""Int8 gradient compression with error feedback for the data-parallel
all-reduce, ported from ``src/repro/optim/compression.py``.

Per leaf: an int8 payload and one float32 scale on the wire, the payloads
summed as int32, then one dequantisation by the group's largest scale.
The quantisation error is fed into the next step's gradient (error
feedback). ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.tree import tree_leaves, tree_unflatten


def compress_int8(g: torch.Tensor, err: torch.Tensor | None = None):
    """Per-tensor symmetric int8 quantisation. Returns (q int8, scale f32,
    new_err) where new_err = g - dequant(q) (feed into the next step)."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    amax = gf.abs().max()
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_tree(grads, errs, group=None):
    """Error-feedback compressed all-reduce of a tree of gradients over the
    process group ``group`` (the default group if None): every rank calls
    it with its own gradients and errors (or ``errs=None``) and gets the
    mean gradient, dequantised, in each leaf's dtype, and its new errors.

    The scale is the group's largest (``all_reduce(MAX)``) so that one
    int8 grid holds every rank's payload; the payloads are summed as int32
    (``all_reduce(SUM)``) and divided by the group's size."""
    n = dist.get_world_size(group)

    def one(g, e):
        _, scale, _ = compress_int8(g, e)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        gf = g.float() + (e if e is not None else 0)
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        new_err = gf - q * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.float() * scale / n).to(g.dtype), new_err

    flat_g = tree_leaves(grads)
    flat_e = tree_leaves(errs) if errs is not None else [None] * len(flat_g)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
