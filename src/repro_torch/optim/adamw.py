"""AdamW with mixed precision and ZeRO-1 state specs, ported from
``src/repro/optim/adamw.py``.

Params may be bfloat16; the state keeps float32 master weights and
moments per leaf. Every function is pure: it returns new tensors and
writes none in place (a float32 param and its new master may be one
tensor), unless ``adamw_update`` is told that its state and params are
donated. The update is dense, as the reference's is: every element of
every leaf, untouched table rows included, decays and moves each step.

A partition spec here is a tuple with one entry per dimension: ``None``,
a mesh axis name or a tuple of names (``jax.sharding.PartitionSpec``'s
entries, so ``tuple(P("data", None)) == ("data", None)``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


#: elements a donated update computes at once (64 MB of float32 a
#: temporary)
DONATED_CHUNK = 1 << 24


def adamw_init(params) -> dict:
    """The optimizer state of ``params``: ``step`` int32 0, float32
    ``master`` copies and zero ``m``, ``v``, on each param's device."""
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"step": step,
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                          params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed in ``jax.tree.leaves``' order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + (x.float() ** 2).sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0, *,
                 donate: bool = False, grad_norm=None):
    """Returns (new_params, new_state, metrics); ``grads`` may be bfloat16,
    the arithmetic is float32. ``metrics`` holds ``grad_norm`` (before the
    clip) and ``lr`` (``cfg.lr * lr_scale``). ``grad_norm``, when given,
    is the norm the clip uses in place of ``global_norm(grads)``: the norm
    of the whole gradient where ``grads`` is one rank's part of it (a
    pipeline stage's layers).

    With ``donate`` the state's ``master``, ``m`` and ``v`` and the params
    (each contiguous) are consumed, as buffers donated to a jitted step
    are: the new values are written into the given tensors,
    ``DONATED_CHUNK`` elements at a time, and those tensors are returned.
    The update is elementwise, so the bits are the pure update's; the
    memory is one copy of the state and a few chunks of temporaries,
    instead of two copies and a leaf's temporaries (a 3.1 G-parameter
    state is 37 GB, one expert leaf's temporaries about 25 GB)."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / gn.clamp_min(1e-9), max=1.0)
    # float32 powers, as the reference's b1 ** step.astype(float32)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    lr = cfg.lr * lr_scale

    def upd(g, m, v, mw):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        mw = mw - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * mw)
        return m, v, mw

    leaves = zip(*(tree_leaves(t) for t in (grads, state["m"], state["v"],
                                            state["master"])))
    if donate:
        for (g, *old), p in zip(leaves, tree_leaves(params)):
            g, p = g.reshape(-1), p.view(-1)
            old = [t.view(-1) for t in old]
            for at in range(0, g.numel(), DONATED_CHUNK):
                part = slice(at, at + DONATED_CHUNK)
                new = upd(g[part], *(t[part] for t in old))
                for dst, val in zip(old, new):
                    dst[part].copy_(val)
                p[part].copy_(new[2])
        new_params = params
        new_state = {"step": step, "master": state["master"],
                     "m": state["m"], "v": state["v"]}
    else:
        out = [upd(*leaf) for leaf in leaves]
        m, v, mw = (tree_unflatten(params, [o[i] for o in out])
                    for i in range(3))
        new_params = tree_map(lambda w, p: w.to(p.dtype), mw, params)
        new_state = {"step": step, "master": mw, "m": m, "v": v}
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gn.device)
    return new_params, new_state, {"grad_norm": gn, "lr": lr}


def _is_spec(x) -> bool:
    """A partition spec: a tuple whose entries are None, names or tuples of
    names (a tuple of specs, or of trees, is not one)."""
    return isinstance(x, tuple) and all(
        p is None or isinstance(p, str)
        or (isinstance(p, tuple) and all(isinstance(a, str) for a in p))
        for p in x)


def zero1_specs(param_specs, dp_axis: str = "data", params_shapes=None,
                dp_size: int | None = None) -> dict:
    """ZeRO-1 sharding of the optimizer state: each leaf's spec with
    ``dp_axis`` on its first unsharded dim whose size divides evenly over
    the data axis (the moments and master are read and written only inside
    the update, so sharding them over ``data`` costs no bandwidth).

    ``params_shapes`` (a tree of the params, or of their shapes) with
    ``dp_size`` makes the choice divisibility-aware; without them the
    first free dim is used. A spec with no free dim stays as it is."""

    def add_dp(spec: tuple, shape=None) -> tuple:
        parts = list(spec)
        for i, p in enumerate(parts):
            if p is not None:
                continue
            if shape is not None and dp_size is not None and shape[i] % dp_size:
                continue  # not divisible: try the next free dim
            parts[i] = dp_axis
            return tuple(parts)
        return spec  # nothing shardable

    def walk(spec, shapes):
        if _is_spec(spec):
            return add_dp(spec, None if shapes is None
                          else tuple(getattr(shapes, "shape", shapes)))
        if isinstance(spec, dict):
            return {k: walk(v, None if shapes is None else shapes[k])
                    for k, v in spec.items()}
        return type(spec)(walk(v, None if shapes is None else shapes[i])
                          for i, v in enumerate(spec))

    state_spec = walk(param_specs, params_shapes)
    return {"step": (), "master": state_spec, "m": state_spec,
            "v": state_spec}
