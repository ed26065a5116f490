"""Mixture-of-experts layer with expert parallelism over the model axis,
ported from ``src/repro/models/moe.py``.

Every rank sees the same tokens (activations enter replicated over the
model axis), so every rank computes the same routing and no routing
metadata is exchanged. A rank scatters only the tokens routed to its
E / tp experts into a fixed-capacity [E_local, C, D] buffer, the position
of each (token, choice) inside its expert's queue coming from a column
cumsum over the one-hot assignment (no sort); the expert products run on
that buffer; the outputs are gathered back to their tokens, weighted by
their gates; one all-reduce (SUM) over the model group combines the
ranks' partial outputs.

Capacity drops follow Switch/GShard: the (token, choice) pairs beyond C =
ceil(T·k / E · cf) in an expert's queue are dropped (their gate mass is
lost), and an aux load-balance loss keeps the router near uniform. Every
shape is static. The routing (top-k ids, ranks, the kept mask, C) has the
reference's integers: ties in top-k go to the lower expert, as in
``lax.top_k`` (``models/recsys.py::top_k``).

Without a mesh all experts are local. On a ``DeviceMesh`` with the model
axis a rank is given the whole batch and the full [E, ...] expert weights,
works on its block of the batch (the data axes split it, as the
reference's ``shard_map`` does) and its slice of the experts, and returns
its block of the output; over ``DTensor``s the same body is a
``local_map`` island. Both carry a gradient.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import island, mesh_placements, reduce_over
from repro_torch.models.recsys import top_k


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


def capacity(t: int, cfg: MoEConfig) -> int:
    """C, the slots of each expert's queue for ``t`` tokens: ceil(T·k / E
    · cf), at least one, computed in Python floats as the reference does."""
    return max(int(math.ceil(t * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
          e_start: int, n_local: int) -> dict:
    """The routing of ``moe_ffn_local``: float32 ``probs`` [T, E],
    ``gates`` [T, k] (renormalised), ``ids`` [T, k] (int64, in
    ``lax.top_k``'s order), ``rank`` [T·k] (each (token, choice)'s place in
    its expert's queue), ``kept`` [T·k] (local to this rank and inside the
    capacity), ``cap`` (C) and ``aux`` (E · Σ_e f_e p_e over the first
    choice)."""
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    ids = top_k(probs.detach(), k)[1]
    gates = torch.gather(probs, -1, ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    f = F.one_hot(ids[:, 0], e).float().mean(0)
    aux = e * (f * probs.mean(0)).sum()

    e_flat = ids.reshape(-1)
    onehot = F.one_hot(e_flat, e).to(torch.int32)  # [T·k, E]
    rank = onehot.cumsum(0, dtype=torch.int32).gather(
        1, e_flat[:, None])[:, 0] - 1
    kept = (e_flat >= e_start) & (e_flat < e_start + n_local) & (rank < cap)
    return {"probs": probs, "gates": gates, "ids": ids, "rank": rank,
            "kept": kept, "cap": cap, "aux": aux}


def moe_ffn_local(x_flat, router_w, we_gate, we_in, we_out, *,
                  cfg: MoEConfig, e_start: int, n_local: int) -> tuple:
    """One rank's MoE math. x_flat: [T, D]; ``we_gate``, ``we_in``:
    [E_local, D, F]; ``we_out``: [E_local, F, D]. Returns (out_partial [T,
    D] in x's dtype, float32 aux loss); summed over the ranks, the partials
    are the layer's output.

    The buffer has one writer per kept slot: the dropped and the other
    ranks' pairs all land in the dump row C, which is cut off. A token's k
    contributions are contiguous ((token, choice) pair i belongs to token
    i // k), so the combine is a sum over k, without atomics."""
    t, d = x_flat.shape
    k = cfg.top_k
    r = route(x_flat, router_w, cfg, e_start, n_local)
    cap, kept = r["cap"], r["kept"]
    e_loc = torch.where(kept, r["ids"].reshape(-1) - e_start, 0)
    slot = torch.where(kept, r["rank"], cap).long()
    token_of = torch.arange(t * k, device=x_flat.device) // k

    rows = torch.where(kept[:, None], x_flat[token_of], 0)
    buf = x_flat.new_zeros(n_local, cap + 1, d).index_put(
        (e_loc, slot), rows, accumulate=True)[:, :cap]  # [E_local, C, D]

    h = F.silu(torch.bmm(buf, we_gate)) * torch.bmm(buf, we_in)
    y = torch.bmm(h, we_out)  # [E_local, C, D]

    y_pad = torch.cat([y, y.new_zeros(n_local, 1, d)], dim=1)
    contrib = y_pad[e_loc, slot] * r["gates"].reshape(-1, 1).to(y.dtype)
    contrib = torch.where(kept[:, None], contrib, 0)
    out = contrib.view(t, k, d).sum(1)
    return out.to(x_flat.dtype), r["aux"]


def _dp_block(x, mesh, dp_axes):
    """This rank's block of ``x`` along its first dimension, split over
    the mesh's axes ``dp_axes`` in their order (row-major), as the
    reference's ``P(dp_axes)`` splits it."""
    names = mesh.mesh_dim_names
    index, size = 0, 1
    for a in dp_axes:
        n = mesh.size(names.index(a))
        index, size = index * n + mesh.get_local_rank(a), size * n
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} "
                         f"data-parallel ranks")
    per = x.shape[0] // size
    return x[index * per:(index + 1) * per]


def _axis(mesh, name: str) -> tuple:
    """(this rank's index on ``name``, the axis's size, its group)."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.get_local_rank(name), mesh.size(i), mesh.get_group(name)


def make_moe_layer(mesh, dp_axes, tp_axis, cfg: MoEConfig):
    """``moe(x [B, S, D], router_w, we_gate, we_in, we_out) -> (y, aux)``.

    Without a mesh (or on one without ``tp_axis``) the layer runs with
    every expert local. On a ``DeviceMesh`` it is the reference's
    ``shard_map``: a rank takes experts [r·E/tp, (r+1)·E/tp) for its index
    r on ``tp_axis`` and its block of x's batch over the mesh's axes of
    ``dp_axes`` (in their order, as ``P(dp_axes)`` splits it); its partial
    output is summed over the model group and it returns its block [B /
    dp, S, D]; aux is averaged over the model group, then over each data
    axis in turn. ``DTensor`` arguments (x batch-sharded, the experts
    sharded over ``tp_axis``) run it as a ``local_map`` island and give
    ``DTensor``s; plain tensors are the whole batch and the full [E, ...]
    experts on every rank, and give the rank's block.

    The island carries a gradient. Its sums have the identity as their
    backward (``models/layers.py::reduce_over``), so a rank's gradients are
    its parts: x's summed over the model group, the router's over every
    rank, an expert's over the data axes give the whole gradient."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or tp_axis not in names:
        def moe_single(x, router_w, we_gate, we_in, we_out):
            b, s, d = x.shape
            out, aux = moe_ffn_local(
                x.reshape(b * s, d), router_w, we_gate, we_in, we_out,
                cfg=cfg, e_start=0, n_local=cfg.n_experts)
            return out.reshape(b, s, d), aux

        return moe_single

    tp = mesh.size(names.index(tp_axis))
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not split over {tp} "
                         f"model ranks")
    n_local = cfg.n_experts // tp
    dp = tuple(a for a in (dp_axes or ()) if a in names)

    def body(x, router_w, we_gate, we_in, we_out):
        rank, _, group = _axis(mesh, tp_axis)
        e0 = rank * n_local
        b, s, d = x.shape
        out, aux = moe_ffn_local(
            x.reshape(b * s, d), router_w, we_gate, we_in, we_out, cfg=cfg,
            e_start=e0, n_local=n_local)
        out = reduce_over(out, [group])
        aux = reduce_over(aux, [group]) / tp
        for a in dp:
            _, size, g = _axis(mesh, a)
            aux = reduce_over(aux, [g]) / size
        return out.reshape(b, s, d), aux

    xs = mesh_placements(mesh, (dp or None, None, None))
    rs = mesh_placements(mesh, (None, None))
    es = mesh_placements(mesh, (tp_axis, None, None))
    ins = (xs, rs, es, es, es)
    grads = (mesh_placements(mesh, (dp or None, None, None),
                             partial=(tp_axis,)),
             mesh_placements(mesh, (None, None), partial=names),
             *(mesh_placements(mesh, (tp_axis, None, None), partial=dp),) * 3)
    sharded = island(body, mesh, ins, grads,
                     (xs, mesh_placements(mesh, ())))

    def moe_sharded(x, router_w, we_gate, we_in, we_out):
        if isinstance(x, DTensor):
            return sharded(x, router_w, we_gate, we_in, we_out)
        rank, _, _ = _axis(mesh, tp_axis)
        e0 = rank * n_local
        return body(_dp_block(x, mesh, dp), router_w,
                    we_gate[e0:e0 + n_local], we_in[e0:e0 + n_local],
                    we_out[e0:e0 + n_local])

    return moe_sharded
