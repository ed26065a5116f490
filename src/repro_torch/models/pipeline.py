"""GPipe pipeline parallelism over a ``pipe`` mesh axis, ported from
``src/repro/models/pipeline.py``.

The layers are stacked [L, ...] as usual; ``stageify_params`` reshapes
them to [n_stages, L/S, ...], and each rank holds its stage's block [1,
L/S, ...] of every layer leaf (the block ``shard_map`` hands a device),
with ``embed`` and ``final_norm`` whole. The mesh is a ``DeviceMesh`` with
the ``pipe`` axis and, where the caller gives them, data axes
(``par.dp_axes``); a tensor-parallel axis inside a stage is not ported.

The global batch comes split into ``n_micro`` microbatches that stream
through the stages over T = n_micro + S - 1 ticks, as in the reference's
``lax.scan``: at tick t, stage s runs microbatch t - s, stage 0 embedding
it (``jnp.take``'s fill mode) and the others taking the activation block
stage s - 1 sent at tick t - 1. The reference's one ``lax.ppermute`` a tick
is ``dist.batch_isend_irecv`` between the stage ranks of one data
coordinate, inside an autograd function whose backward sends the
cotangent back the other way. Where the reference computes a stage on the
zeros it holds before the first microbatch arrives or after the last has
left, and masks the result out, the port skips the work and the send: the
loss and the gradients are the same.

Only the last stage's cross entropy counts, for its ticks t >= S - 1,
summed over the pipe group and divided by n_micro. The aux loss adds only
the last stage's layers' aux, as the reference's does (``lm_loss`` sums
every layer's). The data axes are split by hand: each data rank takes its
``mb / data`` rows of every microbatch, and the cross entropy is averaged
over the data group. The gradient is the reference's ``jax.grad``: a
layer leaf's is summed over the data group, ``embed``'s and
``final_norm``'s over the pipe and data groups, both reductions made once
the backward pass has run to its end on the rank (so that no rank waits in
a reduction while a neighbour waits for its cotangent).

A mixture-of-experts config raises ``NotImplementedError``: its mesh
branch carries no gradient (training over a mesh is ROADMAP queue A 11.6).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.graph.datastructs import take_fill
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import chunked_cross_entropy, rms_norm
from repro_torch.models.transformer import LMConfig, Parallelism
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_micro: int  # microbatches streamed per step (>= n_stages to fill)
    pipe_axis: str = "pipe"


def stage_param_specs(cfg: LMConfig, par: Parallelism, pp: PipelineConfig):
    """Partition specs (the port's tuple form) with the stacked layer dim
    read as [n_stages over ``pipe``, L/n_stages, ...]."""
    base = tfm.param_specs(cfg, par)
    layers = {k: (pp.pipe_axis, *v) for k, v in base["layers"].items()}
    return {"embed": base["embed"], "final_norm": base["final_norm"],
            "layers": layers}


def stageify_params(params: dict, n_stages: int, stage: int | None = None):
    """[L, ...] stacked layer params -> [n_stages, L/S, ...]; with
    ``stage``, that stage's block [1, L/S, ...] only (a copy, so the rest
    of the stack can be freed)."""
    def re(x):
        l = x.shape[0]
        if l % n_stages:
            raise AssertionError((l, n_stages))
        x = x.reshape(n_stages, l // n_stages, *x.shape[1:])
        return x if stage is None else x[stage:stage + 1].clone()

    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": tree_map(re, params["layers"])}


@dataclasses.dataclass(frozen=True)
class _Topology:
    """This rank's place on the mesh: its stage, the global ranks of the
    stages before and after it in its data coordinate, its block of a
    microbatch's rows, and the groups the gradients are summed over."""

    stage: int
    prev: int | None
    next: int | None
    data_index: int
    data_size: int
    pipe_group: object
    data_groups: tuple

    @staticmethod
    def of(par: Parallelism, pp: PipelineConfig) -> _Topology:
        mesh = par.mesh
        if mesh is None:
            if pp.n_stages != 1:
                raise ValueError(f"{pp.n_stages} stages need a mesh with a "
                                 f"{pp.pipe_axis!r} axis")
            return _Topology(0, None, None, 0, 1, None, ())
        names = tuple(mesh.mesh_dim_names)
        pi = names.index(pp.pipe_axis)
        if mesh.size(pi) != pp.n_stages:
            raise ValueError(f"the {pp.pipe_axis!r} axis has {mesh.size(pi)}"
                             f" ranks for {pp.n_stages} stages")
        dp = tuple(a for a in (par.dp_axes or ()) if a in names)
        for i, a in enumerate(names):
            if a != pp.pipe_axis and a not in dp and mesh.size(i) > 1:
                raise ValueError(f"mesh axis {a!r}: only the pipe and data "
                                 f"axes are ported")
        coord = list(mesh.get_coordinate())
        ranks = mesh.mesh
        stage = coord[pi]

        def rank_at(s):
            if not 0 <= s < pp.n_stages:
                return None
            at = list(coord)
            at[pi] = s
            return int(ranks[tuple(at)])

        index, size = 0, 1
        for a in dp:
            i = names.index(a)
            index, size = index * mesh.size(i) + coord[i], size * mesh.size(i)
        groups = tuple(mesh.get_group(a) for a in dp
                       if mesh.size(names.index(a)) > 1)
        return _Topology(stage, rank_at(stage - 1),
                         rank_at(stage + 1), index, size,
                         mesh.get_group(pp.pipe_axis)
                         if pp.n_stages > 1 else None, groups)

    @property
    def all_groups(self) -> tuple:
        """The pipe group (if more than one stage), then the data groups:
        a sum over them is a sum over every rank."""
        pipe = () if self.pipe_group is None else (self.pipe_group,)
        return pipe + self.data_groups


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _Exchange(torch.autograd.Function):
    """One tick's boundary crossing: ``y`` to the next stage (when
    ``send_to``), a block of ``shape`` from the previous one (when
    ``recv_from``). Returns (the received block, or an empty tensor; a zero
    anchor that the loss adds, so that the backward pass visits every
    crossing). The backward sends the received block's cotangent back to
    the previous stage and takes ``y``'s from the next."""

    @staticmethod
    def forward(ctx, y, send_to, recv_from, shape, tag):
        ctx.send_to, ctx.recv_from, ctx.tag = send_to, recv_from, tag
        ctx.y_meta = (y.shape, y.dtype, y.device)
        ops, buf = [], y.new_empty(0)
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), send_to,
                                  tag=tag))
        if recv_from is not None:
            buf = y.new_empty(shape)
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, tag=tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return buf, y.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g_buf, g_anchor):
        ops, g_y = [], None
        if ctx.recv_from is not None:
            ops.append(dist.P2POp(dist.isend, g_buf.contiguous(),
                                  ctx.recv_from, tag=ctx.tag))
        if ctx.send_to is not None:
            shape, dtype, device = ctx.y_meta
            g_y = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, g_y, ctx.send_to, tag=ctx.tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return g_y, None, None, None, None


class _GradSync(torch.autograd.Function):
    """The identity on the param leaves whose backward sums each leaf's
    gradient over its groups (``groups[i]`` for leaf i). The sums run as
    the backward pass's final callback, once every crossing of this rank
    has sent and received its cotangent."""

    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        out = [g.clone() for g in grads]

        def reduce():
            for g, groups in zip(out, ctx.groups):
                _all_reduce(g, groups)

        torch.autograd.Variable._execution_engine.queue_callback(reduce)
        return (None, *out)


class _GroupSum(torch.autograd.Function):
    """Forward: ``x`` summed over ``groups``. Backward: the identity (each
    rank seeds its own part of the sum)."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _is_layer_leaf(params) -> list:
    """Per leaf of ``params`` in ``tree_leaves``' order: is it a layer
    leaf (a stage's own), or ``embed``/``final_norm`` (whole everywhere)?"""
    kinds = tree_map(lambda _: False, params)
    kinds["layers"] = tree_map(lambda _: True, params["layers"])
    return tree_leaves(kinds)


def _synced(params, topo: _Topology):
    """``params`` through ``_GradSync``: layer leaves summed over the data
    groups, ``embed`` and ``final_norm`` over the pipe and data groups."""
    if not topo.all_groups:
        return params
    groups = tuple(topo.data_groups if layer else topo.all_groups
                   for layer in _is_layer_leaf(params))
    leaves = _GradSync.apply(groups, *tree_leaves(params))
    return tree_unflatten(params, list(leaves))


def make_pp_loss_fn(cfg: LMConfig, par: Parallelism, pp: PipelineConfig):
    """Returns ``loss(params, batch)`` running the GPipe schedule on this
    rank; every rank returns the same float32 scalar.

    params: ``embed``, ``final_norm`` and this rank's stage block of the
    layers (``stageify_params(params, S, stage)``). batch: ``{"tokens":
    int[n_micro, mb, S+1]}``, the whole batch on every rank (``mb`` is the
    per-microbatch global rows; the data axes split it).
    """
    if cfg.moe is not None:
        raise NotImplementedError(
            "a pipeline over a mixture of experts: the MoE mesh branch "
            "carries no gradient (ROADMAP queue A 11.6)")
    n_stages, n_micro = pp.n_stages, pp.n_micro
    if cfg.n_layers % n_stages:
        raise AssertionError((cfg.n_layers, n_stages))
    stage_cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers // n_stages)
    local_par = Parallelism.none()
    layer = tfm._make_layer_fn(stage_cfg, local_par, decode=False)

    def loss_fn(params, batch):
        topo = _Topology.of(par, pp)
        s, last = topo.stage, n_stages - 1
        embed = params["embed"]
        tokens = tfm.token_ids(batch["tokens"], embed.device)
        nm, mb = tokens.shape[:2]
        if nm != n_micro or mb % topo.data_size:
            raise ValueError(f"tokens {tuple(tokens.shape)}: {n_micro} "
                             f"microbatches of rows a multiple of "
                             f"{topo.data_size}")
        rows = mb // topo.data_size
        tokens = tokens[:, topo.data_index * rows:(topo.data_index + 1)
                        * rows]
        inputs, targets = tokens[:, :, :-1], tokens[:, :, 1:]
        seq = inputs.shape[2]
        params = _synced(params, topo)
        embed, final_norm = params["embed"], params["final_norm"]
        for key, val in params["layers"].items():
            if val.shape[0] != 1 or val.shape[1] != stage_cfg.n_layers:
                raise ValueError(f"layers[{key!r}]: shape {tuple(val.shape)}"
                                 f", a stage block is [1, "
                                 f"{stage_cfg.n_layers}, ...]")
        stage = {"layers": {k: v[0] for k, v in params["layers"].items()}}
        positions = tfm._positions(rows, seq, 0, embed.device)
        block = (rows, seq, cfg.d_model)

        zero = torch.zeros((), dtype=torch.float32, device=embed.device)
        loss_sum, aux_sum, anchors = zero, zero, zero
        buf = None
        for t in range(nm + n_stages - 1):
            m = t - s  # the microbatch at this stage on this tick
            y = None
            if 0 <= m < nm:
                # stage 0 embeds microbatch t (m == t there)
                x = (take_fill(embed, inputs[m]).to(cfg.dtype) if s == 0
                     else buf)
                y, aux = tfm._run_layers(stage, x, positions, layer,
                                         stage_cfg)
                if s == last:  # t >= S - 1 here
                    h = rms_norm(y, final_norm)
                    loss_sum = loss_sum + chunked_cross_entropy(
                        h, embed, targets[m], cfg.loss_chunks)
                    aux_sum = aux_sum + aux
            send_to = topo.next if y is not None else None
            recv_from = topo.prev if 0 <= m + 1 < nm else None
            if send_to is None and recv_from is None:
                continue
            if y is None:
                # nothing to send: an empty slice of a param in its place,
                # so that the crossing lies on a path to the params and
                # autograd.grad runs its backward (the received block's
                # cotangent must still go back)
                y = embed[:0]
            buf, anchor = _Exchange.apply(y, send_to, recv_from, block, t)
            anchors = anchors + anchor
        local = (loss_sum / nm
                 + 0.01 * (aux_sum / max(nm, 1)) / max(cfg.n_layers, 1))
        local = local / topo.data_size + anchors
        if not topo.all_groups:
            return local
        return _GroupSum.apply(local, topo.all_groups)

    return loss_fn


def _pp_grad_norm(par: Parallelism, pp: PipelineConfig):
    """The clip's norm in the pipelined step: the norm of the whole
    gradient, each layer leaf's sum of squares summed over the pipe group
    (``embed`` and ``final_norm`` are whole on every rank), the leaves
    added in ``jax.tree.leaves``' order."""
    def norm(grads):
        topo = _Topology.of(par, pp)
        sq = torch.stack([(g.float() ** 2).sum() for g in tree_leaves(grads)])
        if topo.pipe_group is not None:
            layer = torch.tensor(_is_layer_leaf(grads), device=sq.device)
            part = torch.where(layer, sq, 0)
            dist.all_reduce(part, group=topo.pipe_group)
            sq = torch.where(layer, part, sq)
        total = torch.zeros((), dtype=torch.float32, device=sq.device)
        for v in sq:
            total = total + v
        return torch.sqrt(total)

    return norm


def make_pp_train_step(cfg: LMConfig, par: Parallelism, pp: PipelineConfig,
                       opt_cfg=None, total_steps: int = 10_000,
                       warmup: int = 200):
    """AdamW under the cosine schedule over the pipelined loss's gradient,
    on this rank's params (``embed``, ``final_norm``, its stage block) and
    their state (``adamw_init`` of them); the clip reads the norm of the
    whole gradient, every stage's layers included."""
    from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule

    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_pp_loss_fn(cfg, par, pp)
    grad_norm = _pp_grad_norm(par, pp)

    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        lr_scale = cosine_schedule(opt_state["step"], warmup=warmup,
                                   total=total_steps)
        grads = tree_unflatten(params, grads)
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(
                grads, opt_state, params, opt_cfg, lr_scale,
                grad_norm=grad_norm(grads))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step

