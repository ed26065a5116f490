"""Workload builders, ported from ``src/repro/launch/workloads.py``:
(ArchSpec, shape, mesh) -> a step function, its arguments' stand-ins and
their shardings. The dry run (``launch/dryrun.py``) traces these.

A workload is ``dict(fn, args, in_shardings[, donate_argnums])``:

- ``args`` are fake tensors (``torch._subclasses.FakeTensor``) of the
  global shapes and dtypes, on the mesh's device type: the parameters made
  by the real initializers under ``FakeTensorMode`` (the counterpart of
  ``jax.eval_shape``), the batches as empty tensors. Nothing is allocated.
- ``in_shardings`` mirrors ``args`` with a sanitized partition spec per
  tensor (the port's tuple form: ``None``, an axis name or a tuple of
  names per dimension); ``shardings(mesh, tree)`` turns it into
  ``DTensor`` placements.

The mesh is a ``DeviceMesh`` (``launch/mesh.py``); the fake tensors live
in the active ``FakeTensorMode``, or in this module's own when none is
active.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchSpec
from repro_torch.launch.mesh import dp_axes_for, machine_axes_for, spec_placements
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import Parallelism
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import _is_spec, adamw_init, zero1_specs
from repro_torch.optim.tree import tree_map
from repro_torch.training import (
    make_gnn_train_step,
    make_lm_decode_step,
    make_lm_prefill_step,
    make_lm_train_step,
    make_recsys_steps,
)

_MODE = None


def fake_mode() -> FakeTensorMode:
    """The active ``FakeTensorMode``, else this module's own."""
    global _MODE
    mode = active_fake_mode()
    if mode is None:
        if _MODE is None:
            _MODE = FakeTensorMode(allow_non_fake_inputs=True)
        mode = _MODE
    return mode


def SDS(shape, dtype, device) -> torch.Tensor:
    """A fake tensor of ``shape`` and ``dtype``: ``jax.ShapeDtypeStruct``."""
    with fake_mode():
        return torch.empty(shape, dtype=dtype, device=device)


def sanitize_spec(spec: tuple, mesh) -> tuple:
    """``spec`` with the axes ``mesh`` lacks dropped: a tuple of names left
    empty becomes ``None``, one left with one name that name (as
    ``PartitionSpec`` normalises it)."""
    names = set(mesh.mesh_dim_names)

    def keep(part):
        if part is None:
            return None
        if isinstance(part, (tuple, list)):
            kept = tuple(p for p in part if p in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return part if part in names else None

    return tuple(keep(p) for p in spec)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v) for v in tree)


def sanitized(mesh, spec_tree):
    """A tree of specs, each sanitized for ``mesh``."""
    return _map_specs(lambda s: sanitize_spec(s, mesh), spec_tree)


def shardings(mesh, spec_tree):
    """A tree of specs -> the tree of their ``DTensor`` placements on
    ``mesh``."""
    return _map_specs(lambda s: tuple(spec_placements(
        mesh, sanitize_spec(s, mesh))), spec_tree)


def _eval_shape(fn, *args):
    """``fn(*args)`` under the fake mode: fake tensors of its outputs'
    shapes and dtypes, nothing allocated."""
    with fake_mode():
        return fn(*args)


def _parallelism(mesh) -> Parallelism:
    return Parallelism(mesh=mesh, dp_axes=dp_axes_for(mesh), tp_axis="model")


def _pad_to(x: int, mult: int) -> int:
    """Fixed-capacity buffers pad up to a device-count multiple (the mask
    machinery treats the padding as invalid entries)."""
    return ((x + mult - 1) // mult) * mult


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _replicated(tree):
    return tree_map(lambda _: (), tree)


# -------------------------------------------------------------------- LM
def build_lm_workload(spec: ArchSpec, shape: dict, mesh, *, n_layers=None,
                      analysis=False):
    par = _parallelism(mesh)
    dev = mesh.device_type
    cfg = spec.config
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if analysis:
        cfg = dataclasses.replace(cfg, scan_unroll=True)
    params_sds = _eval_shape(lambda: tfm.init_params(cfg, _gen(), dev))
    pspecs = tfm.param_specs(cfg, par)

    kind = shape["kind"]
    b, s = shape["global_batch"], shape["seq_len"]
    dp_spec = (par.dp_axes, None)
    if kind == "train":
        opt_sds = _eval_shape(adamw_init, params_sds)
        ospecs = zero1_specs(pspecs, dp_axis="data", params_shapes=params_sds,
                             dp_size=mesh.size(
                                 mesh.mesh_dim_names.index("data")))
        step = make_lm_train_step(cfg, par, AdamWConfig())
        batch_sds = {"tokens": SDS((b, s + 1), torch.int32, dev)}
        batch_spec = {"tokens": dp_spec}
        return dict(
            fn=step,
            args=(params_sds, opt_sds, batch_sds),
            in_shardings=(
                sanitized(mesh, pspecs),
                sanitized(mesh, ospecs),
                sanitized(mesh, batch_spec),
            ),
            donate_argnums=(0, 1),
        )
    if kind == "prefill":
        step = make_lm_prefill_step(cfg, par, s_max=s)
        return dict(
            fn=step,
            args=(params_sds, SDS((b, s), torch.int32, dev)),
            in_shardings=(sanitized(mesh, pspecs),
                          sanitize_spec(dp_spec, mesh)),
        )
    if kind == "decode":
        step = make_lm_decode_step(cfg, par)
        cache_sds = _eval_shape(lambda: tfm.init_cache(cfg, b, s, device=dev))
        ck_spec, cv_spec = tfm.cache_specs(cfg, par)
        return dict(
            fn=step,
            args=(params_sds, cache_sds, SDS((b, 1), torch.int32, dev),
                  SDS((), torch.int32, dev)),
            in_shardings=(
                sanitized(mesh, pspecs),
                (sanitize_spec(ck_spec, mesh), sanitize_spec(cv_spec, mesh)),
                sanitize_spec(dp_spec, mesh),
                (),
            ),
            donate_argnums=(1,),
        )
    raise ValueError(kind)


# ------------------------------------------------------------------- GNN
def _gnn_graph_sds(arch, n, e, d_feat, dev):
    g = {
        "src": SDS((e,), torch.int32, dev),
        "dst": SDS((e,), torch.int32, dev),
        "mask": SDS((e,), torch.bool, dev),
    }
    if arch == "egnn":
        g["h"] = SDS((n, d_feat), torch.float32, dev)
        g["x"] = SDS((n, 3), torch.float32, dev)
    else:
        g["feats"] = SDS((n, d_feat), torch.float32, dev)
    return g


def _gnn_graph_specs(arch, machine_axes):
    g = {"src": (machine_axes,), "dst": (machine_axes,),
         "mask": (machine_axes,)}
    if arch == "egnn":
        g["h"] = (None, None)
        g["x"] = (None, None)
    else:
        g["feats"] = (None, None)
    return g


def _gnn_labels(arch, g_sds, g_specs, n, dev):
    """The full-graph targets: egnn's graph-level ``target``, else node
    ``labels`` and ``label_mask``."""
    if arch == "egnn":
        g_sds["target"] = SDS((1,), torch.float32, dev)
        g_specs["target"] = (None,)
    else:
        g_sds["labels"] = SDS((n,), torch.int32, dev)
        g_sds["label_mask"] = SDS((n,), torch.bool, dev)
        g_specs["labels"] = (None,)
        g_specs["label_mask"] = (None,)


def build_gnn_workload(spec: ArchSpec, shape: dict, mesh, *, n_layers=None,
                       analysis=False):
    par = _parallelism(mesh)
    dev = mesh.device_type
    machines = machine_axes_for(mesh)
    arch = spec.config.arch
    kind = shape["kind"]

    def config(d_feat, n_classes, **kw):
        cfg = gnn_mod.GNNConfig(
            name=spec.config.name, arch=arch, n_layers=spec.config.n_layers,
            d_hidden=spec.config.d_hidden, d_feat=d_feat,
            n_classes=n_classes, pna_delta=spec.config.pna_delta, **kw)
        return dataclasses.replace(
            cfg, n_layers=(n_layers if n_layers is not None else cfg.n_layers),
            scan_unroll=analysis)

    def workload(cfg, batch_sds, batch_specs, mode):
        params_sds = _eval_shape(lambda: gnn_mod.init_gnn(cfg, _gen(), dev))
        opt_sds = _eval_shape(adamw_init, params_sds)
        return dict(
            fn=make_gnn_train_step(cfg, par, mode=mode),
            args=(params_sds, opt_sds, batch_sds),
            in_shardings=(_replicated(params_sds), _replicated(opt_sds),
                          sanitized(mesh, batch_specs)),
            donate_argnums=(0, 1),
        )

    if kind == "full":
        cfg = config(shape["d_feat"], shape["n_classes"])
        n = shape["n_nodes"]
        e = _pad_to(shape["n_edges"], mesh.size())
        g_sds = _gnn_graph_sds(arch, n, e, shape["d_feat"], dev)
        g_specs = _gnn_graph_specs(arch, machines)
        _gnn_labels(arch, g_sds, g_specs, n, dev)
        return workload(cfg, g_sds, g_specs, "full")

    if kind == "sampled":
        b = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        d = shape["d_feat"]
        cfg = config(d, shape["n_classes"], sample_sizes=(f1, f2))
        dp = par.dp_axes
        if arch == "graphsage":
            # native fanout-tensor mode (the arch's own paper)
            batch_sds = {
                "x0": SDS((b, d), torch.float32, dev),
                "x1": SDS((b, f1, d), torch.float32, dev),
                "x2": SDS((b, f1, f2, d), torch.float32, dev),
                "m1": SDS((b, f1), torch.bool, dev),
                "m2": SDS((b, f1, f2), torch.bool, dev),
                "labels": SDS((b,), torch.int32, dev),
            }
            batch_specs = {k: (dp, *([None] * (v.dim() - 1)))
                           for k, v in batch_sds.items()}
            return workload(cfg, batch_sds, batch_specs, "sampled")
        # sampled-subgraph mode: 2-hop block as a padded edge list
        n_sub = b + b * f1 + b * f1 * f2
        e_sub = _pad_to(b * f1 + b * f1 * f2, mesh.size())
        batch_sds = _gnn_graph_sds(arch, n_sub, e_sub, d, dev)
        batch_specs = _gnn_graph_specs(arch, machines)
        _gnn_labels(arch, batch_sds, batch_specs, n_sub, dev)
        return workload(cfg, batch_sds, batch_specs, "full")

    if kind == "batched":
        g, n, e = shape["batch"], shape["n_nodes"], shape["n_edges"]
        d = shape["d_feat"]
        cfg = config(d, 1)
        dp = par.dp_axes
        per_graph = _gnn_graph_sds(arch, n, e, d, dev)
        graphs = {k: SDS((g,) + tuple(v.shape), v.dtype, dev)
                  for k, v in per_graph.items()}
        batch_sds = {"graphs": graphs,
                     "targets": SDS((g,), torch.float32, dev)}
        gspecs = {k: (dp, *([None] * v.dim())) for k, v in per_graph.items()}
        batch_specs = {"graphs": gspecs, "targets": (dp,)}
        return workload(cfg, batch_sds, batch_specs, "batched")
    raise ValueError(kind)


# ---------------------------------------------------------------- recsys
def build_recsys_workload(spec: ArchSpec, shape: dict, mesh, *, n_layers=None,
                          analysis=False):
    """``analysis`` has nothing to unroll here: the port's SASRec loops in
    eager PyTorch (``SASRecConfig`` has no ``scan_unroll``)."""
    par = _parallelism(mesh)
    dev = mesh.device_type
    cfg = spec.config
    params_sds = _eval_shape(lambda: rec_mod.init_sasrec(cfg, _gen(), dev))
    pspecs = rec_mod.param_specs(cfg, par)
    steps = make_recsys_steps(cfg, par)
    dp = par.dp_axes
    kind = shape["kind"]
    b = shape["batch"]
    s = cfg.seq_len

    if kind == "train":
        opt_sds = _eval_shape(adamw_init, params_sds)
        ospecs = zero1_specs(pspecs, dp_axis="data", params_shapes=params_sds,
                             dp_size=mesh.size(
                                 mesh.mesh_dim_names.index("data")))
        batch_sds = {k: SDS((b, s), torch.int32, dev)
                     for k in ("seq", "pos", "neg")}
        batch_specs = {k: (dp, None) for k in batch_sds}
        return dict(
            fn=steps["train"],
            args=(params_sds, opt_sds, batch_sds),
            in_shardings=(
                sanitized(mesh, pspecs),
                sanitized(mesh, ospecs),
                sanitized(mesh, batch_specs),
            ),
            donate_argnums=(0, 1),
        )
    if kind in ("serve", "bulk"):
        return dict(
            fn=steps[kind],
            args=(params_sds, SDS((b, s), torch.int32, dev)),
            in_shardings=(sanitized(mesh, pspecs),
                          sanitize_spec((dp, None), mesh)),
        )
    if kind == "retrieval":
        c = _pad_to(shape["n_candidates"], mesh.size())
        machines = machine_axes_for(mesh)
        return dict(
            fn=steps["retrieval"],
            args=(
                params_sds,
                SDS((b, s), torch.int32, dev),
                SDS((b, s), torch.bool, dev),
                SDS((c,), torch.int32, dev),
            ),
            in_shardings=(
                sanitized(mesh, pspecs),
                (),
                (),
                # candidates sharded over every device: scores [B, C/devices]
                sanitize_spec((machines,), mesh),
            ),
        )
    raise ValueError(kind)


# ---------------------------------------------------------------- bridges
def build_bridges_workload(spec: ArchSpec, shape: dict, mesh, *,
                           n_layers=None, analysis=False):
    from repro_torch.core.merge import build_distributed_bridges_fn
    from repro_torch.core.partition import shard_capacity

    machines = machine_axes_for(mesh)
    m = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in machines)
    n, e = shape["n_nodes"], shape["n_edges"]
    cap = shard_capacity(e, m)
    cfg = spec.config
    fn = build_distributed_bridges_fn(
        mesh, machines, n, schedule=cfg.schedule, final=cfg.final,
        merge=getattr(cfg, "merge", "recertify"),
    )
    dev = mesh.device_type
    args = (SDS((m, cap), torch.int32, dev), SDS((m, cap), torch.int32, dev),
            SDS((m, cap), torch.bool, dev))
    sh = sanitize_spec((machines, None), mesh)
    return dict(fn=_machine_rows(fn, mesh, sh), args=args,
                in_shardings=(sh, sh, sh))


def _machine_rows(program, mesh, spec):
    """The per-rank ``program(src, dst, mask)`` of one machine's row over
    ``[M, cap]`` ``DTensor``s split by ``spec`` (the reference's
    ``shard_map``): each rank runs it on its own row, and its result
    buffers are the rows of ``DTensor``s of [M, ...]."""
    pl = spec_placements(mesh, spec)

    def fn(src, dst, mask):
        out = program(*(t.to_local()[0] for t in (src, dst, mask)))
        outs = out if isinstance(out, tuple) else (out,)
        rows = tuple(DTensor.from_local(o[None], mesh, pl, run_check=False)
                     for o in outs)
        return rows if isinstance(out, tuple) else rows[0]

    return fn


BUILDERS = {
    "lm": build_lm_workload,
    "gnn": build_gnn_workload,
    "recsys": build_recsys_workload,
    "graph": build_bridges_workload,
}


def build_workload(spec: ArchSpec, shape_name: str, mesh, *, n_layers=None,
                   analysis=False):
    if shape_name in spec.skips:
        raise ValueError(f"skipped shape: {spec.skips[shape_name]}")
    return BUILDERS[spec.family](
        spec, spec.shapes[shape_name], mesh, n_layers=n_layers,
        analysis=analysis)
