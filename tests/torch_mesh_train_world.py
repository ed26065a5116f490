"""One rank of the gloo world that ``tests/test_torch_mesh_train.py``
spawns: eight ranks on a (4, 2) ``("data", "model")`` mesh built by the
port's ``launch.mesh.make_test_mesh``, training and serving over
``DTensor`` parameters.

From the ``--inputs`` file the rank takes, for each dense smoke config of
``LM_CASES``, the weights placed by ``param_specs``, an AdamW state placed
by ``zero1_specs`` and the tokens split over ``data``; it computes
``lm_loss``'s gradient and one ``make_lm_train_step`` step, pure and
then donated (from copies of the same params and state). For
``SERVE_CASE`` it runs one prefill and one decode step. For each arch of
``GNN_CASES`` it places the weights and the graph (the edge buffers split
over both axes, the rest replicated) and computes the full-graph loss's
gradient and one ``make_gnn_train_step`` step. Every result is gathered
whole (``full_tensor``), and rank 0 writes them.

    python tests/torch_mesh_train_world.py --rank R --world 8 --store FILE \\
        --inputs FILE --out DIR

Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    adamw_state_from_numpy,
    gnn_params_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.launch.mesh import make_test_mesh, spec_placements  # noqa: E402
from repro_torch.models import gnn as gnn_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import zero1_specs  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.training import (  # noqa: E402
    make_gnn_train_step,
    make_lm_decode_step,
    make_lm_prefill_step,
    make_lm_train_step,
)
from repro_torch.training.steps import over_mesh  # noqa: E402

AXES, SHAPE = ("data", "model"), (4, 2)
LM_CASES = ("qwen3_0_6b", "stablelm_12b", "qwen3_14b")
SERVE_CASE = "qwen3_0_6b"
GNN_CASES = ("graphsage_reddit", "pna", "egnn", "gatedgcn")
#: tokens [B, S + 1]; the serving cache holds S_MAX positions
B, S, S_MAX = 8, 16, 20
#: the train steps' optimizer and schedule (step 5 of 20, warmup 2)
LR, SCHEDULE = 1e-3, {"total_steps": 20, "warmup": 2}


def flat(tree, prefix: str) -> dict:
    """A tree's leaves under ``prefix/<path>`` (dict keys and list
    indices joined by ``/``)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = node

    walk(tree, prefix)
    return out


def unflat(z: dict, prefix: str, like):
    """The tree of ``like``'s structure saved under ``prefix``."""
    if isinstance(like, dict):
        return {k: unflat(z, f"{prefix}/{k}", v) for k, v in like.items()}
    if isinstance(like, list):
        return [unflat(z, f"{prefix}/{i}", v) for i, v in enumerate(like)]
    return z[prefix]


def whole(tree) -> dict:
    """Every ``DTensor`` leaf gathered whole, as numpy."""
    def one(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().float().numpy()

    return tree_map(one, tree)


def place(tree, specs, mesh):
    return tree_map(lambda t, s: distribute_tensor(
        t, mesh, spec_placements(mesh, s), src_data_rank=None), tree, specs)


def grads_of(loss_fn, params):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with over_mesh(leaves):
        loss = loss_fn(tree_unflatten(params, leaves))
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss, tree_unflatten(params, list(grads))


def lm_case(name, z, mesh, par, res) -> None:
    cfg = get(name).smoke_config
    like = tfm.param_shapes(cfg)
    params = lm_params_from_numpy(unflat(z, f"{name}/params", like), cfg,
                                  device="cpu")
    pspecs = tfm.param_specs(cfg, par)
    dparams = place(params, pspecs, mesh)
    tokens = torch.from_numpy(z[f"{name}/tokens"])
    dtok = distribute_tensor(tokens, mesh, spec_placements(
        mesh, (("data",), None)), src_data_rank=None)
    batch = {"tokens": dtok}
    loss, grads = grads_of(lambda p: tfm.lm_loss(p, batch, cfg, par),
                           dparams)
    res[f"{name}/loss"] = loss.detach().numpy()
    res.update(flat(whole(grads), f"{name}/grads"))
    state = adamw_state_from_numpy(
        {"step": z[f"{name}/opt/step"],
         **{k: unflat(z, f"{name}/opt/{k}", like) for k in ("master", "m",
                                                           "v")}},
        params, device="cpu")
    ospecs = zero1_specs(pspecs, "data", params, dp_size=SHAPE[0])
    dstate = {"step": state["step"],
              **{k: place(state[k], ospecs[k], mesh) for k in ("master", "m",
                                                              "v")}}
    step = make_lm_train_step(cfg, par, AdamWConfig(lr=LR), **SCHEDULE)
    new, new_opt, metrics = step(dparams, dstate, batch)
    res.update(flat(whole(new), f"{name}/step/params"))
    for k in ("master", "m", "v"):
        res.update(flat(whole(new_opt[k]), f"{name}/step/opt/{k}"))
    for k, v in metrics.items():
        res[f"{name}/step/{k}"] = whole(v)
    # the donated step from copies of the same params and state
    copy = {"step": dstate["step"].clone(),
            **{k: tree_map(torch.clone, dstate[k]) for k in ("master", "m",
                                                             "v")}}
    donated = make_lm_train_step(cfg, par, AdamWConfig(lr=LR), **SCHEDULE,
                                 donate=True)
    new, new_opt, _ = donated(tree_map(torch.clone, dparams), copy, batch)
    res.update(flat(whole(new), f"{name}/donated/params"))
    for k in ("master", "m", "v"):
        res.update(flat(whole(new_opt[k]), f"{name}/donated/opt/{k}"))
    if name != SERVE_CASE:
        return
    prompt = distribute_tensor(tokens[:, :S], mesh, spec_placements(
        mesh, (("data",), None)), src_data_rank=None)
    logits, cache = make_lm_prefill_step(cfg, par, S_MAX)(dparams, prompt)
    res[f"{name}/prefill/logits"] = whole(logits)
    nxt = distribute_tensor(tokens[:, S:S + 1], mesh, spec_placements(
        mesh, (("data",), None)), src_data_rank=None)
    cspec = tfm.cache_specs(cfg, par)[0]
    cache = tuple(c.redistribute(placements=spec_placements(mesh, cspec))
                  for c in cache)
    logits, cache = make_lm_decode_step(cfg, par)(dparams, cache, nxt, S + 1)
    res[f"{name}/decode/logits"] = whole(logits)
    res[f"{name}/decode/k"] = whole(cache[0])
    res[f"{name}/decode/v"] = whole(cache[1])


def gnn_case(name, z, mesh, par, res) -> None:
    cfg = get(name).smoke_config
    like = gnn_mod.init_gnn(cfg, torch.Generator(), device="meta")
    params = gnn_params_from_numpy(unflat(z, f"{name}/params", like), cfg,
                                   device="cpu")
    rep = [Replicate()] * mesh.ndim
    dparams = tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                    run_check=False), params)
    g = {}
    for key in [k for k in z if k.startswith(f"{name}/graph/")]:
        t = torch.from_numpy(z[key])
        short = key.rsplit("/", 1)[1]
        g[short] = (distribute_tensor(t, mesh, [Shard(0)] * mesh.ndim,
                                      src_data_rank=None)
                    if short in ("src", "dst", "mask") else
                    DTensor.from_local(t, mesh, rep, run_check=False))
    step = make_gnn_train_step(cfg, par, mode="full", **SCHEDULE)

    def loss_fn(p):
        if cfg.arch == "egnn":
            pred, _ = gnn_mod.egnn_forward(p, g, cfg)
            return ((pred - g["target"]) ** 2).mean()
        return gnn_mod.node_classification_loss(p, g, cfg, par)

    loss, grads = grads_of(loss_fn, dparams)
    res[f"{name}/loss"] = loss.detach().numpy()
    res.update(flat(whole(grads), f"{name}/grads"))
    opt = adamw_init(dparams)
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    new, _, metrics = step(dparams, opt, g)
    res.update(flat(whole(new), f"{name}/step/params"))
    for k, v in metrics.items():
        res[f"{name}/step/{k}"] = whole(v)


def run(inputs: Path, out: Path, rank: int) -> None:
    mesh = make_test_mesh(8, AXES, SHAPE, device_type="cpu")
    par = tfm.Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
    with np.load(inputs) as z:
        data = dict(z)
    res = {}
    for name in LM_CASES:
        lm_case(name, data, mesh, par, res)
    for name in GNN_CASES:
        gnn_case(name, data, mesh, par, res)
    if rank == 0:
        np.savez(out / "rank0.npz", **res)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        run(Path(args.inputs), Path(args.out), args.rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
