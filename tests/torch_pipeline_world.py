"""One rank of the gloo world that ``tests/test_torch_pipeline.py`` spawns:
eight ranks on a (4, 2) ``("pipe", "data")`` mesh built by the port's
``launch.mesh.make_test_mesh``, as ``tests/test_pipeline.py`` builds JAX's.

The rank reads the language model's weights, the tokens and an AdamW
state from the ``--inputs`` file, keeps its stage's block of the layers
(``stageify_params(params, 4, stage)``), and runs ``make_pp_loss_fn``'s
loss and its gradient (``torch.autograd.grad``), then one
``make_pp_train_step`` step from the state's block; then the loss and the
gradient of the same pipeline over a mixture of experts (``MOE``).

    python tests/torch_pipeline_world.py --rank R --world 8 --store FILE \\
        --inputs FILE --out DIR

Imports torch and the port only; each rank writes ``<out>/rank<r>.npz``.
"""
from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.interop import (  # noqa: E402
    adamw_state_from_numpy,
    lm_params_from_numpy,
    to_numpy,
)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.moe import MoEConfig  # noqa: E402
from repro_torch.models.pipeline import (  # noqa: E402
    PipelineConfig,
    make_pp_loss_fn,
    make_pp_train_step,
    stageify_params,
)
from repro_torch.models.transformer import LMConfig, Parallelism  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_unflatten  # noqa: E402

AXES, SHAPE = ("pipe", "data"), (4, 2)
#: tests/test_pipeline.py's config
CFG = dict(name="t", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab=61, d_head=8, param_dtype="float32", attn_chunk=8,
           remat=False, tp_align=1)
#: the mixture-of-experts case: CFG with four experts of top 2 per layer
MOE = dict(n_experts=4, top_k=2, d_ff_expert=16)
N_MICRO, MB, SEQ = 4, 2, 16
#: the train step's optimizer and schedule (step 5 of 20, warmup 2)
LR, SCHEDULE = 1e-3, {"total_steps": 20, "warmup": 2}


def unflat(z: dict, prefix: str) -> dict:
    """The tree saved under ``prefix`` (``embed``, ``final_norm``,
    ``layers/<name>``)."""
    out = {"layers": {}}
    for key, val in z.items():
        if not key.startswith(prefix + "/"):
            continue
        name = key[len(prefix) + 1:]
        if name.startswith("layers/"):
            out["layers"][name[len("layers/"):]] = val
        else:
            out[name] = val
    return out


def flat(tree: dict, prefix: str) -> dict:
    out = {f"{prefix}/{k}": v for k, v in tree.items() if k != "layers"}
    out.update({f"{prefix}/layers/{k}": v
                for k, v in tree["layers"].items()})
    return out


def block(tree: dict, stage: int) -> dict:
    """A staged [S, L/S, ...] tree's stage block [1, L/S, ...]."""
    return {**tree, "layers": {k: v[stage:stage + 1]
                               for k, v in tree["layers"].items()}}


def run(inputs: Path, out: Path, rank: int) -> None:
    mesh = make_test_mesh(8, AXES, SHAPE, device_type="cpu")
    stage = int(mesh.get_coordinate()[0])
    cfg = LMConfig(**CFG)
    par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
    pp = PipelineConfig(n_stages=SHAPE[0], n_micro=N_MICRO)
    with np.load(inputs) as z:
        data = dict(z)
    params = stageify_params(
        lm_params_from_numpy(unflat(data, "params"), cfg, device="cpu"),
        pp.n_stages, stage)
    batch = {"tokens": data["tokens"]}
    loss_fn = make_pp_loss_fn(cfg, par, pp)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    state = {"step": data["opt/step"]}
    for key in ("master", "m", "v"):
        state[key] = block(unflat(data, f"opt/{key}"), stage)
    opt = adamw_state_from_numpy(state, params, device="cpu")
    step = make_pp_train_step(cfg, par, pp, AdamWConfig(lr=LR), **SCHEDULE)
    new, new_opt, metrics = step(params, opt, batch)
    result = {"coord": np.asarray(mesh.get_coordinate()),
              "loss": loss.detach().numpy(),
              **flat(to_numpy(grads), "grads"),
              **flat(to_numpy(new), "step/params"),
              "step/opt/step": new_opt["step"].numpy(),
              **{f"step/{k}": v.numpy() for k, v in metrics.items()}}
    for key in ("master", "m", "v"):
        result.update(flat(to_numpy(new_opt[key]), f"step/opt/{key}"))
    # the same pipeline over a mixture of experts: its loss and gradient
    mcfg = LMConfig(**CFG, moe=MoEConfig(**MOE))
    mparams = stageify_params(
        lm_params_from_numpy(unflat(data, "moe/params"), mcfg, device="cpu"),
        pp.n_stages, stage)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(mparams)]
    loss = make_pp_loss_fn(mcfg, par, pp)(tree_unflatten(mparams, leaves),
                                          batch)
    grads = tree_unflatten(mparams, list(torch.autograd.grad(loss, leaves)))
    result["moe/loss"] = loss.detach().numpy()
    result.update(flat(to_numpy(grads), "moe/grads"))
    np.savez(out / f"rank{rank}.npz", **result)


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
