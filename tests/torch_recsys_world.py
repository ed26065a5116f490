"""One rank of the gloo worlds that ``tests/test_torch_recsys_mesh.py``
spawns, on a ``("data", "model")`` mesh built by the port's
``launch.mesh.make_test_mesh``.

``--phase serve`` (eight ranks, a (4, 2) mesh): SASRec's weights from the
``--inputs`` file placed on the mesh by ``reshard_checkpoint`` with
``param_specs``; one ``make_recsys_steps(...)["train"]`` step over the
row-sharded table (``DTensor`` batch); ``serve_scores``, ``serve_bulk_topk`` (also from the
rank's local tensors) and ``retrieval_scores`` through the mesh branches;
two steps of ``compressed_psum_tree`` over the data axis with error
feedback, each rank's gradients from the inputs; a tree placed by
``reshard_checkpoint`` and saved whole by rank 0.

``--phase restore`` (four ranks, a (2, 2) mesh): that checkpoint, and the
JAX package's one of the same tree, restored and placed on the smaller
mesh.

    python tests/torch_recsys_world.py --phase serve --rank R --world 8 \\
        --store FILE --inputs FILE --out DIR

Imports torch and the port only; each rank writes ``<out>/<phase>-rank<r>
.npz`` and the test compares the files against the JAX package's 8-device
``shard_map`` programs.
"""
from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    reshard_checkpoint,
)
from repro_torch.configs.sasrec import SMOKE  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spec_placements  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.models.transformer import Parallelism  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.compression import compressed_psum_tree  # noqa: E402
from repro_torch.training import make_recsys_steps as rec_steps  # noqa: E402

#: the mesh's axes; the serve world's shape, the restore world's
AXES = ("data", "model")
SERVE_SHAPE, RESTORE_SHAPE = (4, 2), (2, 2)
#: the top-k and chunk count of serve_bulk_topk
K, N_CHUNKS = 10, 8
#: the train step's AdamW counter (past the warmup of 100)
TRAIN_STEP = 120
#: the elastic tree and its spec
ELASTIC = np.arange(64, dtype=np.float32).reshape(8, 8)
ELASTIC_SPEC = ("data", "model")


def tree_leaves_with_keys(params) -> list:
    """(``item_emb`` / ``pos_emb`` / ``blocks/<i>/<name>``, leaf) pairs."""
    out = [(k, v) for k, v in params.items() if k != "blocks"]
    for i, blk in enumerate(params["blocks"]):
        out += [(f"blocks/{i}/{k}", v) for k, v in blk.items()]
    return out


def serve(rank: int, inputs: Path, out: Path) -> None:
    mesh = make_test_mesh(8, AXES, SERVE_SHAPE, device_type="cpu")
    par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
    coord = mesh.get_coordinate()
    with np.load(inputs) as z:
        data = dict(z)
    tree = {"item_emb": data["item_emb"], "pos_emb": data["pos_emb"],
            "blocks": [{name: data[f"blocks/{i}/{name}"]
                        for name in (*rec.BLOCK_MATRICES, "ln1", "ln2")}
                       for i in range(SMOKE.n_blocks)]}
    params = reshard_checkpoint(tree, mesh, rec.param_specs(SMOKE, par))
    arrays = {"coord": np.asarray(coord),
              "table_rows": params["item_emb"].to_local().numpy()}

    arrays["serve"] = rec.serve_scores(params, data["seq"], SMOKE,
                                       par).numpy()
    s, i = rec.serve_bulk_topk(params, data["seq"], SMOKE, par, k=K,
                               n_chunks=N_CHUNKS)
    arrays["bulk_s"], arrays["bulk_i"] = s.numpy(), i.numpy()
    local = {k: v.to_local() for k, v in params.items() if k != "blocks"}
    local["blocks"] = [{k: v.to_local() for k, v in blk.items()}
                       for blk in params["blocks"]]
    s, i = rec.serve_bulk_topk(local, data["seq"], SMOKE, par, k=K,
                               n_chunks=N_CHUNKS)
    arrays["bulk_local_s"], arrays["bulk_local_i"] = s.numpy(), i.numpy()
    arrays["retrieval"] = rec.retrieval_scores(
        params, data["history"], data["hist_mask"], data["candidates"],
        SMOKE, par).numpy()

    # one train step over the row-sharded table: DTensor params, batch
    # split over data, the AdamW state past the warmup
    batch = {k: distribute_tensor(torch.from_numpy(data[f"train/{k}"]), mesh,
                                  spec_placements(mesh, ("data", None)),
                                  src_data_rank=None)
             for k in ("seq", "pos", "neg")}
    opt = adamw_init(params)
    opt["step"] = torch.tensor(TRAIN_STEP, dtype=torch.int32)
    new, _, metrics = rec_steps(SMOKE, par)["train"](params, opt, batch)
    for key, val in tree_leaves_with_keys(new):
        arrays[f"train/params/{key}"] = val.full_tensor().numpy()
    for key in ("loss", "grad_norm"):
        arrays[f"train/{key}"] = metrics[key].full_tensor().numpy()

    row = coord[0] * SERVE_SHAPE[1] + coord[1]
    group = mesh.get_group("data")
    errs = None
    for step in range(2):
        g = {k: torch.from_numpy(data[f"grads/{row}/{step}/{k}"])
             for k in ("a", "b")}
        new_g, errs = compressed_psum_tree(g, errs, group)
        for key in ("a", "b"):
            arrays[f"psum/{step}/g/{key}"] = new_g[key].numpy()
            arrays[f"psum/{step}/e/{key}"] = errs[key].numpy()

    placed = reshard_checkpoint({"w": ELASTIC}, mesh, {"w": ELASTIC_SPEC})
    arrays["elastic_local"] = placed["w"].to_local().numpy()
    full = placed["w"].full_tensor()
    if rank == 0:
        CheckpointManager(out / "ckpt").save(1, {"w": full})
    dist.barrier()
    np.savez(out / f"serve-rank{rank}.npz", **arrays)


def restore(rank: int, out: Path) -> None:
    mesh = make_test_mesh(4, AXES, RESTORE_SHAPE, device_type="cpu")
    arrays = {"coord": np.asarray(mesh.get_coordinate()),
              "ranks": np.asarray(mesh.size())}
    for which in ("ckpt", "jax_ckpt"):
        step, restored = CheckpointManager(out / which).restore(
            {"w": ELASTIC})
        placed = reshard_checkpoint(restored, mesh, {"w": ELASTIC_SPEC})
        arrays[f"{which}/step"] = np.asarray(step)
        arrays[f"{which}/local"] = placed["w"].to_local().numpy()
        arrays[f"{which}/full"] = placed["w"].full_tensor().numpy()
    np.savez(out / f"restore-rank{rank}.npz", **arrays)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("serve", "restore"), required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        if args.phase == "serve":
            serve(args.rank, Path(args.inputs), Path(args.out))
        else:
            restore(args.rank, Path(args.out))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
