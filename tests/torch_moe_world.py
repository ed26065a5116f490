"""One rank of the gloo world that ``tests/test_torch_moe_mesh.py`` spawns:
eight ranks on a (4, 2) ``("data", "model")`` mesh built by the port's
``launch.mesh.make_test_mesh``.

For each case of ``CASES`` the rank runs ``models/moe.py::make_moe_layer``
(``dp_axes=("data",)``, ``tp_axis="model"``) on the whole batch and the
full expert weights from the ``--inputs`` file: it takes its two experts
of eight (or one of four), its block of the batch, and returns its block
of the output and the aux loss; then the gradient of ``sum(y * ct) +
aux`` (``ct`` a fixed cotangent, the rank's block of it) with respect to
every input, the rank's part of it.

    python tests/torch_moe_world.py --rank R --world 8 --store FILE \\
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

from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.moe import MoEConfig, make_moe_layer  # noqa: E402

AXES, SHAPE = ("data", "model"), (4, 2)
#: name -> the MoE config's fields; both split over the two model ranks
CASES = {"e8_k2": {"n_experts": 8, "top_k": 2, "d_ff_expert": 24},
         "e4_k2_cf05": {"n_experts": 4, "top_k": 2, "d_ff_expert": 24,
                        "capacity_factor": 0.5}}
ARRAYS = ("x", "router", "we_gate", "we_in", "we_out")


def run(rank: int, inputs: Path, out: Path) -> None:
    mesh = make_test_mesh(8, AXES, SHAPE, device_type="cpu")
    result = {"coord": np.asarray(mesh.get_coordinate())}
    with np.load(inputs) as z:
        data = dict(z)
    for name, kw in CASES.items():
        layer = make_moe_layer(mesh, ("data",), "model", MoEConfig(**kw))
        args = [torch.from_numpy(data[f"{name}/{a}"]) for a in ARRAYS]
        y, aux = layer(*args)
        result[f"{name}/out"] = y.numpy()
        result[f"{name}/aux"] = aux.numpy()
        # the gradient of sum(y * ct) + aux: this rank's parts
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, aux = layer(*leaves)
        per = y.shape[0]
        ct = torch.from_numpy(data[f"{name}/ct"])[
            int(mesh.get_coordinate()[0]) * per:][:per]
        grads = torch.autograd.grad((y * ct).sum() + aux, leaves)
        for a, g in zip(ARRAYS, grads):
            result[f"{name}/grad/{a}"] = g.numpy()
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
        run(args.rank, Path(args.inputs), Path(args.out))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
