"""One rank of the gloo world that ``tests/test_torch_distributed.py``
spawns: eight CPU processes, each running the port's process-group program
(``repro_torch.core.merge``), its distributed ``find_*`` entry points and
the engine's distributed branch (``BridgeEngine(mesh=...)``) on the shared
cases below, writing what it got to ``<out>/rank<r>.npz`` and
``<out>/rank<r>.json``.

    python tests/torch_dist_world.py --rank R --world 8 --store FILE --out DIR

Imports torch and the port only; the test compares the files against the
port's host simulator and the JAX package.
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import analyze, find_bridges  # noqa: E402
from repro_torch.core.bridges_host import bridges_dfs  # noqa: E402
from repro_torch.core.merge import (  # noqa: E402
    build_distributed_analysis_fn,
    machine_group,
)
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.engine import BridgeEngine  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402

WORLD = 8
KINDS = ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")
SCHEDULES = ("paper", "xor", "hierarchical")
FINALS = ("host", "device")
#: the graph every program case runs on, and its partition's seed
N, PART_SEED = 96, 1
#: the hierarchical mesh's rank layout: (data, model) = (2, 4), ranks not
#: in row-major order, so a machine's index differs from its rank
MESH2_RANKS = torch.arange(WORLD).reshape(4, 2).T.contiguous()


def deletion_keys(src, dst, planted):
    """Replicated deletion keys: a planted bridge reversed, repeated; a key
    matching no edge; three edges of the graph, one reversed."""
    a, b = sorted(planted)[0]
    ksrc = np.array([b, b, 0, src[0], src[7], dst[11]], np.int32)
    kdst = np.array([a, a, 0, dst[0], dst[7], src[11]], np.int32)
    return ksrc, kdst


def graph():
    src, dst, planted = gen.planted_bridge_graph(N, 2000, 4, seed=5)
    return src, dst, planted


def shards():
    src, dst, _ = graph()
    return partition_edges(src, dst, N, WORLD, seed=PART_SEED)


def mesh_case(schedule: str, mesh1, mesh2):
    """(mesh, machine_axes) a schedule runs on."""
    if schedule == "hierarchical":
        return mesh2, ("data", "model")
    return mesh1, ("machines",)


def expected_index(ranks: torch.Tensor, names, axes, rank: int) -> int:
    """A rank's machine index, row-major over ``axes`` in the order listed,
    from its coordinates in the mesh's rank tensor."""
    coords = dict(zip(names, (int(c) for c in
                              torch.nonzero(ranks == rank)[0])))
    index = 0
    for a in axes:
        index = index * ranks.shape[list(names).index(a)] + coords[a]
    return index


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=120))
    mesh1 = DeviceMesh("cpu", torch.arange(WORLD),
                       mesh_dim_names=("machines",))
    mesh2 = DeviceMesh("cpu", MESH2_RANKS, mesh_dim_names=("data", "model"))
    src, dst, planted = graph()
    psrc, pdst, pmask = shards()
    arrays, facts = {}, {"rank": args.rank}

    # machine numbering: each group's index against the mesh coordinates
    facts["index"] = {}
    for label, mesh, axes in (("machines", mesh1, ("machines",)),
                              ("data,model", mesh2, ("data", "model")),
                              ("model,data", mesh2, ("model", "data")),
                              ("model", mesh2, ("model",))):
        got = machine_group(mesh, axes).index
        want = expected_index(mesh.mesh, mesh.mesh_dim_names, axes,
                              args.rank)
        facts["index"][label] = [got, want]

    def row(i):
        return [torch.from_numpy(a[i].copy()) for a in (psrc, pdst, pmask)]

    # every kind, schedule and final: this rank's buffers
    for schedule in SCHEDULES:
        mesh, axes = mesh_case(schedule, mesh1, mesh2)
        i = machine_group(mesh, axes).index
        facts[f"machine/{schedule}"] = i
        for kind in KINDS:
            for final in FINALS:
                fn = build_distributed_analysis_fn(
                    mesh, axes, N, schedule=schedule, final=final, kind=kind)
                out = fn(*row(i))
                out = (out,) if isinstance(out, torch.Tensor) else out
                for j, t in enumerate(out):
                    arrays[f"{kind}/{schedule}/{final}/{j}"] = t.numpy()

    # xor over two axes listed against the mesh's order
    i = machine_group(mesh2, ("model", "data")).index
    facts["machine/xor-model,data"] = i
    fn = build_distributed_analysis_fn(mesh2, ("model", "data"), N,
                                       schedule="xor", final="host")
    for j, t in enumerate(fn(*row(i))):
        arrays[f"bridges/xor-model,data/host/{j}"] = t.numpy()

    # deletions: replicated keys, each machine tombstones its own shard
    ksrc, kdst = deletion_keys(src, dst, planted)
    keys = (torch.from_numpy(ksrc), torch.from_numpy(kdst),
            torch.ones(len(ksrc), dtype=torch.bool))
    for schedule in SCHEDULES:
        mesh, axes = mesh_case(schedule, mesh1, mesh2)
        i = machine_group(mesh, axes).index
        for kind in ("bridges", "cuts"):
            fn = build_distributed_analysis_fn(
                mesh, axes, N, schedule=schedule, final="host", kind=kind,
                with_deletions=True)
            for j, t in enumerate(fn(*row(i), *keys)):
                arrays[f"churn/{kind}/{schedule}/{j}"] = t.numpy()

    # the engine's distributed branch: two calls with the same keys, the
    # second served by the cached program (misses, hits after each)
    engine = {}
    for schedule in SCHEDULES:
        mesh, axes = mesh_case(schedule, mesh1, mesh2)
        for kind in ("bridges", "cuts"):
            eng = BridgeEngine(mesh=mesh, machine_axes=axes,
                               schedule=schedule)
            for call in range(2):
                got = eng.analyze(src, dst, N, kind=kind, final="host",
                                  seed=PART_SEED, delete=(ksrc, kdst))
                engine[f"{kind}/{schedule}/{call}"] = [
                    sorted(list(x) if isinstance(x, tuple) else x
                           for x in got),
                    [eng.stats.misses, eng.stats.hits]]
    facts["engine"] = engine

    # the entry points on every rank
    answers = {}
    for seed in range(3):
        s, d, _ = gen.planted_bridge_graph(100, 2500, 3, seed=seed)
        want = bridges_dfs(s, d, 100)
        for schedule, final in (("paper", "host"), ("xor", "device"),
                                ("hierarchical", "device")):
            mesh, axes = mesh_case(schedule, mesh1, mesh2)
            for merge in ("recertify", "incremental"):
                got = find_bridges(s, d, 100, mesh=mesh, machine_axes=axes,
                                   schedule=schedule, final=final,
                                   merge=merge, seed=seed)
                answers[f"{seed}/{schedule}/{final}/{merge}"] = [
                    sorted(got) == sorted(want), len(want)]
    cuts = analyze(src, dst, N, kind="cuts", mesh=mesh1, seed=2)
    facts["cuts"] = sorted(cuts)
    facts["answers"] = answers

    # buffers on a device of another type than the mesh's
    raised = {}
    fn = build_distributed_analysis_fn(mesh1, ("machines",), N)
    meta = [t.to("meta") for t in row(0)]
    for label, call in (
            ("program", lambda: fn(*meta)),
            ("find_bridges", lambda: find_bridges(src, dst, N, mesh=mesh1,
                                                  device="meta"))):
        try:
            call()
            raised[label] = None
        except ValueError as e:
            raised[label] = str(e)
    facts["raised"] = raised

    out = Path(args.out)
    np.savez(out / f"rank{args.rank}.npz", **arrays)
    (out / f"rank{args.rank}.json").write_text(json.dumps(facts))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
