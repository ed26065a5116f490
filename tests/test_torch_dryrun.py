"""The dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``) against
the JAX package's.

The fake world and the JAX side (512 forced host devices) each run in a
subprocess of their own, so that no test of this worker sees a default
process group or forced devices.

- ``roofline_terms`` is the reference's function on the same inputs, with
  the reference module's ``HW`` replaced by the port's H100 figures.
- Each collective kind the recorder sees on fake tensors carries the
  payload the reference's ``collective_bytes`` reads from a hand-written
  HLO line of the same shapes.
- A gather's output counts toward the peak of live bytes (an explicit
  redistribute's, and one ``DTensor`` makes inside a product).
- The per-device FLOP rule: a column-parallel and a row-parallel
  (``Partial``) matmul over the 16-rank model axis count 1/16 of the
  global flops, a replicated one all of them.
- ``run_cell`` on the ``single`` mesh for four cells, one of each family:
  status ``ok``, and ``argument_size_in_bytes`` equal to the reference's
  ``memory_analysis()``.
- The L=2 probe of ``qwen3_0_6b`` ``train_4k``: the port's per-device
  flops (matmul-class ops only) over XLA's ``cost_analysis()`` flops
  (elementwise ops included) lies in 0.5-1.1.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.launch import hlo_analysis as j_hlo
from repro_torch.launch import hlo_analysis as t_hlo

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
#: (arch, shape) of each family's cell
CELLS = (("sasrec", "serve_p99"), ("qwen3_0_6b", "decode_32k"),
         ("pna", "full_graph_sm"), ("bridges_dense", "fig2_dense"))
FLOP_RATIO = (0.5, 1.1)

_JAX_PROGRAM = """
import json, sys
from pathlib import Path
from repro.launch import dryrun  # forces 512 host devices first
from repro.configs import get
from repro.launch.mesh import make_production_mesh

out = Path(sys.argv[1])
res = {{}}
for arch, shape in {cells!r}:
    rec = dryrun.run_cell(arch, shape, "single", out / "cells", force=True)
    res[f"{{arch}}/{{shape}}"] = {{"status": rec["status"],
                                 "memory": rec.get("memory")}}
mesh = make_production_mesh()
m, _ = dryrun._compile_workload(get("qwen3_0_6b"), "train_4k", mesh,
                                n_layers=2, analysis=True)
res["probe_flops"] = m["flops"]
(out / "jax.json").write_text(json.dumps(res))
"""

_PORT_PROGRAM = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import collective_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.workloads import fake_mode

out = Path(sys.argv[1])
res = {{}}
c10d = torch.ops._c10d_functional
with dryrun.fake_world(256):
    mesh = make_production_mesh(device_type="cpu")
    name = mesh.get_group("model").group_name
    with fake_mode():
        x, y = torch.empty((1, 16)), torch.empty((16, 16))
        z, w = torch.empty((4, 8)), torch.empty((16, 4))

        def permute():
            ops = [dist.P2POp(dist.isend, z, 1),
                   dist.P2POp(dist.irecv, torch.empty((4, 8)), 2)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        calls = {{
            "all-gather": lambda: c10d.all_gather_into_tensor(x, 16, name),
            "reduce-scatter": lambda: c10d.reduce_scatter_tensor(
                y, "sum", 16, name),
            "all-reduce": lambda: c10d.all_reduce(z, "sum", name),
            "all-to-all": lambda: c10d.all_to_all_single(
                w, [1] * 16, [1] * 16, name),
            "collective-permute": permute,
        }}
        res["coll"] = {{}}
        for kind, fn in calls.items():
            rec = dryrun._Recorder(())
            with rec:
                fn()
            res["coll"][kind] = collective_bytes(rec.coll)
        rep = [Replicate(), Replicate()]
        a = torch.empty((64, 32))
        b = torch.empty((32, 48))
        cases = {{"column": (rep, [Replicate(), Shard(1)]),
                  "row": ([Replicate(), Shard(1)], [Replicate(), Shard(0)]),
                  "replicated": (rep, rep)}}
        res["flops"] = {{}}
        for case, (pa, pb) in cases.items():
            da = distribute_tensor(a, mesh, pa, src_data_rank=None)
            db = distribute_tensor(b, mesh, pb, src_data_rank=None)
            rec = dryrun._Recorder(())
            with rec:
                torch.mm(da, db)
            res["flops"][case] = rec.flops
        # memory: a gather's output is live bytes, whether an explicit
        # redistribute makes it or DTensor does inside a column-parallel
        # product whose input arrives split by rows
        rows = distribute_tensor(torch.empty((256, 64)), mesh,
                                 [Replicate(), Shard(0)], src_data_rank=None)
        cols = distribute_tensor(torch.empty((64, 128)), mesh,
                                 [Replicate(), Shard(1)], src_data_rank=None)
        res["mem"] = {{}}
        for case, fn in (("redistribute", lambda: rows.redistribute(
                mesh, rep)), ("column", lambda: torch.mm(rows, cols))):
            rec = dryrun._Recorder((rows, cols))
            with rec:
                y = fn()
            res["mem"][case] = {{
                "temp": rec.peak - rec.args_bytes,
                "gathered": max(r for _, _, r in rec.coll),
                "out": y.to_local().numel() * 4}}
    m, _ = dryrun._compile_workload(get("qwen3_0_6b"), "train_4k", mesh,
                                    n_layers=2, analysis=True)
    res["probe_flops"] = m["flops"]
# a batch of one on a one-rank (1, 1) mesh: a mesh axis of size one
# splits nothing (launch/mesh.py::spec_placements)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tfm
with dryrun.fake_world(1):
    one = make_test_mesh(1, ("data", "model"), (1, 1), device_type="cpu")
    cfg = get("qwen3_0_6b").smoke_config
    par = tfm.Parallelism(mesh=one, dp_axes=("data",), tp_axis="model")
    with fake_mode():
        p = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p = {{"embed": p["embed"], "final_norm": p["final_norm"],
              "layers": p["layers"], "tokens": torch.zeros(
                  (1, 17), dtype=torch.int32)}}
        specs = {{**tfm.param_specs(cfg, par), "tokens": (("data",), None)}}
        placed = dryrun.place(p, specs, one)
        tokens = placed.pop("tokens")
        from torch.distributed.tensor.experimental import implicit_replication
        try:
            with implicit_replication():
                loss = tfm.lm_loss(placed, {{"tokens": tokens}}, cfg, par)
            res["batch_of_one"] = [list(loss.shape), str(loss.dtype)]
        except Exception as ex:  # recorded for its own test
            res["batch_of_one"] = f"{{type(ex).__name__}}: {{ex}}"[:2000]
for arch, shape in {cells!r}:
    rec = dryrun.run_cell(arch, shape, "single", out / "cells", force=True,
                          device="cpu")
    res[f"{{arch}}/{{shape}}"] = {{"status": rec["status"],
                                 "error": rec.get("error"),
                                 "memory": rec.get("memory")}}
(out / "port.json").write_text(json.dumps(res))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's results, the port's)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for side, code in (("jax", _JAX_PROGRAM), ("port", _PORT_PROGRAM)):
        (out / side).mkdir()
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code.format(cells=CELLS)),
             str(out / side)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    try:
        for side, p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{side}: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return tuple(json.loads((out / side / f"{side}.json").read_text())
                 for side in ("jax", "port"))


def test_roofline_terms_match_reference(monkeypatch):
    monkeypatch.setattr(j_hlo, "HW", {"peak_flops": t_hlo.HW["peak_flops"],
                                      "hbm_bw": t_hlo.HW["hbm_bw"],
                                      "ici_bw": t_hlo.HW["link_bw"]})
    for cost, coll in (({"flops": 3.2e12, "bytes accessed": 7.5e10},
                        {"total_bytes": 2.0e9}),
                       ({"flops": 1e15, "bytes accessed": 1e9},
                        {"total_bytes": 0.0}),
                       ({"flops": 0.0, "bytes accessed": 0.0},
                        {"total_bytes": 0.0})):
        assert t_hlo.roofline_terms(cost, coll, 256) == \
            j_hlo.roofline_terms(cost, coll, 256)


#: one HLO instruction per kind, of the shapes the port's program records
_HLO = {
    "all-gather": "%ag = f32[16,16]{1,0} all-gather(f32[1,16]{1,0} %x), "
                  "dimensions={0}",
    "reduce-scatter": "%rs = f32[1,16]{1,0} reduce-scatter(f32[16,16]{1,0} "
                      "%y), dimensions={0}, to_apply=%add",
    "all-reduce": "%ar = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %z), "
                  "to_apply=%add",
    "all-to-all": "%aa = f32[16,4]{1,0} all-to-all(f32[16,4]{1,0} %w), "
                  "dimensions={0}",
    "collective-permute": "%cp = f32[4,8]{1,0} collective-permute("
                          "f32[4,8]{1,0} %z), source_target_pairs={{0,1}}",
}


@pytest.mark.parametrize("kind", list(_HLO))
def test_collective_payloads_match_reference(both, kind):
    _, got = both
    assert got["coll"][kind] == j_hlo.collective_bytes(_HLO[kind])


def test_flop_rule_counts_what_one_rank_computes(both):
    _, got = both
    full = 2 * 64 * 32 * 48
    assert got["flops"] == {"column": full / 16, "row": full / 16,
                            "replicated": full}


@pytest.mark.parametrize("case", ["redistribute", "column"])
def test_gathered_buffers_count_as_temp(both, case):
    """A gather's output counts toward the peak: an explicit redistribute's
    (exactly its bytes, the whole [256, 64] float32) and the one DTensor
    makes inside a column-parallel product (at least it, and at least the
    product's local output)."""
    _, got = both
    mem = got["mem"][case]
    if case == "redistribute":
        assert mem["gathered"] == 256 * 64 * 4 == mem["temp"]
    else:
        assert mem["temp"] >= max(mem["gathered"], mem["out"]) > 0


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_cell_argument_bytes_equal_reference(both, cell):
    want, got = both
    assert want[cell]["status"] == "ok"
    assert got[cell]["status"] == "ok", got[cell]["error"]
    assert got[cell]["memory"]["argument_size_in_bytes"] == \
        want[cell]["memory"]["argument_size_in_bytes"]


def test_train_probe_flops_within_reference(both):
    want, got = both
    ratio = got["probe_flops"] / want["probe_flops"]
    print(f"qwen3_0_6b train_4k L=2 per-device flops: port "
          f"{got['probe_flops']:.4e}, XLA {want['probe_flops']:.4e}, "
          f"ratio {ratio:.4f}")
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1]


def test_fake_kernels_give_their_results_shapes():
    """The kernels a dry run reaches take a fake tensor (here on the CPU)
    to a shape-only result: the shapes and dtypes ``ref.py`` gives on real
    inputs of the same shapes, with no launch and no ``ref.py`` run."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.boruvka_round import boruvka_round, frontier_round
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_min import segment_min

    g = torch.Generator().manual_seed(0)
    n, e = 20, 64
    src = torch.randint(0, n, (e,), dtype=torch.int32, generator=g)
    dst = torch.randint(0, n, (e,), dtype=torch.int32, generator=g)
    mask = torch.rand(e, generator=g) < 0.8
    labels = torch.arange(n, dtype=torch.int32)
    front = torch.rand(n, generator=g) < 0.5
    table = torch.randn(30, 8, generator=g)
    idx = torch.randint(0, 30, (4, 5), dtype=torch.int32, generator=g)
    bag_mask = torch.rand(4, 5, generator=g) < 0.5
    calls = {
        "boruvka_round": lambda *t: boruvka_round(*t[:4], n),
        "frontier_round": lambda *t: frontier_round(*t[:3], t[4], ~t[4], n),
        "segment_min": lambda *t: segment_min(t[0], t[1], n),
        "embedding_bag": lambda *t: embedding_bag(t[5], t[6], t[7], "mean"),
    }
    real = (src, dst, mask, labels, front, table, idx, bag_mask)
    reset_launch_counts()
    for name, call in calls.items():
        want = call(*real)
        with FakeTensorMode() as mode:
            got = call(*(mode.from_tensor(t) for t in real))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert all(isinstance(t, FakeTensor) for t in got), name
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want], name
    assert not any(launch_counts().values())


def test_batch_of_one_on_a_one_rank_mesh(both):
    """``lm_loss`` of a batch of one over ``DTensor`` params on a (1, 1)
    mesh gives its scalar (a tensor dimension of size one sharded over a
    mesh axis of size one once stopped ``DTensor``'s reshapes)."""
    _, got = both
    assert got["batch_of_one"] == [[], "torch.float32"]
