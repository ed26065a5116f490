"""The port's process-group program (``repro_torch.core.merge``) over gloo,
in one world of eight spawned CPU ranks (``tests/torch_dist_world.py``):

* each rank's output of ``build_distributed_analysis_fn``, bit for bit,
  against the port's host simulator's machine of that rank's index —
  ``paper``/``xor`` on a ``(8,)`` mesh, ``hierarchical`` on a
  ``("data", "model")`` = (2, 4) mesh whose ranks are not in row-major
  order; every kind with both finals; ``with_deletions`` against
  ``simulate_churn_host``;
* the ``bridges`` rows against the JAX package's own 8-device
  ``shard_map`` program, run in a subprocess;
* ``find_bridges(..., mesh=...)`` on every rank (``recertify`` and
  ``incremental``) against ``bridges_dfs``; a buffer on a device of
  another type than the mesh's raises;
* the engine's distributed branch, ``BridgeEngine(mesh=...).analyze`` with
  ``delete=`` twice on every rank, against ``simulate_churn_host``, the
  second call a cache hit.

Integer and boolean outputs: tolerance 0.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_world as world_mod
from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import merge as tm
from repro_torch.core.certificate import certificate_capacity
from repro_torch.core.certs import certificate_builder
from repro_torch.graph.datastructs import EdgeList, compact_edges

from helpers import requires_modern_sharding

ROOT = Path(__file__).resolve().parents[1]
N, WORLD = world_mod.N, world_mod.WORLD
KINDS, SCHEDULES, FINALS = world_mod.KINDS, world_mod.SCHEDULES, world_mod.FINALS
#: the whole world's limit: a hang fails the test instead of stalling it
WORLD_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's arrays and facts, from one spawned gloo world with its
    own file store."""
    out = tmp_path_factory.mktemp("gloo_world")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_world.py"),
         "--rank", str(r), "--world", str(WORLD),
         "--store", str(out / "store"), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = dict(z)
        ranks.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return ranks


def _shards():
    psrc, pdst, pmask = world_mod.shards()
    return [EdgeList(torch.from_numpy(psrc[i]), torch.from_numpy(pdst[i]),
                     torch.from_numpy(pmask[i]), N) for i in range(WORLD)]


_SIMULATED: dict = {}


def simulated(schedule: str, cert: str) -> list:
    """The port simulator's per-machine merged certificates of the world's
    partition (cached per schedule and certificate)."""
    key = (schedule, cert)
    if key not in _SIMULATED:
        certify = certificate_builder(cert)
        local = [certify(sh, capacity=certificate_capacity(N))
                 for sh in _shards()]
        _SIMULATED[key] = tm.simulate_merge_host(local, schedule,
                                                 certify=certify,
                                                 grid=(2, 4))
    return _SIMULATED[key]


def machine_buffers(cert: EdgeList, kind: str, final: str) -> list:
    """What the program returns on a machine holding ``cert``."""
    if final == "host":
        o = compact_edges(cert, certificate_capacity(N))
        return [o.src, o.dst, o.mask]
    st = tour_state(cert.src, cert.dst, cert.mask, N)
    out = get_analysis(kind).device_fn(cert.src, cert.dst, cert.mask, N, st,
                                       N - 1)
    return [out] if isinstance(out, torch.Tensor) else list(out)


def rank_buffers(arrays: dict, prefix: str) -> list:
    return [arrays[f"{prefix}/{j}"] for j in range(len(
        [k for k in arrays if k.startswith(prefix + "/")]))]


def assert_equal_buffers(got: list, want: list, label) -> None:
    assert len(got) == len(want), label
    for j, (g, w) in enumerate(zip(got, want)):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (label, j)
        assert np.array_equal(g, w), (label, j)


def test_machine_index_is_row_major_over_listed_axes(world):
    for arrays, facts in world:
        for label, (got, want) in facts["index"].items():
            assert got == want, (facts["rank"], label)
    assert [f["machine/hierarchical"] for _, f in world] == [
        0, 4, 1, 5, 2, 6, 3, 7]


@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_rank_matches_simulator_machine(world, kind, schedule, final):
    certs = simulated(schedule, get_analysis(kind).certificate)
    for arrays, facts in world:
        i = facts[f"machine/{schedule}"]
        assert_equal_buffers(rank_buffers(arrays, f"{kind}/{schedule}/{final}"),
                             machine_buffers(certs[i], kind, final),
                             (kind, schedule, final, facts["rank"]))


def test_xor_over_two_axes_listed_against_the_mesh_order(world):
    certs = simulated("xor", "2ec")
    for arrays, facts in world:
        i = facts["machine/xor-model,data"]
        assert_equal_buffers(
            rank_buffers(arrays, "bridges/xor-model,data/host"),
            machine_buffers(certs[i], "bridges", "host"), facts["rank"])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", ["bridges", "cuts"])
def test_deletions_match_simulate_churn_host(world, kind, schedule):
    src, dst, planted = world_mod.graph()
    ksrc, kdst = world_mod.deletion_keys(src, dst, planted)
    certify = certificate_builder(get_analysis(kind).certificate)
    certs = tm.simulate_churn_host(_shards(), ksrc, kdst, schedule,
                                   certify=certify, grid=(2, 4))
    for arrays, facts in world:
        i = facts[f"machine/{schedule}"]
        assert_equal_buffers(rank_buffers(arrays, f"churn/{kind}/{schedule}"),
                             machine_buffers(certs[i], kind, "host"),
                             (kind, schedule, facts["rank"]))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", ["bridges", "cuts"])
def test_engine_deletions_match_simulate_churn_host(world, kind, schedule):
    src, dst, planted = world_mod.graph()
    ksrc, kdst = world_mod.deletion_keys(src, dst, planted)
    analysis = get_analysis(kind)
    certs = tm.simulate_churn_host(_shards(), ksrc, kdst, schedule,
                                   certify=certificate_builder(
                                       analysis.certificate), grid=(2, 4))
    c = certs[0]
    m = c.mask.numpy()
    want = sorted(list(x) if isinstance(x, tuple) else x for x in
                  analysis.host_fn(c.src.numpy()[m], c.dst.numpy()[m], N))
    assert want
    for _, facts in world:
        for call in range(2):
            got, counts = facts["engine"][f"{kind}/{schedule}/{call}"]
            assert got == want, (facts["rank"], call)
            assert counts == [1, call], (facts["rank"], call)


@pytest.mark.parametrize("seed", range(3))
def test_find_bridges_with_mesh_on_every_rank(world, seed):
    for _, facts in world:
        runs = {k: v for k, v in facts["answers"].items()
                if k.startswith(f"{seed}/") and k.endswith("/recertify")}
        assert len(runs) == 3
        assert all(ok and n_bridges >= 3 for ok, n_bridges in runs.values()), (
            facts["rank"], runs)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_incremental_merge_matches_oracle(world, schedule):
    for _, facts in world:
        runs = {k: v for k, v in facts["answers"].items()
                if f"/{schedule}/" in k and k.endswith("/incremental")}
        assert len(runs) == 3
        assert all(ok for ok, _ in runs.values()), (facts["rank"], runs)


def test_analyze_cuts_with_mesh_on_every_rank(world):
    src, dst, _ = world_mod.graph()
    want = sorted(get_analysis("cuts").host_fn(src, dst, N))
    assert want and all(facts["cuts"] == want for _, facts in world)


def test_buffers_off_the_mesh_device_raise(world):
    for _, facts in world:
        assert "'cpu' mesh" in facts["raised"]["program"]
        assert "device type 'cpu'" in facts["raised"]["find_bridges"]


_JAX_PROGRAM = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.core.merge import build_distributed_analysis_fn
from repro.core.partition import partition_edges
from repro.graph import generators as gen

N, SEED = {n}, {seed}
mesh1 = jax.make_mesh((8,), ("machines",), axis_types=(AxisType.Auto,))
mesh2 = jax.make_mesh((2, 4), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
src, dst, _ = gen.planted_bridge_graph(N, 2000, 4, seed=5)
psrc, pdst, pmask = partition_edges(src, dst, N, 8, seed=SEED)
out = {{}}
for sched in ("paper", "xor", "hierarchical"):
    mesh, axes = ((mesh2, ("data", "model")) if sched == "hierarchical"
                  else (mesh1, ("machines",)))
    for final in ("host", "device"):
        fn = build_distributed_analysis_fn(mesh, axes, N, schedule=sched,
                                           final=final, kind="bridges")
        with jax.set_mesh(mesh):
            res = jax.jit(fn)(jnp.asarray(psrc), jnp.asarray(pdst),
                              jnp.asarray(pmask))
        for j, r in enumerate(res):
            out[f"bridges/{{sched}}/{{final}}/{{j}}"] = np.asarray(r)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """The JAX package's ``[M, ...]`` outputs of its 8-device program on
    the world's partition (a subprocess with eight forced host devices, as
    ``tests/test_distributed.py::run_with_devices`` runs it)."""
    path = tmp_path_factory.mktemp("jax_rows") / "rows.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX_PROGRAM.format(n=N, seed=world_mod.PART_SEED))
    r = subprocess.run([sys.executable, "-c", code, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@requires_modern_sharding
@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_rank_matches_jax_shard_map_row(world, jax_rows, schedule, final):
    prefix = f"bridges/{schedule}/{final}"
    want = rank_buffers(jax_rows, prefix)
    assert all(w.shape[0] == WORLD for w in want)
    for arrays, facts in world:
        i = facts[f"machine/{schedule}"]
        assert_equal_buffers(rank_buffers(arrays, prefix),
                             [w[i] for w in want],
                             (schedule, final, facts["rank"]))
