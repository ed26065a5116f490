"""Port parity of fault-tolerant serving against the JAX package, mirroring
``tests/test_failover.py``: the failover merge drill
(``core.merge.simulate_failover_host``) slot for slot with the same info
dict for every kill boundary and victim of every schedule, with and
without snapshots; the degraded plans; the checkpoint manager's on-disk
format (each package restores the other's checkpoints, bfloat16 leaves
included, and skips a torn one); the engine's checkpoint cadence and
``restore_live`` (which runs no program) through ``EnginePair``, and
``benchmarks/fig11_failover.py``'s engine-restore script; the serving
drill (``launch.failover.serve_failover``) report; and the watchdog,
heartbeat monitor and failure injector on literal clocks.

Tolerance: exact equality (integer and boolean buffers, counters, sets).
Shards as the fig11 smoke cuts them: n 48, E 400, M 4.
"""
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as j_obs
from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import MachineCheckpoints as JaxMachines
from repro.connectivity.registry import ANALYSIS_KINDS
from repro.core import merge as jm
from repro.core.certs import certificate_builder as j_certificate_builder
from repro.core.partition import partition_edges as j_partition_edges
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro.launch.failover import serve_failover as j_serve_failover
from repro.obs import get_metrics as j_get_metrics
from repro.runtime import FailureInjector as JaxInjector
from repro.runtime import HeartbeatMonitor as JaxMonitor
from repro.runtime import StepWatchdog as JaxWatchdog
from repro_torch import obs
from repro_torch.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    MachineCheckpoints,
)
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import merge as tm
from repro_torch.core.bridges_host import bridges_dfs, bridges_from_edgelist
from repro_torch.core.certs import certificate_builder
from repro_torch.engine import BridgeEngine
from repro_torch.graph.datastructs import EdgeList
from repro_torch.launch.failover import HEARTBEAT_TIMEOUT_STEPS, serve_failover
from repro_torch.obs import get_metrics
from repro_torch.runtime import (
    FailureInjector,
    HeartbeatMonitor,
    SimulatedFailure,
    StepWatchdog,
)

from torch_engine_pair import EnginePair, assert_buffers_equal

N, E, M = 48, 400, 4
GRID = (2, 2)
SCHEDULES = ("paper", "xor", "hierarchical")

_SRC, _DST, _ = gen.planted_bridge_graph(N, E, 3, seed=7)
_PS, _PD, _PM = j_partition_edges(_SRC, _DST, N, M, seed=1)
_CAP = _PS.shape[1]
JAX_SHARDS = [jds.EdgeList.from_arrays(_PS[i][_PM[i]], _PD[i][_PM[i]], N,
                                       capacity=_CAP) for i in range(M)]
SHARDS = [EdgeList.from_arrays(_PS[i][_PM[i]], _PD[i][_PM[i]], N,
                               capacity=_CAP, device="cpu")
          for i in range(M)]
WANT = {tuple(sorted(p)) for p in bridges_dfs(_SRC, _DST, N)}
#: the fig11 drills: machine 0 dies at phase boundary 1
VICTIM, BOUNDARY = 0, 1


def _grid(schedule):
    return GRID if schedule == "hierarchical" else None


def _bridges(cert) -> set:
    return {tuple(sorted(p)) for p in bridges_from_edgelist(cert)}


def both_drills(schedule, kills, **kw):
    """``simulate_failover_host`` through both packages with the same kill
    schedule; holds the survivors, every survivor's certificate slot for
    slot and the info dict equal. Returns the port's result."""
    want = jm.simulate_failover_host(
        JAX_SHARDS, schedule, JaxInjector(kill_schedule=dict(kills)),
        grid=_grid(schedule), **kw)
    got = tm.simulate_failover_host(
        SHARDS, schedule, FailureInjector(kill_schedule=dict(kills)),
        grid=_grid(schedule), **kw)
    assert got[0] == want[0]
    assert got[2] == want[2]
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert_buffers_equal((g.src, g.dst, g.mask), (w.src, w.dst, w.mask),
                             f"machine {got[0][i]}")
    return got


def _counters(metrics):
    return {name: metrics.counter(name).value
            for name in ("failures/injected", "failures/recovered")}


# --------------------------------------------------- killed-machine drills
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("ckpt", [None, 1], ids=["no-ckpt", "ckpt"])
def test_kill_every_boundary_every_victim_matches_reference(schedule, ckpt):
    """Each victim at each phase boundary of each schedule: the same
    survivors, certificates and info dict as the reference, and exact
    bridge parity with the host recompute on every survivor."""
    boundaries = len(tm.merge_phase_plan(schedule, M,
                                         grid=_grid(schedule))) + 1
    for p in range(boundaries):
        for victim in (0, M - 1):
            alive, certs, info = both_drills(schedule, {victim: p},
                                             checkpoint_every=ckpt)
            assert victim not in alive and info["clean_phases"] == p
            assert all(_bridges(c) == WANT for c in certs)
            if p == 0:
                assert info["recoveries"][0]["source"] == "recertify"


@pytest.mark.parametrize("kind", ANALYSIS_KINDS)
def test_kill_parity_every_registry_kind(kind):
    """A mid-merge loss under every schedule with the kind's declared
    certificate: the same certificates as the reference, and the kind's
    host final on the answering one equal to the single-device answer."""
    analysis = get_analysis(kind)
    want = analysis.host_fn(_SRC, _DST, N)
    for schedule in SCHEDULES:
        jc = jm.simulate_failover_host(
            JAX_SHARDS, schedule, JaxInjector(kill_schedule={1: 1}),
            grid=_grid(schedule),
            certify=j_certificate_builder(analysis.certificate),
            checkpoint_every=2)
        alive, certs, info = tm.simulate_failover_host(
            SHARDS, schedule, FailureInjector(kill_schedule={1: 1}),
            grid=_grid(schedule),
            certify=certificate_builder(analysis.certificate),
            checkpoint_every=2)
        assert (alive, info) == (jc[0], jc[2])
        for g, w in zip(certs, jc[1]):
            assert_buffers_equal((g.src, g.dst, g.mask),
                                 (w.src, w.dst, w.mask), kind)
        got = analysis.host_fn(*certs[alive.index(info["answering"])]
                               .to_numpy(), N)
        if analysis.kind == "2ecc":
            assert np.array_equal(got, want), (kind, schedule)
        else:
            assert got == want, (kind, schedule)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_no_kill_is_the_clean_schedule(schedule):
    """With no failure the drill is ``simulate_merge_host``'s schedule."""
    alive, certs, info = both_drills(schedule, {})
    assert alive == list(range(M)) and info["restarts"] == 0
    local = tm.certify_shards(torch.stack([s.src for s in SHARDS]),
                              torch.stack([s.dst for s in SHARDS]),
                              torch.stack([s.mask for s in SHARDS]), N)
    ref = tm.simulate_merge_host(local, schedule, grid=_grid(schedule))
    assert _bridges(certs[info["answering"]]) == \
        _bridges(ref[0 if schedule == "paper" else info["answering"]]) == WANT


@pytest.mark.parametrize("kills", [{0: 0, 3: 1}, {1: 1, 2: 2}, {0: 1, 1: 1}],
                         ids=["0@0,3@1", "1@1,2@2", "0@1,1@1"])
def test_multi_kill_and_counter_deltas(kills):
    """Two machines lost: the same result as the reference, and both
    packages' counters tick once per kill and once per machine handled."""
    j_before, before = _counters(j_get_metrics()), _counters(get_metrics())
    alive, certs, info = both_drills("paper", kills, checkpoint_every=1)
    delta = {k: v - before[k] for k, v in _counters(get_metrics()).items()}
    j_delta = {k: v - j_before[k]
               for k, v in _counters(j_get_metrics()).items()}
    assert delta == j_delta == {"failures/injected": len(kills),
                                "failures/recovered": len(kills)}
    assert sorted(info["killed"]) == sorted(kills)
    assert all(_bridges(c) == WANT for c in certs)


def test_disk_backed_machine_checkpoints_match_reference(tmp_path):
    """The real atomic+CRC per-machine store: a lost block owner comes
    back from its snapshot in both packages, and the stores hold the same
    manifests (the same bytes, so the same CRCs)."""
    jstore, store = JaxMachines(tmp_path / "jax"), MachineCheckpoints(
        tmp_path / "torch")
    want = jm.simulate_failover_host(
        JAX_SHARDS, "paper", JaxInjector(kill_schedule={VICTIM: BOUNDARY}),
        checkpoint_every=1, checkpoints=jstore)
    got = tm.simulate_failover_host(
        SHARDS, "paper", FailureInjector(kill_schedule={VICTIM: BOUNDARY}),
        checkpoint_every=1, checkpoints=store)
    assert got[2] == want[2]
    assert got[2]["recoveries"][0]["source"] == "checkpoint"
    assert all(_bridges(c) == WANT for c in got[1])
    for machine in range(M):
        assert store.steps(machine) == jstore.steps(machine)
        for step in store.steps(machine):
            rel = f"machine-{machine}/step-{step:010d}/manifest.json"
            assert json.loads((tmp_path / "torch" / rel).read_text()) == \
                json.loads((tmp_path / "jax" / rel).read_text())
    assert store.steps(1), "surviving machines keep snapshotting"


def test_degraded_plans_match_reference():
    for schedule in SCHEDULES:
        for alive in ([1, 2, 3], [0, 2, 3], [0, 1], [0, 2, 5, 6, 7]):
            assert tm.degraded_phase_plan(schedule, alive) == \
                jm.degraded_phase_plan(schedule, alive)
            for q in range(math.ceil(math.log2(len(alive)))):
                assert tm.degraded_phase_perm(schedule, alive, q) == \
                    jm.degraded_phase_perm(schedule, alive, q)
            plan, _ = tm.degraded_phase_plan(schedule, alive)
            assert {i for pairs in plan for pair in pairs for i in pair} \
                <= set(alive)


def test_failover_spans_match_reference():
    """The drill's spans (certify, levels, machines, the recovery's) with
    their depths and attributes, under both tracers (the forest's kernel
    spans and the host syncs are the port's own)."""
    def record(o, fn, shards, injector):
        tr = o.enable_tracing()
        try:
            fn(shards, "paper", injector, checkpoint_every=1)
        finally:
            o.disable_tracing()
        return [(x["name"], x["depth"], x["attrs"]) for x in tr.spans()
                if not x["name"].startswith(("kernel/", "sync/"))]

    got = record(obs, tm.simulate_failover_host, SHARDS,
                 FailureInjector(kill_schedule={VICTIM: BOUNDARY}))
    want = record(j_obs, jm.simulate_failover_host, JAX_SHARDS,
                  JaxInjector(kill_schedule={VICTIM: BOUNDARY}))
    assert got == want
    assert {"merge/certify", "merge/level0", "merge/machine",
            "recover/machine", "recover/checkpoint_restore",
            "recover/fold"} <= {name for name, _, _ in got}


# ------------------------------------------------ the checkpoint format
def _leaves():
    rng = np.random.default_rng(0)
    return {
        "i32": rng.integers(-5, 5, (3, 4)).astype(np.int32),
        "mask": rng.random(7) < 0.5,
        "f32": rng.standard_normal(5).astype(np.float32),
        "bf16": rng.standard_normal(6).astype(np.float32),
        "scalar": 11,
    }


def test_checkpoints_cross_restore_between_packages(tmp_path):
    """A tree with int32, bool, float32 and bfloat16 leaves saved by each
    package restores in the other: the same dtypes (bfloat16 as
    ``torch.bfloat16`` in the port), shapes and values, and the same
    manifest keys, dtypes and shapes; the CRCs agree wherever the bytes
    do (every leaf but bfloat16, which numpy writes as an int16 view here
    and as two-byte records there)."""
    import jax.numpy as jnp
    import ml_dtypes

    leaves = _leaves()
    torch_tree = {"a": {"i32": torch.from_numpy(leaves["i32"]),
                        "mask": torch.from_numpy(leaves["mask"])},
                  "b": [torch.from_numpy(leaves["f32"]),
                        torch.from_numpy(leaves["bf16"]).to(torch.bfloat16)],
                  "c": leaves["scalar"]}
    jax_tree = {"a": {"i32": jnp.asarray(leaves["i32"]),
                      "mask": jnp.asarray(leaves["mask"])},
                "b": [jnp.asarray(leaves["f32"]),
                      jnp.asarray(leaves["bf16"]).astype(jnp.bfloat16)],
                "c": leaves["scalar"]}
    CheckpointManager(tmp_path / "torch").save(5, torch_tree)
    JaxManager(tmp_path / "jax").save(5, jax_tree)
    mt = json.loads((tmp_path / "torch/step-0000000005/manifest.json")
                    .read_text())
    mj = json.loads((tmp_path / "jax/step-0000000005/manifest.json")
                    .read_text())
    assert mt["step"] == mj["step"] == 5
    assert mt["arrays"].keys() == mj["arrays"].keys()
    for name, meta in mt["arrays"].items():
        ref = mj["arrays"][name]
        assert (meta["file"], meta["dtype"], meta["shape"]) == \
            (ref["file"], ref["dtype"], ref["shape"]), name
        assert (meta["crc32"] == ref["crc32"]) == (name != "b/1"), name
    bf16_bits = torch.from_numpy(leaves["bf16"]).to(torch.bfloat16).view(
        torch.int16).numpy()
    for where in ("torch", "jax"):
        step, flat = CheckpointManager(tmp_path / where).restore_flat()
        assert step == 5
        assert flat["b/1"].dtype == torch.bfloat16
        assert np.array_equal(flat["b/1"].view(torch.int16).numpy(),
                              bf16_bits)
        jstep, jflat = JaxManager(tmp_path / where).restore_flat()
        assert jstep == 5 and jflat["b/1"].dtype == ml_dtypes.bfloat16
        assert np.array_equal(jflat["b/1"].view(np.int16), bf16_bits)
        for name in ("a/i32", "a/mask", "b/0", "c"):
            assert flat[name].dtype == jflat[name].dtype, (where, name)
            assert np.array_equal(flat[name], jflat[name]), (where, name)


def test_torn_checkpoint_is_skipped_by_both(tmp_path):
    """A newest checkpoint whose file no longer matches its CRC (and one
    with no manifest) is skipped by both packages' restore, which fall
    back to the previous verified step; ``keep`` drops the oldest."""
    mgr = CheckpointManager(tmp_path, keep=3)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((4,), step, dtype=torch.int32)})
    assert sorted(p.name for p in tmp_path.glob("step-*")) == \
        [f"step-{s:010d}" for s in (1, 2, 3)]
    mgr.save(4, {"x": torch.full((4,), 4, dtype=torch.int32)})
    assert not (tmp_path / "step-0000000001").exists()
    torn = tmp_path / "step-0000000004" / "x.npy"
    torn.write_bytes(torn.read_bytes()[:-4] + b"\x00\x00\x00\x09")
    (tmp_path / "step-0000000003" / "manifest.json").unlink()
    for m in (mgr, JaxManager(tmp_path)):
        assert m.steps() == [2]
        assert m.latest_step() == 2
        step, flat = m.restore_flat()
        assert step == 2 and np.array_equal(flat["x"], np.full(4, 2))
        assert m.restore_flat(4) == (None, None)
    step, tree = mgr.restore({"x": None})
    assert step == 2 and tree["x"].tolist() == [2, 2, 2, 2]


def test_checkpoint_policy_cadence_matches_reference(tmp_path):
    from repro.checkpoint import CheckpointPolicy as JaxPolicy

    with pytest.raises(ValueError):
        CheckpointPolicy(CheckpointManager(tmp_path / "bad"), every=0)
    pol = CheckpointPolicy(CheckpointManager(tmp_path / "t"), every=3)
    jpol = JaxPolicy(JaxManager(tmp_path / "j"), every=3)
    for step in range(1, 8):
        tree = {"x": np.arange(step, dtype=np.int32)}
        assert (pol.on_write(step, lambda: tree) is None) == \
            (jpol.on_write(step, lambda: tree) is None)
        assert pol.snapshot() == jpol.snapshot()
    assert pol.snapshot() == {"saves": 2, "restores": 0, "every": 3,
                              "last_step": 6, "pending_writes": 1}


# --------------------------------------------- engine checkpoint / restore
def test_engine_checkpoint_restore_matches_reference(tmp_path):
    """``LiveState`` through ``CheckpointPolicy`` in both engines: the same
    checkpoint clock, saves and pending writes after every call; the
    restore runs no program (traces and cache keys unchanged), puts the
    state back equal to the reference's, and warm serving afterwards
    builds nothing."""
    pair = EnginePair()
    src, dst, _ = gen.planted_bridge_graph(64, 600, 3, seed=3)
    pair.jax.enable_checkpoints(tmp_path / "jax", every=3)
    pair.torch.enable_checkpoints(tmp_path / "torch", every=3)
    pair.call("load", src, dst, 64)
    want = pair.call("current_analysis", "bridges")
    pair.call("current_analysis", "cuts")  # materializes sfs
    pair.jax.checkpoint_now()
    pair.torch.checkpoint_now()
    pair.check_state()
    pair.call("insert_edges", *gen.random_graph(64, 32, seed=11))
    pair.call("delete_edges", src[:4], dst[:4], kind="cuts", final="host")

    traces = pair.torch.stats.traces
    programs = set(pair.torch._cache.keys())
    assert pair.torch.restore_live() == pair.jax.restore_live() == 0
    assert pair.torch.stats.traces == traces
    assert set(pair.torch._cache.keys()) == programs
    pair.check_state()
    assert pair.torch.snapshot()["checkpoint"]["restores"] == 1
    assert pair.call("current_analysis", "bridges") == want
    traces = pair.torch.stats.traces
    for k in range(3):
        pair.call("current_analysis", "bridges")
        pair.call("insert_edges", *gen.random_graph(64, 32, seed=13 + k))
    assert pair.torch.stats.traces == traces
    # checkpoint_now, then the cadence's third write since it (the first
    # insert after the restore, at step 1)
    assert pair.torch.snapshot()["checkpoint"]["saves"] == 2
    assert pair.torch.snapshot()["checkpoint"]["last_step"] == 1


def test_engine_restores_the_other_package_checkpoint(tmp_path):
    """A live state checkpointed by the JAX engine restores into the
    port's engine (and back) with every buffer equal."""
    pair = EnginePair()
    src, dst, _ = gen.planted_bridge_graph(64, 600, 3, seed=4)
    pair.jax.enable_checkpoints(tmp_path / "a", every=1)
    pair.torch.enable_checkpoints(tmp_path / "b", every=1)
    pair.call("load", src, dst, 64)
    pair.call("insert_edges", *gen.random_graph(64, 32, seed=2))
    fresh = EnginePair()
    fresh.torch.enable_checkpoints(tmp_path / "a")
    fresh.jax.enable_checkpoints(tmp_path / "b")
    assert fresh.torch.restore_live() == fresh.jax.restore_live() == 1
    for name, state in pair.jax._live.certs.items():
        got = fresh.torch._live.certs[name]
        assert (got is None) == (state is None)
        if state is not None:
            assert_buffers_equal(got, state, name)
    assert_buffers_equal(fresh.torch._live.full, pair.jax._live.full, "full")
    assert_buffers_equal(pair.torch._live.full, fresh.jax._live.full, "full")
    assert fresh.torch.stats.traces == 0


def test_engine_checkpoint_cadence_and_refusals(tmp_path):
    """``every=K`` saves on exactly every K-th write, deletions that hit
    nothing and a streamed graph's ingests count, a refused write does
    not; the refusals raise as the reference's do."""
    pair = EnginePair()
    with pytest.raises(RuntimeError):
        pair.torch.restore_live()
    with pytest.raises(RuntimeError):
        pair.torch.checkpoint_now()
    for eng, d in ((pair.jax, "j"), (pair.torch, "t")):
        eng.enable_checkpoints(tmp_path / d, every=3)
        with pytest.raises(RuntimeError):
            eng.restore_live()
        with pytest.raises(RuntimeError, match="load"):
            eng.checkpoint_now()
        with pytest.raises(RuntimeError, match="load"):
            eng.insert_edges([0], [1])
        with pytest.raises(ValueError):
            eng.enable_checkpoints(tmp_path / "bad", every=0)
        eng.enable_checkpoints(tmp_path / d, every=3)
    src, dst, _ = gen.planted_bridge_graph(64, 600, 3, seed=3)
    pair.call("load", src, dst, 64)
    for k in range(6):
        pair.call("insert_edges", *gen.random_graph(64, 8, seed=100 + k))
    pair.call("delete_edges", [63], [63])  # hits nothing, still counts
    assert pair.torch.snapshot()["checkpoint"] == {
        "saves": 2, "restores": 0, "every": 3, "last_step": 6,
        "pending_writes": 1}
    pair.call("load_stream", src, dst, 64, chunk_edges=256)
    pair.call("ingest_chunk", *gen.random_graph(64, 8, seed=9))
    with pytest.raises(RuntimeError, match="streamed"):
        pair.torch.checkpoint_now()
    assert pair.torch._write_ops == 9
    assert pair.torch.snapshot()["checkpoint"]["saves"] == 2


#: ``BENCH_baseline_fig11.json``'s pinned engine-restore counters
FIG11_RESTORE = {"saves": 2, "restores": 4, "every": 2, "warm_retraces": 0,
                 "programs": 4}


def fig11_engine_restore(engine, directory):
    """``benchmarks/fig11_failover.py``'s engine-restore script at its
    smoke size, minus the clocks: 4 writes at ``every=2`` (two cadence
    saves), then four restores (its timer's warm-up and three runs)."""
    nq, eq = 64, 512
    src, dst, _ = gen.planted_bridge_graph(nq, eq, 3, seed=3)
    policy = engine.enable_checkpoints(directory, every=2)
    engine.load(src, dst, nq)
    want = engine.current_analysis("bridges")
    for k in range(4):
        engine.insert_edges(*gen.random_graph(nq, 32, seed=50 + k))
    traces = engine.stats.traces
    for _ in range(4):
        engine.restore_live()
    got = engine.current_analysis("bridges")
    return ({"saves": policy.saves, "restores": policy.restores,
             "every": policy.every,
             "warm_retraces": engine.stats.traces - traces,
             "programs": engine.snapshot()["programs"]}, want, got)


def test_fig11_engine_restore_counters_in_both_packages(tmp_path):
    from repro.engine import BridgeEngine as JaxEngine

    want = fig11_engine_restore(JaxEngine(), tmp_path / "jax")
    got = fig11_engine_restore(BridgeEngine(device="cpu"), tmp_path / "t")
    assert got[0] == want[0] == FIG11_RESTORE
    assert got[1:] == want[1:]


# ------------------------------------------------- the serving drill
SMOKE_ARGS = dict(machines=4, steps=8, kill_machine=1, kill_at_step=2,
                  ckpt_every=1, schedule="paper", n=64, edges=512,
                  delta_edges=16, seed=0)


@pytest.mark.parametrize("schedule,ckpt_every",
                         [("paper", 1), ("xor", 0), ("hierarchical", 2)])
def test_serve_failover_report_matches_reference(tmp_path, schedule,
                                                 ckpt_every):
    """The serving drill at ``serve_bridges --smoke``'s failover size
    (M 4, kill 1 at step 2, n 64, 512 edges): the same report as the
    reference, minus ``ckpt_dir`` and the recovery's latency, and the
    counter deltas one each."""
    args = dict(SMOKE_ARGS, schedule=schedule, ckpt_every=ckpt_every)
    want = j_serve_failover(types.SimpleNamespace(
        **args, ckpt_dir=str(tmp_path / "jax")))
    got = serve_failover(types.SimpleNamespace(
        **args, ckpt_dir=str(tmp_path / "torch")), device="cpu")
    for rep in (got, want):
        rep.pop("ckpt_dir")
        rep["recovery"].pop("latency_s")
    assert got == want
    assert got["final_parity"] and got["survivors"] == 3
    assert got["recovery"]["machine"] == 1
    assert got["recovery"]["source"] == ("checkpoint" if ckpt_every == 1
                                         else "recertify")
    assert got["parity_failures_post_recovery"] == 0
    assert got["counters"] == {"failures/injected": 1,
                               "failures/recovered": 1,
                               "fleet/dead_machines": 1}
    assert got["final_bridges"] > 0


def test_serve_failover_without_a_kill_and_on_the_card_by_default():
    args = types.SimpleNamespace(**dict(SMOKE_ARGS, kill_machine=None,
                                        kill_at_step=None, ckpt_every=0,
                                        ckpt_dir=None, steps=3))
    rep = serve_failover(args, device="cpu")
    assert rep["recovery"] is None and rep["final_parity"]
    assert rep["parity_ok_steps"] == 3 and rep["ckpt_dir"] is None
    assert HEARTBEAT_TIMEOUT_STEPS == 1.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_failover(args)


# ------------------------------------------------- watchdog + injector
def test_heartbeat_death_declared_exactly_once():
    """``tests/test_failover.py``'s literal clock through both packages'
    monitors: the same declarations, dead sets and counter deltas."""
    mons = (HeartbeatMonitor(machines=range(3), timeout=1.5, name="tt1fleet"),
            JaxMonitor(machines=range(3), timeout=1.5, name="tt1fleet"))
    counters = (get_metrics().counter("tt1fleet/dead_machines"),
                j_get_metrics().counter("tt1fleet/dead_machines"))
    before = [c.value for c in counters]
    for mon in mons:
        for i in range(3):
            mon.beat(i, now=0.0)
        mon.beat(0, now=1.0)
        mon.beat(1, now=1.0)
        assert mon.newly_dead(now=1.0) == ()
        assert mon.newly_dead(now=2.0) == (2,)
        mon.beat(0, now=2.5)
        mon.beat(1, now=2.5)
        assert mon.newly_dead(now=3.0) == ()
        assert mon.dead == frozenset({2})
        mon.beat(2, now=3.5)  # a stale beat does not resurrect
        assert mon.dead == frozenset({2})
        assert mon.newly_dead(now=9.0) == (0, 1)
    assert [c.value - b for c, b in zip(counters, before)] == [3, 3]
    assert get_metrics().gauge("tt1fleet/machine0/beat").value == 2.5
    unbeaten = HeartbeatMonitor(machines=(7,), timeout=1.0, name="tt2fleet")
    assert unbeaten.newly_dead(now=100.0) == ()


def test_injector_kill_schedule_fires_once():
    injectors = (FailureInjector(kill_schedule={1: 5, 2: 5, 0: 7}),
                 JaxInjector(kill_schedule={1: 5, 2: 5, 0: 7}))
    counters = (get_metrics().counter("failures/injected"),
                j_get_metrics().counter("failures/injected"))
    before = [c.value for c in counters]
    for inj in injectors:
        assert inj.killed_machines(4) == ()
        assert inj.killed_machines(5) == (1, 2)
        assert inj.killed_machines(6) == ()
        assert inj.killed_machines(8) == (0,)
    assert [c.value - b for c, b in zip(counters, before)] == [3, 3]


def test_injector_maybe_fail_raises_once():
    inj = FailureInjector(fail_at_steps={2})
    inj.maybe_fail(1)
    with pytest.raises(SimulatedFailure, match="step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # fired once
    assert issubclass(SimulatedFailure, RuntimeError)


def test_step_watchdog_on_a_literal_clock(monkeypatch):
    """Step times 1, 1, 1 (warm-up), then 1, 5, 1 on a fake monotonic
    clock: one straggle, at step 4, in both packages, with the same EWMA
    and events; the gauges land in the global registry."""
    import repro.runtime.watchdog as jw
    import repro_torch.runtime.watchdog as tw

    def drive(mod, cls, name):
        ticks = iter([0, 1, 1, 2, 2, 3, 3, 4, 4, 9, 9, 10])
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(ticks))
        seen = []
        wd = cls(threshold=3.0, name=name, on_straggle=seen.append)
        for step in range(6):
            wd.start()
            wd.stop(step)
        monkeypatch.undo()
        return wd, seen

    got, seen = drive(tw, StepWatchdog, "tt_wd")
    want, j_seen = drive(jw, JaxWatchdog, "tt_wd")
    assert got.events == want.events == seen == j_seen
    assert [e["step"] for e in got.events] == [4]
    assert got.avg == want.avg and got.count == want.count == 6
    m = get_metrics()
    assert m.counter("tt_wd/straggles").value >= 1
    assert m.gauge("tt_wd/step_s").value == 1
    assert m.gauge("tt_wd/ewma_s").value == got.avg
    assert got.last_beat == m.gauge("tt_wd/step_s").updated_at
