"""Parity of the port's merge across machines, in one process, against the
JAX package: ``partition_edges``/``shard_capacity``, ``tombstone_mask``,
``merge_phase_plan``, the host simulator (``simulate_merge_host``,
``simulate_churn_host``) with every machine's certificate compared slot for
slot, every kind answered off the merged certificate, and the spans the two
tracers record. Integer and boolean outputs: tolerance 0 (bit-identical).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as j_obs
from repro.connectivity.registry import ANALYSIS_KINDS
from repro.connectivity.registry import get_analysis as j_get_analysis
from repro.core import merge as jm
from repro.core.certificate import certificate_capacity
from repro.core.certs import certificate_builder as j_certificate_builder
from repro.core.partition import partition_edges as j_partition_edges
from repro.core.partition import shard_capacity as j_shard_capacity
from repro.engine import BridgeEngine
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch import obs
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import merge as tm
from repro_torch.core.api import analyze, mesh_device
from repro_torch.core.certs import certificate_builder
from repro_torch.core.partition import partition_edges, shard_capacity
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph.datastructs import EdgeList, tombstone_mask

M, GRID = 8, (2, 4)
SCHEDULES = ("paper", "xor", "hierarchical")
CERTS = ("2ec", "sfs", "hybrid")
CASES = {
    "planted": lambda: gen.planted_bridge_graph(96, 2000, 4, seed=5)[:2] + (96,),
    "barbell": lambda: gen.barbell(10, 5)[:2] + (gen.barbell(10, 5)[3],),
}
ENGINE = BridgeEngine()


def _jax_shards(src, dst, n, m, seed=0):
    psrc, pdst, pmask = j_partition_edges(src, dst, n, m, seed=seed)
    return [jds.EdgeList(psrc[i], pdst[i], pmask[i], n) for i in range(m)]


def _torch_shards(src, dst, n, m, seed=0):
    psrc, pdst, pmask = partition_edges(src, dst, n, m, seed=seed)
    return [EdgeList(torch.from_numpy(psrc[i]), torch.from_numpy(pdst[i]),
                     torch.from_numpy(pmask[i]), n) for i in range(m)]


def _jax_local(shards, certify):
    cap = certificate_capacity(shards[0].n_nodes)
    return [certify(sh, capacity=cap) for sh in shards]


def _assert_same_machines(jax_certs, torch_certs, label):
    assert len(jax_certs) == len(torch_certs), label
    for i, (a, b) in enumerate(zip(jax_certs, torch_certs)):
        for name in ("src", "dst", "mask"):
            want = np.asarray(getattr(a, name))
            got = getattr(b, name).numpy()
            assert got.dtype == want.dtype, (label, i, name)
            assert np.array_equal(got, want), (label, i, name)


# ------------------------------------------------------------- partitioning
@pytest.mark.parametrize("e,m,seed", [(0, 1, 0), (1, 4, 0), (17, 3, 1),
                                      (400, 8, 2), (1000, 7, 3),
                                      (2048, 16, 11)])
def test_partition_edges_bit_identical(e, m, seed):
    rng = np.random.default_rng(e + m)
    src = rng.integers(0, 50, e).astype(np.int32)
    dst = rng.integers(0, 50, e).astype(np.int32)
    got = partition_edges(src, dst, 50, m, seed=seed)
    want = j_partition_edges(src, dst, 50, m, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert shard_capacity(e, m) == j_shard_capacity(e, m) == got[0].shape[1]


# ---------------------------------------------------------------- tombstone
def _tomb_case(name):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 12, 40).astype(np.int32)
    dst = rng.integers(0, 12, 40).astype(np.int32)
    mask = rng.random(40) < 0.8
    # keys reversed against the slots, one repeated, one matching nothing
    ksrc = np.array([dst[0], src[3], dst[0], 11, src[9]], np.int32)
    kdst = np.array([src[0], dst[3], src[0], 11, dst[9]], np.int32)
    kmask = np.ones(5, bool)
    if name == "partial_kmask":
        kmask = np.array([True, False, True, True, False])
    if name == "batched":
        src, dst, mask = (np.stack([a, np.roll(a, 5)]) for a in (src, dst,
                                                                  mask))
        ksrc, kdst = np.stack([ksrc, kdst]), np.stack([kdst, np.roll(ksrc, 1)])
        kmask = np.stack([kmask, np.array([True, True, False, True, True])])
    if name == "batched_shared_keys":
        src, dst, mask = (np.stack([a, a[::-1]]) for a in (src, dst, mask))
    return src, dst, mask, ksrc, kdst, kmask


@pytest.mark.parametrize("name", ["reversed_repeated", "partial_kmask",
                                  "batched", "batched_shared_keys"])
def test_tombstone_mask_bit_identical(name):
    args = _tomb_case(name)
    want_mask, want_removed = jds.tombstone_mask(*args)
    got_mask, got_removed = tombstone_mask(*(torch.from_numpy(np.asarray(a))
                                             for a in args))
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_removed.dtype == torch.int32 and got_removed.dim() == 0
    assert int(got_removed) == int(want_removed) > 0


# --------------------------------------------------------------- the plans
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_merge_phase_plan_equal(schedule):
    for m in range(1, 17):
        grids = [None] + [(r, m // r) for r in range(1, m + 1) if m % r == 0]
        for grid in grids:
            try:
                want = jm.merge_phase_plan(schedule, m, grid=grid)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tm.merge_phase_plan(schedule, m, grid=grid)
                continue
            assert tm.merge_phase_plan(schedule, m, grid=grid) == want


@pytest.mark.parametrize("schedule,m,grid", [("ring", 8, None),
                                             ("hierarchical", 8, (3, 3)),
                                             ("hierarchical", 7, None)])
def test_merge_phase_plan_errors_match(schedule, m, grid):
    with pytest.raises(ValueError) as want:
        jm.merge_phase_plan(schedule, m, grid=grid)
    with pytest.raises(ValueError) as got:
        tm.merge_phase_plan(schedule, m, grid=grid)
    assert str(got.value) == str(want.value)


def test_flattened_ranks_row_major_in_listed_order():
    """Machines number row-major over the machine axes in the order listed
    (``lax.ppermute``'s and ``P(axes, None)``'s numbering), one group per
    coordinate of the other dims; checked on stand-in meshes."""
    ranks = torch.arange(24).reshape(2, 3, 4)[:, :, [3, 1, 0, 2]]
    mesh = types.SimpleNamespace(mesh=ranks, mesh_dim_names=("a", "b", "c"))
    for axes in (("a", "b", "c"), ("c", "a"), ("b",), ("c", "b", "a")):
        groups = tm.flattened_ranks(mesh, axes)
        dims = ["abc".index(x) for x in axes]
        others = [d for d in range(3) if d not in dims]
        assert sorted(r for g in groups for r in g) == list(range(24))
        for g in groups:
            coords = [np.argwhere(ranks.numpy() == r)[0] for r in g]
            assert len({tuple(c[others]) for c in coords}) == 1
            linear = [int(np.ravel_multi_index(
                c[dims], [ranks.shape[d] for d in dims])) for c in coords]
            assert linear == list(range(len(g)))
    assert tm.machine_axes_of(mesh) == ("a", "b", "c")
    assert tm.machine_axes_of(mesh, "b") == ("b",)
    with pytest.raises(ValueError, match="machine axes"):
        tm.machine_axes_of(mesh, ("a", "z"))


def test_mesh_device_refuses_another_device_type():
    mesh = types.SimpleNamespace(device_type="cpu")
    assert mesh_device(mesh) == torch.device("cpu")
    assert mesh_device(mesh, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device type"):
        mesh_device(mesh, "meta")
    s, d, _ = CASES["planted"]()
    with pytest.raises(ValueError, match="device type"):
        analyze(s, d, 96, mesh=mesh, device="meta")


# ------------------------------------------------------------ the simulator
@pytest.mark.parametrize("cert", CERTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", list(CASES))
def test_simulate_merge_host_slot_for_slot(case, schedule, cert):
    src, dst, n = CASES[case]()
    want = jm.simulate_merge_host(
        _jax_local(_jax_shards(src, dst, n, M), j_certificate_builder(cert)),
        schedule, certify=j_certificate_builder(cert), grid=GRID)
    sh = _torch_shards(src, dst, n, M)
    local = tm.certify_shards(*(torch.stack([getattr(s, f) for s in sh])
                                for f in ("src", "dst", "mask")), n,
                              certify=certificate_builder(cert))
    got = tm.simulate_merge_host(local, schedule,
                                 certify=certificate_builder(cert), grid=GRID)
    _assert_same_machines(want, got, (case, schedule, cert))


@pytest.mark.parametrize("cert", CERTS)
@pytest.mark.parametrize("schedule", ["paper", "xor"])
def test_simulate_merge_host_three_machines(schedule, cert):
    """M = 3: some partners fall outside the machines (xor's 2 ^ 1 = 3 is
    not one; paper's machine 2 has no sender in phase 1)."""
    src, dst, n = CASES["planted"]()
    want = jm.simulate_merge_host(
        _jax_local(_jax_shards(src, dst, n, 3, seed=4),
                   j_certificate_builder(cert)),
        schedule, certify=j_certificate_builder(cert))
    got = tm.simulate_merge_host(
        [certificate_builder(cert)(sh, capacity=certificate_capacity(n))
         for sh in _torch_shards(src, dst, n, 3, seed=4)],
        schedule, certify=certificate_builder(cert))
    _assert_same_machines(want, got, (schedule, cert))


@pytest.mark.parametrize("cert", CERTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_simulate_churn_host_slot_for_slot(schedule, cert):
    src, dst, n = CASES["planted"]()
    ksrc = np.array([dst[0], src[5], dst[0], 3], np.int32)
    kdst = np.array([src[0], dst[5], src[0], 3], np.int32)
    want = jm.simulate_churn_host(_jax_shards(src, dst, n, M), ksrc, kdst,
                                  schedule,
                                  certify=j_certificate_builder(cert),
                                  grid=GRID)
    got = tm.simulate_churn_host(_torch_shards(src, dst, n, M), ksrc, kdst,
                                 schedule, certify=certificate_builder(cert),
                                 grid=GRID)
    _assert_same_machines(want, got, (schedule, cert))


def _same(kind, got, want):
    if kind == "2ecc":
        return np.array_equal(got, want)
    return got == want


@pytest.mark.parametrize("kind", ANALYSIS_KINDS)
def test_distributed_kind_matches_single_device_all_schedules(kind):
    """Every kind answered off the port's merged certificate (the kind's
    certificate merged under each schedule, then the device final at the
    answering machine, and the host final on machine 0) equals
    ``repro.engine.BridgeEngine().analyze``."""
    analysis = get_analysis(kind)
    certify = certificate_builder(analysis.certificate)
    src, dst, n = CASES["planted"]()
    want = ENGINE.analyze(src, dst, n, kind=kind)
    assert _same(analysis.kind, j_get_analysis(kind).host_fn(src, dst, n),
                 want)
    final_fn = make_analysis_fn(n, kind, "device")
    for schedule in SCHEDULES:
        certs = tm.simulate_merge_host(
            [certify(sh, capacity=certificate_capacity(n))
             for sh in _torch_shards(src, dst, n, M)],
            schedule, certify=certify, grid=GRID)
        answer_on = [0] if schedule == "paper" else [0, M - 1]
        for i in answer_on:
            c = certs[i]
            got = analysis.to_result(final_fn(c.src, c.dst, c.mask), n)
            assert _same(analysis.kind, got, want), (kind, schedule, i)
        m = certs[0].mask.numpy()
        host_got = analysis.host_fn(certs[0].src.numpy()[m],
                                    certs[0].dst.numpy()[m], n)
        assert _same(analysis.kind, host_got, want), (kind, schedule)


# ------------------------------------------------------------------- spans
def _recorded(tracer):
    """The merge's spans. The per-round forest spans (``kernel/forest/*``)
    nested in them carry each package's own path and byte model, and
    ``tests/test_torch_obs.py`` holds them against the reference."""
    return [(s["name"], s["depth"], s["attrs"]) for s in tracer.spans()
            if s["name"].startswith("merge/")]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_simulator_spans_match(schedule):
    """One simulated merge and one churn run record the same merge span
    names, nesting and attributes under both tracers."""
    src, dst, n = CASES["barbell"]()
    ksrc, kdst = np.array([0], np.int32), np.array([1], np.int32)
    jt = j_obs.enable_tracing()
    try:
        jm.simulate_merge_host(
            _jax_local(_jax_shards(src, dst, n, M),
                       j_certificate_builder("2ec")), schedule, grid=GRID)
        jm.simulate_churn_host(_jax_shards(src, dst, n, M), ksrc, kdst,
                               schedule, grid=GRID)
    finally:
        j_obs.disable_tracing()
    tt = obs.enable_tracing()
    try:
        tm.simulate_merge_host(
            [certificate_builder("2ec")(sh, capacity=certificate_capacity(n))
             for sh in _torch_shards(src, dst, n, M)], schedule, grid=GRID)
        tm.simulate_churn_host(_torch_shards(src, dst, n, M), ksrc, kdst,
                               schedule, grid=GRID)
    finally:
        obs.disable_tracing()
    assert _recorded(tt) == _recorded(jt)
    assert {name for name, _, _ in _recorded(tt)} >= {
        "merge/level0", "merge/machine", "merge/recertify"}
    assert obs.get_tracer() is obs.NULL_TRACER


def test_tracer_rollup_and_null_tracer():
    tr = obs.Tracer()
    with tr.span("merge/level0", machines=2) as outer:
        with tr.span("merge/machine", machine=0) as sp:
            x = sp.sync(torch.ones(3))  # a CPU tensor: no wait
        with tr.span("merge/machine", machine=1):
            pass
    assert x.sum() == 3 and outer.dur >= 0
    roll = tr.rollup()
    assert roll["merge/machine"]["count"] == 2
    assert roll["merge/level0"]["self_s"] <= roll["merge/level0"]["total_s"]
    assert [s["depth"] for s in tr.spans()] == [0, 1, 1]
    null = obs.NullTracer()
    with null.span("x") as sp:
        assert sp.sync(5) == 5
    assert null.spans() == [] and null.rollup() == {}
    el = EdgeList(torch.zeros(2, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.bool), 2)
    assert obs.tracer.cuda_devices([el, (el.src, {"k": el.mask})]) == set()
