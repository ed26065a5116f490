"""Port parity of the paper's Fig. 5 baseline and of its configs: the same
numpy inputs through ``repro.core.baseline_savage_jaja`` (JAX on the CPU,
jitted) and ``repro_torch.core.baseline_savage_jaja`` (``device="cpu"``);
``repro.configs.get`` against ``repro_torch.configs.get``. Tolerance:
exact equality (the mask is boolean, the configs are literals). Every
graph keeps n <= 48: the reference materialises E x n x n floats."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.core.baseline_savage_jaja import bridges_savage_jaja as j_baseline
from repro.core.bridges_host import bridges_dfs
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch import configs as tconfigs
from repro_torch.core import baseline_savage_jaja as baseline
from repro_torch.core.baseline_savage_jaja import (
    bridges_savage_jaja,
    chunk_slots,
    closure_squarings,
)
from repro_torch.interop import edgelist_from_numpy


def _graph(src, dst, n, mask=None, capacity=None):
    """(src, dst, mask) numpy buffers of one padded edge list."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if mask is None:
        mask = np.ones(len(src), bool)
    if capacity is not None:
        pad = capacity - len(src)
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    return src, dst, np.asarray(mask, bool), n


def _fig5(e):
    s, d = gen.random_graph(48, e, seed=3)
    return _graph(s, d, 48)


def _planted(n, m, k, seed):
    s, d, _ = gen.planted_bridge_graph(n, m, k, seed=seed)
    return _graph(s, d, n)


def _self_loops():
    s, d, _ = gen.planted_bridge_graph(30, 80, 2, seed=5)
    return _graph(np.concatenate([s, [3, 7, 7]]),
                  np.concatenate([d, [3, 7, 7]]), 30)


def _doubled_cycle_edges():
    """A 6-cycle with a pendant path; two cycle edges doubled (the
    doubling changes no answer)."""
    s = [0, 1, 2, 3, 4, 5, 0, 1, 5, 6]
    d = [1, 2, 3, 4, 5, 0, 1, 2, 6, 7]
    return _graph(s, d, 8)


def _masked_slots():
    """Real edges masked off mid-buffer (an ``EdgeList`` whose false slots
    hold endpoints), padded to 64 slots: a masked edge that would close a
    cycle leaves its path's edges bridges."""
    s = [0, 1, 2, 2, 3, 4, 5, 6, 6, 0]
    d = [1, 2, 0, 3, 4, 5, 6, 7, 3, 3]
    mask = [True, True, True, True, True, False, True, True, False, True]
    return _graph(s, d, 8, mask=mask, capacity=64)


def _disconnected():
    """Two planted worlds side by side, and isolated vertices."""
    s1, d1, _ = gen.planted_bridge_graph(20, 50, 2, seed=1)
    s2, d2, _ = gen.planted_bridge_graph(20, 50, 3, seed=2)
    return _graph(np.concatenate([s1, s2 + 20]), np.concatenate([d1, d2 + 20]),
                  44)


#: (name, graph builder) of every graph the mask is held on
GRAPHS = {
    "fig5_e64": lambda: _fig5(64),
    "fig5_e256": lambda: _fig5(256),
    "planted_a": lambda: _planted(40, 120, 3, 0),
    "planted_b": lambda: _planted(48, 200, 5, 7),
    "self_loops": _self_loops,
    "doubled_cycle_edges": _doubled_cycle_edges,
    "masked_slots": _masked_slots,
    "disconnected": _disconnected,
    "n1_empty": lambda: _graph([0], [0], 1, mask=[False]),
    "n1_self_loop": lambda: _graph([0], [0], 1),
    "n2_edge": lambda: _graph([0], [1], 2),
    "n2_padded": lambda: _graph([1], [0], 2, capacity=16),
}


def _masks(src, dst, mask, n):
    jel = jds.EdgeList(src, dst, mask, n)
    want = np.asarray(j_baseline(jel))
    tel = edgelist_from_numpy(src, dst, mask, n, device="cpu")
    got = bridges_savage_jaja(tel)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    return got.numpy(), want


def _pairs(src, dst, bridge_mask) -> set:
    return {(min(int(a), int(b)), max(int(a), int(b)))
            for a, b in zip(src[bridge_mask], dst[bridge_mask])}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_baseline_mask_matches_reference_and_host_tarjan(name):
    src, dst, mask, n = GRAPHS[name]()
    got, want = _masks(src, dst, mask, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _pairs(src, dst, got) == bridges_dfs(src[mask], dst[mask], n)


def test_doubled_bridge_is_a_bridge_to_both_baselines():
    """A difference inside the reference, followed by the port: removing a
    tree edge clears its adjacency entry, so the baseline calls a doubled
    bridge a bridge where the host Tarjan (parallel edges by edge id) does
    not. Both packages give the same mask."""
    src, dst, mask, n = _graph([0, 1, 1, 2, 3, 4], [1, 2, 2, 3, 4, 2], 5)
    got, want = _masks(src, dst, mask, n)
    assert np.array_equal(got, want)
    assert _pairs(src, dst, got) == {(0, 1), (1, 2)}
    assert bridges_dfs(src, dst, n) == {(0, 1)}


@pytest.mark.parametrize("chunk", [1, 7, 255, 4096])
def test_baseline_chunks_give_one_mask(monkeypatch, chunk):
    """Cutting the edge axis into chunks of any size changes no slot."""
    monkeypatch.setattr(baseline, "CHUNK_BYTES", chunk * 8 * 48 * 48)
    assert chunk_slots(48) == chunk
    src, dst, mask, n = _fig5(256)
    got, want = _masks(src, dst, mask, n)
    assert np.array_equal(got, want)


def test_closure_squarings_and_chunks():
    assert [closure_squarings(n) for n in (1, 2, 3, 48, 128, 129)] == \
        [1, 1, 2, 6, 7, 8]
    assert chunk_slots(128) == (1 << 28) // (8 * 128 * 128) == 2048
    assert chunk_slots(1 << 14) == 1


def test_baseline_refuses_ids_outside_the_graph():
    tel = edgelist_from_numpy(np.array([0, 5], np.int32),
                              np.array([1, 1], np.int32),
                              np.array([True, True]), 4, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        bridges_savage_jaja(tel)


def test_baseline_restores_the_matmul_precision():
    src, dst, mask, n = _fig5(64)
    tel = edgelist_from_numpy(src, dst, mask, n, device="cpu")
    before = torch.get_float32_matmul_precision()
    bridges_savage_jaja(tel)
    assert torch.get_float32_matmul_precision() == before


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", ["bridges_dense", "bridges-dense",
                                     "sasrec"])
def test_config_get_matches_reference(arch_id):
    """Field for field; the port's ``SASRecConfig`` has every field of the
    reference's but ``scan_unroll``, its dry-run mode for XLA cost analysis
    (``src/repro_torch/models/recsys.py``), which must be off there."""
    want, got = jconfigs.get(arch_id), tconfigs.get(arch_id)
    want_d, got_d = dataclasses.asdict(want), dataclasses.asdict(got)
    for key in ("config", "smoke_config"):
        if "scan_unroll" in want_d[key]:
            assert want_d[key].pop("scan_unroll") is False
    assert got_d == want_d
    assert type(got.config).__name__ == type(want.config).__name__


def test_bridges_dense_config_and_paper_shapes_match_reference():
    from repro.configs import bridges_dense as jb
    from repro_torch.configs import bridges_dense as tb

    assert tconfigs.PAPER_SHAPES == jconfigs.PAPER_SHAPES
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(tb, name)) == \
            dataclasses.asdict(getattr(jb, name))
    assert (tb.CONFIG.n_nodes, tb.CONFIG.n_edges) == (100_000, 10_000_000)
    assert tconfigs.get("bridges_dense").shapes is tconfigs.PAPER_SHAPES


def test_config_get_refuses_unknown_ids_as_reference():
    for get in (jconfigs.get, tconfigs.get):
        with pytest.raises(ModuleNotFoundError):
            get("no-such-arch")
