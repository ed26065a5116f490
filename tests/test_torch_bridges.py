"""End-to-end parity of the port's slice: ``repro_torch.find_bridges`` with
``final="host"`` and ``final="device"`` on ``device="cpu"`` against
``repro`` (JAX on the CPU, defaults), the host Tarjan ``bridges_dfs`` and
networkx. Tolerance: exact equality of the bridge sets."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.bridges_dense import SMOKE
from repro.connectivity.device import bridge_mask as j_bridge_mask
from repro.connectivity.device import bridges as j_bridges
from repro.core.api import find_bridges as j_find_bridges
from repro.core.bridges_host import bridges_dfs as j_bridges_dfs
from repro.engine.batched import make_analysis_fn as j_make_analysis_fn
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch import find_bridges
from repro_torch.connectivity.device import bridge_mask, bridges
from repro_torch.core.api import pad_graph
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.interop import edgelist_to_numpy

from helpers import bucketed_graph, nx_bridges


def _worlds():
    """(name, src, dst, n, planted bridges or None)."""
    out = [(f"scenario{i}", sc["src"], sc["dst"], sc["n"], sc["bridges"])
           for i, sc in enumerate(gen.failure_scenarios())]
    for seed, (n, m, k) in enumerate([(60, 400, 2), (300, 3000, 5)]):
        s, d, b = gen.planted_bridge_graph(n, m, k, seed=seed)
        out.append((f"planted{n}", s, d, n, b))
    s, d, b = gen.planted_bridge_graph(SMOKE.n_nodes, SMOKE.n_edges, 3, seed=0)
    out.append(("smoke", s, d, SMOKE.n_nodes, b))
    # a doubled edge is not a bridge; its single neighbours on the path are
    out.append(("multigraph", np.array([0, 1, 1, 2, 3], np.int32),
                np.array([1, 2, 2, 3, 4], np.int32), 5,
                {(0, 1), (2, 3), (3, 4)}))
    # vertex 0 isolated; a triangle with a pendant vertex elsewhere
    out.append(("isolated0", np.array([1, 2, 3, 3], np.int32),
                np.array([2, 3, 1, 4], np.int32), 6, {(3, 4)}))
    src, dst, n, _ = bucketed_graph(5, simple=False)
    out.append(("bucket5m", src, dst, n, None))
    return out


WORLDS = _worlds()
IDS = [w[0] for w in WORLDS]


@pytest.mark.parametrize("final", ["host", "device"])
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_find_bridges_matches_jax_and_oracles(world, final):
    _, src, dst, n, planted = world
    got = find_bridges(src, dst, n, final=final, device="cpu")
    assert got == j_find_bridges(src, dst, n, final=final)
    assert got == bridges_dfs(src, dst, n) == j_bridges_dfs(src, dst, n)
    if planted is not None:
        assert got == planted
    simple = len({(min(a, b), max(a, b)) for a, b in zip(src, dst)}) == len(src)
    if simple:  # networkx collapses parallel edges
        assert got == nx_bridges(src, dst, n)


@pytest.mark.parametrize("final", ["host", "device"])
@pytest.mark.parametrize("idx", [0, 3])
def test_analysis_fn_buffers_match_jax(idx, final):
    """The pipeline's device buffers themselves (the certificate, or the
    compacted bridge buffer) match the JAX engine's slot for slot."""
    _, src, dst, n, _ = WORLDS[idx]
    el = pad_graph(src, dst, n, device="cpu")
    jel = jds.EdgeList.from_arrays(src, dst, el.n_nodes, capacity=el.capacity)
    want = jax.jit(j_make_analysis_fn(el.n_nodes, "bridges", final))(
        jel.src, jel.dst, jel.mask)
    got = make_analysis_fn(el.n_nodes, final=final)(el.src, el.dst, el.mask)
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_device_final_matches_jax(world):
    """The device final on the whole padded buffer: the bridge mask and the
    compacted bridge buffer match the JAX package's slot for slot."""
    _, src, dst, n, _ = world
    el = pad_graph(src, dst, n, device="cpu")
    jel = jds.EdgeList.from_arrays(src, dst, el.n_nodes, capacity=el.capacity)
    assert np.array_equal(np.asarray(j_bridge_mask(jel)),
                          bridge_mask(el).numpy())
    want, got = j_bridges(jel), bridges(el)
    for a, b in zip((want.src, want.dst, want.mask),
                    (got.src, got.dst, got.mask)):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_pad_graph_is_the_engine_bucket():
    src, dst, n, _ = bucketed_graph(1)
    el = pad_graph(src, dst, n, device="cpu")
    assert el.n_nodes == jds.admission_capacity(n, 16)
    assert el.capacity == jds.admission_capacity(len(src), 16)
    s, d, m = edgelist_to_numpy(el)
    assert m.sum() == len(src) and not s[~m].any() and not d[~m].any()


def test_entry_point_needs_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = gen.failure_scenarios()[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        find_bridges(sc["src"], sc["dst"], sc["n"])
    assert find_bridges(sc["src"], sc["dst"], sc["n"],
                        device="cpu") == sc["bridges"]


def test_unknown_final_stage_raises():
    with pytest.raises(ValueError, match="unknown final stage"):
        make_analysis_fn(16, final="tpu")
