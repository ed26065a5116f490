"""Port parity of the failure-point analyses: the host oracles, every
``*_from_state`` device function, the analysis registry and the
``analyze`` entry point for every kind × valid certificate × final stage,
against ``repro`` (JAX on the CPU: ``BridgeEngine().analyze`` and the
same functions on the same state), the host Tarjan references and
networkx, on the same numpy inputs (``device="cpu"``).

Tolerance: exact equality (every output is an integer, a boolean or a set
of them).
"""
import dataclasses

import networkx as nx
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.connectivity import common as jcommon
from repro.connectivity import device as jdev
from repro.connectivity import host as jhost
from repro.connectivity import registry as jreg
from repro.engine import BridgeEngine
from repro.engine.batched import make_analysis_fn as j_make_analysis_fn
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch import (
    analyze,
    find_bcc,
    find_bridge_tree,
    find_bridges,
    find_cuts,
    find_two_ecc,
)
from repro_torch.connectivity import common as tcommon
from repro_torch.connectivity import device as tdev
from repro_torch.connectivity import host as thost
from repro_torch.connectivity import registry as treg
from repro_torch.core.api import pad_graph, resolve_certificate
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.interop import edgelist_from_numpy

from helpers import to_graph

ENGINE = BridgeEngine()  # one engine: each JAX program compiles once

KINDS = ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")
#: every (kind, certificate) the registry allows: an override must preserve
#: what the kind's default does
COMBOS = [("bridges", "2ec"), ("2ecc", "2ec"), ("bridge_tree", "2ec"),
          ("cuts", "sfs"), ("cuts", "hybrid"), ("bcc", "sfs"),
          ("bcc", "hybrid")]


def _worlds():
    """(name, src, dst, n, simple): failure scenarios, a planted world, a
    multigraph with a self-loop, a path, and an isolated vertex 0."""
    out = [(sc["name"], sc["src"], sc["dst"], sc["n"], True)
           for sc in gen.failure_scenarios()]
    s, d, _ = gen.planted_bridge_graph(60, 400, 2, seed=0)
    out.append(("planted60", s, d, 60, True))
    out.append(("multigraph", np.array([0, 1, 1, 2, 3, 3, 4, 2], np.int32),
                np.array([1, 2, 2, 3, 4, 3, 2, 0], np.int32), 6, False))
    path = np.arange(47, dtype=np.int32)
    out.append(("path", path, path + 1, 48, True))
    out.append(("isolated0", np.array([1, 2, 3, 3], np.int32),
                np.array([2, 3, 1, 4], np.int32), 6, True))
    return out


WORLDS = _worlds()
IDS = [w[0] for w in WORLDS]


def _same(kind, got, want):
    if kind == "2ecc":
        return np.array_equal(np.asarray(got), np.asarray(want))
    return got == want


def _nx(kind, src, dst, n):
    """networkx's answer for a simple graph."""
    G = to_graph(src, dst, n)
    if kind == "bridges":
        return set((min(u, v), max(u, v)) for u, v in nx.bridges(G))
    if kind == "cuts":
        return set(nx.articulation_points(G))
    if kind == "bcc":
        return set(map(frozenset, nx.biconnected_components(G)))
    labels = np.arange(n)
    for comp in nx.k_edge_components(G, 2):
        labels[list(comp)] = min(comp)
    if kind == "2ecc":
        return labels
    return set((int(min(labels[u], labels[v])), int(max(labels[u], labels[v])))
               for u, v in nx.bridges(G))


# ------------------------------------------------------------- host oracles
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_host_oracles_match(world):
    _, src, dst, n, simple = world
    for kind in KINDS:
        jfn = jreg.get_analysis(kind).host_fn
        tfn = treg.get_analysis(kind).host_fn
        got = tfn(src, dst, n)
        assert _same(kind, got, jfn(src, dst, n))
        if simple:
            assert _same(kind, got, _nx(kind, src, dst, n))
    assert thost.articulation_points_dfs is treg.get_analysis("cuts").host_fn


# ------------------------------------------------------ state-level finals
def _state_pair(src, dst, n):
    """The padded buffer and its tour state in both packages."""
    el = pad_graph(src, dst, n, device="cpu")
    jel = jds.EdgeList.from_arrays(src, dst, el.n_nodes, capacity=el.capacity)
    jst = jcommon.tour_state(jel.src, jel.dst, jel.mask, el.n_nodes)
    tst = tcommon.tour_state(el.src, el.dst, el.mask, el.n_nodes)
    return jel, el, jst, tst


def _equal(a, b):
    if isinstance(b, torch.Tensor):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)


_STATE_FNS = ("block_labels_from_state", "articulation_from_state",
              "bcc_from_state")


def _from_state_all(mod, st, src, dst, mask, n):
    """Every ``*_from_state`` function of ``mod`` on one tour state."""
    out = [getattr(mod, name)(src, dst, mask, n, st) for name in _STATE_FNS]
    ecc = mod.two_ecc_from_state(src, dst, mask, n, st["bridge"])
    bt = mod.bridge_tree_from_state(src, dst, mask, n, st["bridge"], ecc,
                                    max(n - 1, 1))
    return out + [ecc, (bt.src, bt.dst, bt.mask)]


@jax.jit
def _j_from_state_all(jst, src, dst, mask):
    return _from_state_all(jdev, jst, src, dst, mask, jst["is_root"].shape[0])


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_from_state_functions_match(world):
    """Each ``*_from_state`` function on the same tour state (each
    package's own, itself checked field for field in
    tests/test_torch_euler.py)."""
    _, src, dst, n, _ = world
    jel, el, jst, tst = _state_pair(src, dst, n)
    _equal(_j_from_state_all(jst, jel.src, jel.dst, jel.mask),
           _from_state_all(tdev, tst, el.src, el.dst, el.mask, el.n_nodes))


@pytest.mark.parametrize("world", WORLDS[:2], ids=IDS[:2])
def test_device_api_matches(world):
    _, src, dst, n, _ = world
    jel, el, _, _ = _state_pair(src, dst, n)
    _equal(jdev.articulation_mask(jel), tdev.articulation_mask(el))
    assert tdev.articulation_points(el) == jdev.articulation_points(jel)
    assert tdev.bcc_blocks(el) == jdev.bcc_blocks(jel)
    _equal(jdev.two_ecc_labels(jel), tdev.two_ecc_labels(el))
    jbt, tbt = jdev.bridge_tree(jel), tdev.bridge_tree(el)
    _equal((jbt.src, jbt.dst, jbt.mask), (tbt.src, tbt.dst, tbt.mask))


# ----------------------------------------------------------------- analyze
@pytest.mark.parametrize("final", ["device", "host"])
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_analyze_matches_jax_and_oracles(world, final):
    """Every kind × valid certificate: the port's answer equals
    ``BridgeEngine().analyze`` and the host oracle, and networkx on simple
    worlds. (The sfs/hybrid multigraph contract covers the vertex kinds
    only, as in the JAX package; the 2-edge kinds ride ``2ec``.)"""
    _, src, dst, n, simple = world
    for kind, cert in COMBOS:
        got = analyze(src, dst, n, kind=kind, final=final, certificate=cert,
                      device="cpu")
        want = ENGINE.analyze(src, dst, n, kind=kind, final=final,
                              certificate=cert)
        assert _same(kind, got, want), (kind, cert)
        assert _same(kind, got, thost_ref(kind, src, dst, n)), (kind, cert)
        if simple:
            assert _same(kind, got, _nx(kind, src, dst, n)), (kind, cert)


def thost_ref(kind, src, dst, n):
    return treg.get_analysis(kind).host_fn(np.asarray(src, np.int32),
                                           np.asarray(dst, np.int32), n)


@pytest.mark.parametrize("final", ["device", "host"])
def test_analysis_fn_buffers_match_jax(final):
    """The pipeline's buffers themselves, slot for slot, for every kind ×
    valid certificate on the planted world."""
    _, src, dst, n, _ = WORLDS[IDS.index("planted60")]
    el = pad_graph(src, dst, n, device="cpu")
    jel = jds.EdgeList.from_arrays(src, dst, el.n_nodes, capacity=el.capacity)
    for kind, cert in COMBOS:
        want = j_make_analysis_fn(el.n_nodes, kind, final, certificate=cert)(
            jel.src, jel.dst, jel.mask)
        got = make_analysis_fn(el.n_nodes, kind, final, certificate=cert)(
            el.src, el.dst, el.mask)
        _equal(want, got)
        # the declared result shapes, for the device final
        if final == "device":
            jspec = jreg.get_analysis(kind).out_struct(el.n_nodes, el.capacity)
            tspec = treg.get_analysis(kind).out_struct(el.n_nodes, el.capacity)
            jflat = jax.tree_util.tree_leaves(jspec)
            tflat = [tspec] if isinstance(tspec[0], tuple) and not isinstance(
                tspec[0][0], tuple) else list(tspec)
            got_flat = [got] if isinstance(got, torch.Tensor) else list(got)
            assert len(jflat) == len(tflat) == len(got_flat)
            for j, (shape, dtype), g in zip(jflat, tflat, got_flat):
                assert tuple(j.shape) == shape == tuple(g.shape)
                assert g.dtype == dtype
                assert np.dtype(j.dtype) == g.numpy().dtype


def test_planted_truth_every_kind():
    """The planted layout's truth (blobs joined by single edges), which
    ``chip_smoke.py`` checks at the paper's size, on a small instance."""
    k = 3
    s, d, planted = gen.planted_bridge_graph(300, 3000, k - 1, seed=1)
    starts = [0, 100, 200]
    cuts = {v for pair in planted for v in pair}
    blocks = {frozenset(range(a, a + 100)) for a in starts} | {
        frozenset(p) for p in planted}
    labels = np.repeat(starts, 100)
    tree = {(starts[i], starts[i + 1]) for i in range(k - 1)}
    for final in ("device", "host"):
        assert analyze(s, d, 300, final=final, device="cpu") == planted
        assert analyze(s, d, 300, kind="cuts", final=final,
                       device="cpu") == cuts
        assert analyze(s, d, 300, kind="bcc", final=final,
                       device="cpu") == blocks
        assert np.array_equal(analyze(s, d, 300, kind="2ecc", final=final,
                                      device="cpu"), labels)
        assert analyze(s, d, 300, kind="bridge_tree", final=final,
                       device="cpu") == tree


def test_find_methods_match_analyze():
    sc = gen.failure_scenarios()[1]
    args = (sc["src"], sc["dst"], sc["n"])
    assert find_cuts(*args, device="cpu") == sc["cuts"]
    assert find_bcc(*args, device="cpu") == analyze(*args, kind="bcc",
                                                    device="cpu")
    assert np.array_equal(find_two_ecc(*args, device="cpu"),
                          ENGINE.find_two_ecc(*args))
    assert find_bridge_tree(*args, device="cpu") == ENGINE.find_bridge_tree(
        *args)
    assert find_bridges(*args, device="cpu") == sc["bridges"]
    assert len(np.unique(find_two_ecc(*args, device="cpu"))) == sc["n_2ecc"]


# ---------------------------------------------------------------- registry
def test_registry_matches_jax():
    assert treg.ANALYSIS_KINDS == jreg.ANALYSIS_KINDS == KINDS
    for kind in KINDS:
        a, b = jreg.get_analysis(kind), treg.get_analysis(kind)
        assert (a.kind, a.result, a.certificate, a.incremental,
                a.decremental, a.device_input) == (
            b.kind, b.result, b.certificate, b.incremental, b.decremental,
            b.device_input)
    for alias, kind in (("two_ecc", "2ecc"), ("blocks", "bcc"),
                        ("bridge-tree", "bridge_tree"), ("CUTS", "cuts")):
        assert treg.normalize_kind(alias) == jreg.normalize_kind(alias) == kind


def test_registry_validation_errors():
    with pytest.raises(ValueError, match="unknown analysis kind"):
        treg.normalize_kind("nope")
    with pytest.raises(ValueError, match="unknown analysis kind"):
        analyze([0], [1], 2, kind="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown certificate type"):
        treg.register(dataclasses.replace(treg.get_analysis("bridges"),
                                          kind="broken", certificate="nope"))
    assert "broken" not in treg.analysis_kinds()
    # a per-call override must preserve what the kind's default does
    with pytest.raises(ValueError, match="does not preserve"):
        resolve_certificate("cuts", "2ec")
    with pytest.raises(ValueError, match="does not preserve"):
        resolve_certificate("bridges", "hybrid")
    with pytest.raises(ValueError, match="does not preserve"):
        analyze([0], [1], 2, kind="cuts", final="host", certificate="2ec",
                device="cpu")
    with pytest.raises(ValueError, match="does not preserve"):
        ENGINE._resolve_certificate(jreg.get_analysis("cuts"), "2ec")
    with pytest.raises(ValueError, match="choose from"):
        resolve_certificate("cuts", "nope")
    with pytest.raises(ValueError, match="unknown final stage"):
        make_analysis_fn(16, "cuts", final="tpu")
    assert resolve_certificate("cuts", "hybrid") == "hybrid"
    assert resolve_certificate("bcc") == "sfs"
    assert resolve_certificate("2ecc") == "2ec"


def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = gen.failure_scenarios()[0]
    args = (sc["src"], sc["dst"], sc["n"])
    for fn in (find_cuts, find_bcc, find_two_ecc, find_bridge_tree):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze(*args, kind="cuts", final="host")
    assert analyze(*args, kind="cuts", final="host",
                   device="cpu") == sc["cuts"]


def test_edgelist_interop_for_state_pair():
    """The buffers both packages analyze are the same bytes."""
    _, src, dst, n, _ = WORLDS[0]
    jel, el, _, _ = _state_pair(src, dst, n)
    again = edgelist_from_numpy(np.asarray(jel.src), np.asarray(jel.dst),
                                np.asarray(jel.mask), el.n_nodes,
                                device="cpu")
    for a, b in ((el.src, again.src), (el.dst, again.dst),
                 (el.mask, again.mask)):
        assert torch.equal(a, b)


# ------------------------------------------- ids outside the vertex range
def outcome(fn):
    """``("value", answer)`` or ``("raises", exception type)``."""
    try:
        return "value", fn()
    except Exception as exc:  # the reference's exception type is the test
        return "raises", type(exc)


def same_outcome(kind, got, want) -> bool:
    if got[0] != want[0]:
        return False
    return got[1] is want[1] if got[0] == "raises" \
        else _same(kind, got[1], want[1])


#: graphs naming a vertex outside [0, n): JAX's gathers clamp, its
#: ``.at[].set(mode="drop")`` and ``segment_min/max`` drop
OUT_OF_RANGE = {
    "dst_at_n": ([0], [16], 16),
    "negative_src": ([-1], [0], 2),
    "src_at_n": ([16], [0], 16),
    "negative_in_bucket": ([-1], [0], 16),
    "path_into_n": ([0, 1, 16], [1, 2, 3], 16),
    "past_n": ([0, 1, 2], [1, 2, 17], 16),
    "cycle_with_negative": ([0, 1, 2, -3], [1, 2, 3, 0], 16),
    "far_out": ([0, 1, 2, 100, -40], [1, 2, 0, 3, 1], 16),
}


@pytest.mark.parametrize("final", ["device", "host"])
@pytest.mark.parametrize("graph", list(OUT_OF_RANGE))
def test_out_of_range_ids_answer_as_jax(graph, final):
    """Every kind × valid certificate on ids outside ``[0, n)``: the port
    answers as ``repro`` does, or raises the same exception type (the
    host finals' DFS raises ``IndexError`` on an id >= n), and a device
    final never raises where the reference answers."""
    src, dst, n = OUT_OF_RANGE[graph]
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    for kind, cert in COMBOS:
        want = outcome(lambda: ENGINE.analyze(src, dst, n, kind=kind,
                                              final=final, certificate=cert))
        got = outcome(lambda: analyze(src, dst, n, kind=kind, final=final,
                                      certificate=cert, device="cpu"))
        assert same_outcome(kind, got, want), (kind, cert, got, want)
        if final == "device":
            assert got[0] == "value", (kind, cert, got)


def test_segment_reduce_and_set_drop_follow_jax():
    """The two scatters of the device final: ids outside ``[0, n)`` drop
    from ``segment_min``/``segment_max``; ``.at[].set(mode="drop")`` wraps
    an index in ``[-n, -1]`` and drops the rest."""
    vals = np.array([5, 1, 7, 3, 9, 2], np.int32)
    ids = np.array([-1, 0, 4, -5, 2, 2 ** 31 - 1], np.int32)  # no repeat
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    for reduce, jfn, ident in (("amin", jax.ops.segment_min, tcommon.INF32),
                               ("amax", jax.ops.segment_max,
                                tcommon.INT32_MIN)):
        got = tcommon._segment_reduce(tv, ti, 4, reduce, ident)
        assert np.array_equal(got.numpy(),
                              np.asarray(jfn(vals, ids, num_segments=4)))
    want = jax.numpy.full(4, -7, jax.numpy.int32).at[ids].set(
        vals, mode="drop")
    got = tcommon._set_drop(4, -7, ti, tv)
    assert np.array_equal(got.numpy(), np.asarray(want))
