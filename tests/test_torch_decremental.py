"""Port parity of decremental serving (``repro_torch.engine``) against
``repro.engine`` (JAX on the CPU), mirroring the engine cases of
``tests/test_decremental.py``: ``delete_edges`` on the live graph (the
tombstone and the certificate-hit rebuild rule, free path and rebuild
path), interleaved churn under every certificate, one-shot ``delete=``
and per-graph ``delete=`` in ``analyze_batch``.

After every call the two engines' answers, live buffers (every
materialized certificate state slot for slot, the full buffer) and
``snapshot()`` counters are held equal (``torch_engine_pair``), and the
answers against a host recompute of the kind's reference on the tracked
live edge multiset (a deletion removes every copy of an unordered pair).

Shapes: one bucket family (n = 48 -> n_bucket 64, base edges -> 256 slots,
deltas and keys -> 16) on one shared pair of engines.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.connectivity import registry as jregistry
from repro.engine import batched as jbatched
from repro.graph import generators as gen
from repro_torch.connectivity import registry as tregistry
from repro_torch.engine import BatchedEdgeList, BridgeEngine

from torch_engine_pair import EnginePair, assert_buffers_equal

N, E0 = 48, 150
DELTA = 12
KINDS = ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")

PAIR = EnginePair()


def _host(kind, pairs, n=N):
    s = np.array([x for x, _ in pairs], np.int32)
    d = np.array([y for _, y in pairs], np.int32)
    return jregistry.get_analysis(kind).host_fn(s, d, n)


def _agrees(got, want) -> bool:
    """An answer against the host recompute (2ECC labels by value)."""
    if isinstance(want, np.ndarray):
        return np.array_equal(got, want)
    return got == want


def _keys(pairs):
    return (np.array([x for x, _ in pairs], np.int32),
            np.array([y for _, y in pairs], np.int32))


def _drop(pairs, dels):
    kset = set((min(x, y), max(x, y)) for x, y in dels)
    return [(x, y) for x, y in pairs if (min(x, y), max(x, y)) not in kset]


def _base(seed=1):
    s, d = gen.random_graph(N, E0, seed=seed)
    return s, d, list(zip(s.tolist(), d.tolist()))


def _cert_pairs(name="2ec"):
    cs, cd, cm = (x.numpy() for x in PAIR.torch._live.certs[name][:3])
    return list(zip(cs[cm].tolist(), cd[cm].tolist()))


# ------------------------------------------------------------- live serving
def test_delete_bridge_edge_rebuilds_and_answers():
    PAIR.call("load", np.array([0, 1, 2, 3], np.int32),
              np.array([1, 2, 3, 0], np.int32), N)
    assert PAIR.call("current_bridges") == set()
    assert PAIR.call("delete_edges", [0], [1]) == {(1, 2), (2, 3), (0, 3)}
    assert PAIR.torch.live_rebuilds["2ec"] == 1
    assert PAIR.torch.num_live_graph_edges == 3
    assert PAIR.call("insert_edges", [1], [0]) == set()


def test_noncertificate_deletion_is_free():
    s, d, pairs = _base()
    PAIR.call("load", s, d, N)
    certset = set((min(p), max(p)) for p in _cert_pairs())
    PAIR.call("current_analysis", "cuts")  # materialize the SFS pair
    certset |= set((min(p), max(p)) for p in _cert_pairs("sfs"))
    noncert = [p for p in pairs if (min(p), max(p)) not in certset][:DELTA]
    assert noncert
    got = PAIR.call("delete_edges", *_keys(noncert), kind="bridges")
    assert PAIR.torch.live_rebuilds == {"2ec": 0, "sfs": 0}
    live = _drop(pairs, noncert)
    assert got == _host("bridges", live)
    assert PAIR.call("current_analysis", "cuts") == _host("cuts", live)


@pytest.mark.parametrize("kind", KINDS)
def test_certificate_hit_delete_matches_reference(kind):
    s, d, pairs = _base()
    PAIR.call("load", s, d, N)
    dels = _cert_pairs()[:3]
    got = PAIR.call("delete_edges", *_keys(dels), kind=kind)
    assert PAIR.torch.live_rebuilds["2ec"] == 1
    assert _agrees(got, _host(kind, _drop(pairs, dels)))


@pytest.mark.parametrize("certificate", ["sfs", "hybrid"])
def test_interleaved_churn_matches_reference(certificate):
    """Inserts and deletions (free and rebuild paths) under the lazy vertex
    certificates, every kind answered after each; no new program after the
    warm-up."""
    s, d, live = _base(seed=3)
    PAIR.call("load", s, d, N)
    rng = np.random.default_rng(7)

    def insert(seed):
        ds, dd = gen.random_graph(N, DELTA, seed=seed)
        live.extend(zip(ds.tolist(), dd.tolist()))
        return PAIR.call("insert_edges", ds, dd, kind="cuts",
                         certificate=certificate)

    def delete(rebuild):
        pick = ([_cert_pairs(certificate)[0], live[0]] if rebuild else
                [live[i] for i in rng.choice(len(live), 5, replace=False)])
        live[:] = _drop(live, pick)
        return PAIR.call("delete_edges", *_keys(pick), kind="bcc",
                         certificate=certificate)

    for kind in KINDS:
        PAIR.call("current_analysis", kind)
    PAIR.call("current_analysis", "cuts", certificate=certificate)
    insert(100)
    delete(True)
    insert(101)
    traces = PAIR.torch.stats.traces
    for step in range(4):
        got = delete(step % 2 == 0) if step % 3 else insert(200 + step)
        assert got is not None
        for kind in KINDS:
            assert _agrees(PAIR.call("current_analysis", kind),
                           _host(kind, live)), (step, kind)
        assert _agrees(PAIR.call("current_analysis", "bcc",
                                 certificate=certificate),
                       _host("bcc", live))
    assert PAIR.torch.stats.traces == traces
    assert PAIR.torch.num_live_graph_edges == len(live)
    assert PAIR.torch.live_rebuilds[certificate] >= 1


def test_delete_requires_load_and_valid_kind():
    with pytest.raises(RuntimeError, match="load"):
        BridgeEngine(device="cpu").delete_edges([0], [1])
    s, d, _ = _base()
    eng = BridgeEngine(device="cpu").load(s, d, N)
    with pytest.raises(ValueError, match="unknown analysis kind"):
        eng.delete_edges([0], [1], kind="nope")


def test_non_decremental_kind_refused():
    frozen = dataclasses.replace(tregistry.get_analysis("bridges"),
                                 kind="frozen_kind", decremental=False)
    tregistry.register(frozen)
    try:
        s, d, _ = _base()
        eng = BridgeEngine(device="cpu").load(s, d, N)
        with pytest.raises(NotImplementedError, match="decremental"):
            eng.delete_edges([0], [1], kind="frozen_kind")
    finally:
        tregistry._REGISTRY.pop("frozen_kind")


# ----------------------------------------------------- one-shot and batched
@pytest.mark.parametrize("final", ["device", "host"])
def test_one_shot_analyze_delete_all_kinds_cached(final):
    s, d, pairs = _base(seed=5)
    dels = pairs[::7][:10]
    live = _drop(pairs, dels)
    for kind in KINDS:
        got = PAIR.call("analyze", s, d, N, kind=kind, final=final,
                        delete=_keys(dels))
        assert _agrees(got, _host(kind, live)), kind
    traces = PAIR.torch.stats.traces
    dels2 = pairs[1::7][:8]
    got = PAIR.call("analyze", s, d, N, kind="bridges", final=final,
                    delete=_keys(dels2))
    assert got == _host("bridges", _drop(pairs, dels2))
    assert PAIR.torch.stats.traces == traces


@pytest.mark.parametrize("final", ["device", "host"])
@pytest.mark.parametrize("kind", KINDS)
def test_batched_analyze_per_graph_deletions(kind, final):
    """Per-graph ``delete=`` through the union's one tombstone pass: a row
    with keys, a row without (``None``), a row whose keys name vertices
    outside the graph, and an empty graph."""
    graphs, deletes, lives = [], [], []
    for i in range(3):
        s, d, pairs = _base(seed=20 + i)
        graphs.append((s, d))
        if i == 1:
            deletes.append(None)
            lives.append(pairs)
        else:
            dels = pairs[::5][:8] + [(N + 3, 2), (-1, 5)]
            deletes.append(_keys(dels))
            lives.append(_drop(pairs, dels))
    graphs.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
    deletes.append(_keys([(0, 1)]))
    lives.append([])
    got = PAIR.call("analyze_batch", graphs, N, kind=kind, final=final,
                    delete=deletes)
    for i in range(4):
        assert _agrees(got[i], _host(kind, lives[i])), (kind, i)
    # the cached batched programs' stacked buffers, bit for bit
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    keys = [empty if k is None else k for k in deletes]
    jargs = [jbatched.BatchedEdgeList.from_graphs(g, 64, capacity=c,
                                                  batch_pad=4)
             for g, c in ((graphs, 256), (keys, 16))]
    targs = [BatchedEdgeList.from_graphs(g, 64, capacity=c, batch_pad=4,
                                         device="cpu")
             for g, c in ((graphs, 256), (keys, 16))]
    cert = PAIR.torch._program_certificate(tregistry.get_analysis(kind),
                                           final, None)
    key = ("batch", kind, final, 64, 256, 4, 16, "cpu", cert)
    want = PAIR.jax._programs[key](*(x for b in jargs
                                     for x in (b.src, b.dst, b.mask)))
    out = PAIR.torch._programs[key](*(x for b in targs
                                      for x in (b.src, b.dst, b.mask)))
    assert_buffers_equal(out if isinstance(out, tuple) else (out,),
                         want if isinstance(want, tuple) else (want,),
                         (kind, final))
    with pytest.raises(ValueError, match="deletion lists"):
        PAIR.torch.analyze_batch(graphs, N, delete=deletes[:2])
