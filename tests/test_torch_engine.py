"""Port parity of the engine (``repro_torch.engine``) against ``repro.engine``
(JAX on the CPU), mirroring ``tests/test_engine.py``: the program cache
and its counters, one-shot and batched dispatch for every kind × final,
the live graph with inserts, fig6's fixed sequence, and the claims that
make the batched program one disjoint-union pass equal to the reference's
``vmap`` slot for slot.

Tolerance: exact equality (answers, buffers and counters are integers,
booleans or sets of them). One operating point (n in (32, 64] -> bucket
64, E -> bucket 512, batch bucket 4) keeps the JAX side to a few programs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import find_bridges as j_find_bridges
from repro.engine import batched as jbatched
from repro.engine import dispatch as jdispatch
from repro.graph import generators as gen
from repro_torch import analyze as t_analyze
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import certificate as tcert
from repro_torch.core.api import engine_for
from repro_torch.core.certs import certificate_names, get_certificate
from repro_torch.engine import (
    BatchedEdgeList,
    BridgeEngine,
    ProgramCache,
    admission_bucket,
    get_default_engine,
    make_batched_pipeline,
)
from repro_torch.engine.batched import split_certificate, union_edges
from repro_torch.engine.state import (
    EngineStats,
    LiveState,
    live_state_from_flat,
    live_state_tree,
)
from repro_torch.graph.datastructs import EdgeList
from repro_torch.kernels.boruvka_round import ops as round_ops

from torch_engine_pair import EnginePair, assert_buffers_equal, same

N_A, N_B, E_N = 50, 60, 400
KINDS = ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")
#: every (kind, final, certificate) of the batched parity: each kind with
#: both finals under its declared certificate, and the vertex kinds' host
#: final under ``hybrid`` too
BATCH_RUNS = ([(k, f, None) for k in KINDS for f in ("device", "host")]
              + [("cuts", "host", "hybrid"), ("bcc", "host", "hybrid")])

PAIR = EnginePair()  # one pair: each JAX program compiles once


def graph(seed, n=N_A, e=E_N):
    src, dst, _ = gen.planted_bridge_graph(n, e, n_bridges=3, seed=seed)
    return src, dst


def batch():
    """Two planted graphs and an empty one: the batch bucket 4 adds one
    padding row."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    return [graph(21), graph(22, n=N_B), empty], [N_A, N_B, N_A]


def _rows(out):
    return out if isinstance(out, tuple) else (out,)


# ------------------------------------------------------------ the cache
def test_admission_bucket_and_program_cache_counters():
    for n, e in ((1, 0), (17, 500), (64, 512), (100_000, 10_000_000)):
        assert admission_bucket(n, e) == jdispatch.admission_bucket(n, e)
    stats = EngineStats()
    cache = ProgramCache(stats)
    built = []
    for key in ("a", "b", "a", "a"):
        cache.get(key, lambda k=key: built.append(k) or k)
    assert built == ["a", "b"] and len(cache) == 2 and "a" in cache
    assert (stats.hits, stats.misses, stats.traces) == (2, 2, 0)
    assert stats.snapshot()["hit_rate"] == 0.5


def test_second_call_same_bucket_no_rebuild():
    pair = EnginePair()
    s1, d1 = gen.random_graph(N_A, 300, seed=1)
    s2, d2 = gen.random_graph(N_B, 400, seed=2)
    pair.call("find_bridges", s1, d1, N_A)
    pair.call("find_bridges", s2, d2, N_B)
    info = pair.torch.cache_info()
    assert info == pair.jax.cache_info()
    assert info == {"programs": 1, "hits": 1, "misses": 1, "traces": 1}


def test_engine_needs_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BridgeEngine()
    assert BridgeEngine(device="cpu").backend == "cpu"


def test_api_routes_through_the_default_engine():
    eng = engine_for(device="cpu")
    assert eng is get_default_engine("cpu")
    s, d = graph(9)
    before = eng.stats.misses + eng.stats.hits
    assert t_analyze(s, d, N_A, kind="bridges", final="host",
                     device="cpu") == j_find_bridges(s, d, N_A, final="host")
    assert eng.stats.misses + eng.stats.hits == before + 1


def test_certificate_preference_and_overrides():
    pair = EnginePair(certificate="hybrid")
    for kind in KINDS:
        assert (pair.torch.certificate_for(kind)
                == pair.jax.certificate_for(kind))
    with pytest.raises(ValueError, match="does not preserve"):
        pair.torch.analyze([0], [1], 4, kind="cuts", certificate="2ec")


# ------------------------------------------------------------ one-shot
@pytest.mark.parametrize("kind", KINDS)
def test_analyze_matches_reference(kind):
    s, d = graph(5)
    for final in ("device", "host"):
        PAIR.call("analyze", s, d, N_A, kind=kind, final=final)


def test_host_final_matches_device():
    s, d = graph(9)
    assert (PAIR.call("find_bridges", s, d, N_A, final="host")
            == PAIR.call("find_bridges", s, d, N_A, final="device"))


# ------------------------------------------------------------- batched
@pytest.mark.parametrize("kind,final,cert", BATCH_RUNS)
def test_batch_rows_match_reference(kind, final, cert):
    """Every kind × final: the answers, and the stacked result buffers of
    the cached batched program against the reference's vmapped program,
    bit for bit (certificate rows for the host final)."""
    graphs, ns = batch()
    PAIR.call("analyze_batch", graphs, ns, kind=kind, final=final,
              certificate=cert)
    jb = jbatched.BatchedEdgeList.from_graphs(graphs, 64, capacity=512,
                                              batch_pad=4)
    tb = BatchedEdgeList.from_graphs(graphs, 64, capacity=512, batch_pad=4,
                                     device="cpu")
    assert_buffers_equal((tb.src, tb.dst, tb.mask),
                         (jb.src, jb.dst, jb.mask), "batch")
    cert_name = PAIR.torch._program_certificate(get_analysis(kind), final,
                                                cert)
    key = ("batch", kind, final, 64, 512, 4, None)
    jfn = PAIR.jax._programs[key + ("cpu", cert_name)]
    tfn = PAIR.torch._programs[key + ("cpu", cert_name)]
    want = _rows(jfn(jb.src, jb.dst, jb.mask))
    out = _rows(tfn(tb.src, tb.dst, tb.mask))
    assert_buffers_equal(out, want, f"{kind}/{final}")


def test_batch_program_reused_by_a_smaller_batch():
    graphs, ns = batch()
    PAIR.call("find_bridges_batch", graphs, ns)
    traces = PAIR.torch.stats.traces
    PAIR.call("find_bridges_batch", graphs[:3], ns[:3])
    assert PAIR.torch.stats.traces == traces


def test_batch_rejects_mismatched_vertex_counts():
    graphs = [graph(1), graph(2), graph(3)]
    with pytest.raises(ValueError, match="3 graphs but 2"):
        BridgeEngine(device="cpu").find_bridges_batch(graphs, [N_A, N_A])
    assert BridgeEngine(device="cpu").analyze_batch([], N_A) == []


def test_batched_edgelist_roundtrip_and_deletions():
    graphs = [graph(11), graph(12)]
    tb = BatchedEdgeList.from_graphs(graphs, N_A, capacity=512, batch_pad=4,
                                     device="cpu")
    jb = jbatched.BatchedEdgeList.from_graphs(graphs, N_A, capacity=512,
                                              batch_pad=4)
    assert tb.batch_size == 4 and tb.capacity == 512
    assert_buffers_equal((tb.src, tb.dst, tb.mask),
                         (jb.src, jb.dst, jb.mask), "from_graphs")
    row = tb[1]
    assert isinstance(row, EdgeList) and row.n_nodes == N_A
    dels = [(graphs[0][0][:5], graphs[0][1][:5]), None,
            (np.array([3, 99, -1], np.int32), np.array([7, 2, 4], np.int32))]
    assert_buffers_equal([tb.delete_edges(dels).mask],
                         [jb.delete_edges(dels).mask], "delete_edges")
    with pytest.raises(ValueError, match="exceeds"):
        BatchedEdgeList.from_graphs(graphs, N_A, capacity=4, device="cpu")
    with pytest.raises(ValueError, match="deletion lists"):
        tb.delete_edges([None] * 5)


# ------------------------------------------------- the union's claims
def _stacked_rows(graphs, n, cap, b):
    tb = BatchedEdgeList.from_graphs(graphs, n, capacity=cap, batch_pad=b,
                                     device="cpu")
    return tb, union_edges(tb.src, tb.dst, tb.mask, n)


@pytest.mark.parametrize("cert", certificate_names())
def test_union_certificate_keeps_slot_order(cert):
    """Compaction is stable: each row's certificate edges form one run of
    the union certificate, runs in row order, every run in its row's slot
    order."""
    graphs, _ = batch()
    tb, union = _stacked_rows(graphs, 64, 512, 4)
    uc = get_certificate(cert).build(
        union, capacity=tcert.certificate_capacity(union.n_nodes))
    m = uc.mask.numpy()
    assert m[:m.sum()].all()  # live slots first
    rows = uc.src.numpy()[m] // 64
    assert (np.diff(rows) >= 0).all()
    for b in range(tb.batch_size):
        sel = rows == b
        pairs = list(zip(uc.src.numpy()[m][sel] - 64 * b,
                         uc.dst.numpy()[m][sel] - 64 * b))
        buf = list(zip(tb.src[b].numpy(), tb.dst[b].numpy()))
        at = 0
        for p in pairs:  # a subsequence of the row's slots (index raises)
            at = buf.index(p, at) + 1


@pytest.mark.parametrize("cert", certificate_names())
def test_union_certificate_split_equals_rows(cert):
    """The union certificate split back into rows equals each row's own
    certificate, slot for slot, in the port and in the reference."""
    graphs, _ = batch()
    tb, union = _stacked_rows(graphs, 64, 512, 4)
    build = get_certificate(cert).build
    cap = tcert.certificate_capacity(64)
    got = split_certificate(
        build(union, capacity=tcert.certificate_capacity(union.n_nodes)),
        tb.batch_size, 64)
    rows = [build(tb[b], capacity=cap) for b in range(tb.batch_size)]
    want = [torch.stack([getattr(r, f) for r in rows])
            for f in ("src", "dst", "mask")]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    from repro.core.certs import get_certificate as j_get_certificate

    jb = jbatched.BatchedEdgeList.from_graphs(graphs, 64, capacity=512,
                                              batch_pad=4)
    jrows = [j_get_certificate(cert).build(jb[b], capacity=cap)
             for b in range(4)]
    assert_buffers_equal(got, [np.stack([np.asarray(getattr(r, f))
                                         for r in jrows])
                               for f in ("src", "dst", "mask")], cert)


def test_union_crossing_the_key_space_raises():
    """No per-row fallback: a batch whose union has more vertex ids than
    the kernels' int32 key space raises before any pass runs."""
    eng = BridgeEngine(device="cpu")
    graphs = [graph(1), graph(2)]
    with pytest.raises(ValueError, match="segment-id space"):
        eng.find_bridges_batch(graphs, 1 << 30)


def _counting(monkeypatch):
    calls = {"boruvka_round": 0, "frontier_round": 0}
    for name in calls:
        ref = getattr(round_ops, f"{name}_ref")

        def counted(*args, _ref=ref, _name=name):
            calls[_name] += 1
            return _ref(*args)

        monkeypatch.setattr(round_ops, f"{name}_ref", counted)
    return calls


@pytest.mark.parametrize("kind", ["bridges", "cuts"])
def test_union_runs_each_round_once_for_the_batch(kind, monkeypatch):
    """One certificate pass over the union: the rounds of each forest pass
    are the slowest row's, not the sum over rows."""
    graphs, _ = batch()
    tb = BatchedEdgeList.from_graphs(graphs, 64, capacity=512, batch_pad=4,
                                     device="cpu")
    ex = (tcert.sparse_certificate_ex if kind == "bridges"
          else tcert.sfs_certificate_ex)
    per_row = [ex(tb[b])[3] for b in range(tb.batch_size)]
    calls = _counting(monkeypatch)
    make_batched_pipeline(64, final="host", kind=kind)(tb.src, tb.dst,
                                                       tb.mask)
    passes = len(per_row[0])
    slowest = sum(max(r[p] for r in per_row) for p in range(passes))
    counted = (calls["boruvka_round"] if kind == "bridges"
               else calls["frontier_round"])
    assert counted == slowest
    assert counted < sum(sum(r) for r in per_row)


# ------------------------------------------------------------ live graph
def test_insert_edges_matches_reference():
    src, dst = graph(7)
    PAIR.call("load", src, dst, N_A)
    PAIR.call("current_bridges")
    for step in range(3):
        ds, dd = gen.random_graph(N_A, 30, seed=100 + step)
        PAIR.call("insert_edges", ds, dd)
    assert PAIR.torch.num_live_edges == PAIR.jax.num_live_edges
    assert PAIR.torch.num_live_edges <= 2 * (PAIR.torch._live["n_bucket"] - 1)


def test_insert_bridge_then_cover_it():
    src, dst, n = np.array([0, 1], np.int32), np.array([1, 2], np.int32), 40
    PAIR.call("load", src, dst, n)
    assert PAIR.call("current_bridges") == {(0, 1), (1, 2)}
    got = PAIR.call("insert_edges", np.array([2], np.int32),
                    np.array([3], np.int32))
    assert got == {(0, 1), (1, 2), (2, 3)}
    assert PAIR.call("insert_edges", np.array([3], np.int32),
                     np.array([0], np.int32)) == set()


def test_insert_grows_the_full_buffer_bucket():
    s, d = gen.random_graph(N_A, 14, seed=4)
    PAIR.call("load", s, d, N_A)
    # 14 + 12 + 12 edges cross the 16- and the 32-slot bucket
    for step in range(2):
        ds, dd = gen.random_graph(N_A, 12, seed=300 + step)
        PAIR.call("insert_edges", ds, dd, kind="cuts")
    assert PAIR.torch._live.full[0].shape[0] == 64


def test_live_calls_require_load():
    eng = BridgeEngine(device="cpu")
    for call in (lambda: eng.insert_edges([0], [1]),
                 lambda: eng.current_analysis("bridges"),
                 lambda: eng.num_live_graph_edges):
        with pytest.raises(RuntimeError, match="load"):
            call()


def test_live_state_tree_round_trip():
    s, d = graph(3)
    eng = BridgeEngine(device="cpu").load(s, d, N_A)
    eng.current_analysis("cuts")
    tree = live_state_tree(eng._live)
    flat = {f"full/{i}": x.numpy() for i, x in enumerate(tree["full"])}
    for name, state in tree["certs"].items():
        flat.update({f"certs/{name}/{i}": x.numpy()
                     for i, x in enumerate(state)})
    flat.update({f"rebuilds/{k}": v for k, v in tree["rebuilds"].items()})
    flat.update({f"meta/{k}": v for k, v in tree["meta"].items()})
    back = live_state_from_flat(flat)
    assert isinstance(back, LiveState) and back.count == eng._live.count
    assert set(back.certs) == {"2ec", "sfs"}
    for a, b in zip(back.full, eng._live.full):
        assert np.array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="unknown"):
        live_state_from_flat({"nope/0": np.zeros(1)})


# -------------------------------------------------------- fig6's sequence
def test_fig6_sequence_counters_match_reference():
    """``benchmarks/fig6_engine.py``'s fixed sequence at its smoke size (V
    96, E 800, B 4; four timed calls a step): the snapshot equals the
    reference's after every call, reaching ``BENCH_baseline.json``'s
    ``fig6/engine_cache`` (programs=8 misses=8 traces=8) and
    ``fig6/hybrid_cache`` (10/10/10) records."""
    v, e, b, n_deltas, n_keys, reps = 96, 800, 4, 48, 16, 4
    pair = EnginePair()

    def query(seed):
        n = v - (seed % 7)
        src, dst, _ = gen.planted_bridge_graph(n, e, n_bridges=3, seed=seed)
        return src, dst, n

    s0, d0, n0 = query(0)
    pair.call("find_bridges", s0, d0, n0)
    s1, d1, n1 = query(1)
    for _ in range(reps):
        pair.call("find_bridges", s1, d1, n1)
    qs = [query(2 + i) for i in range(b)]
    for _ in range(reps):
        pair.call("find_bridges_batch", [(s, d) for s, d, _ in qs],
                  [n for _, _, n in qs])
    pair.call("load", s0, d0, n0)
    deltas = [gen.random_graph(n0, n_deltas, seed=99 + k) for k in range(8)]
    for k in range(reps):
        pair.call("insert_edges", *deltas[k])
    for k in range(reps):
        pair.call("delete_edges", deltas[k][0][:n_keys],
                  deltas[k][1][:n_keys])
    info = pair.torch.snapshot()
    assert (info["programs"], info["misses"], info["traces"]) == (8, 8, 8)
    for _ in range(1 + reps):
        pair.call("current_analysis", "cuts", certificate="hybrid")
    for k in range(reps):
        s, d = deltas[4 + k % 4]
        pair.call("delete_edges", s[:n_keys], d[:n_keys], kind="cuts",
                  certificate="hybrid")
    info = pair.torch.snapshot()
    assert (info["programs"], info["misses"], info["traces"]) == (10, 10, 10)


def test_rows_of_one_batch_equal_their_single_graph_answers():
    graphs, ns = batch()
    got = PAIR.torch.analyze_batch(graphs, ns, kind="bridges")
    for (s, d), n, g in zip(graphs, ns, got):
        assert same(g, PAIR.torch.find_bridges(s, d, n))


# ------------------------------------------- rows with ids out of the bucket
def _outcome(fn):
    """``("value", answer)`` or ``("raises", exception type)``."""
    try:
        return "value", fn()
    except Exception as exc:  # the reference's exception type is the test
        return "raises", type(exc)


#: batches at n = 16 (bucket 16) where a row names a vertex outside
#: [0, 16): offset into the union it would name a vertex of another row
DIRTY_BATCHES = {
    "path_into_n": [([0, 1, 16], [1, 2, 3]), ([0, 1, 2], [1, 2, 3])],
    "edge_at_n": [([16], [0]), ([0], [1])],
    "negative": [([-1], [0]), ([0], [1])],
    "last_row": [([0], [1]), ([16], [0])],
    "mixed": [([0, 1], [1, 2]), ([-1, 3], [2, 4]), ([5], [6]),
              ([40], [2]), ([0, 2], [1, 0])],
}
#: the rows of each batch that the union carries
UNION_ROWS = {"path_into_n": 1, "edge_at_n": 1, "negative": 1,
              "last_row": 1, "mixed": 3}
C3_PAIR = EnginePair()


@pytest.mark.parametrize("final", ["device", "host"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(DIRTY_BATCHES))
def test_batch_rows_out_of_the_bucket_answer_alone(name, kind, final):
    """Every row answers as the reference's vmapped row does, or the call
    raises the reference's exception type; the union carries only the
    clean rows, and no row changes another's answer."""
    from repro_torch import obs

    graphs = [(np.asarray(s, np.int32), np.asarray(d, np.int32))
              for s, d in DIRTY_BATCHES[name]]
    want = _outcome(lambda: C3_PAIR.jax.analyze_batch(graphs, 16, kind=kind,
                                                      final=final))
    tr = obs.enable_tracing()
    try:
        got = _outcome(lambda: C3_PAIR.torch.analyze_batch(
            graphs, 16, kind=kind, final=final))
    finally:
        obs.disable_tracing()
    assert got[0] == want[0], (got, want)
    if want[0] == "raises":
        assert got[1] is want[1]
    else:
        assert same(got[1], want[1]), (got[1], want[1])
    union = [s["attrs"]["rows"] for s in tr.spans()
             if s["name"] == f"stage/pipeline/{kind}"
             and "rows" in s["attrs"]]
    assert union == [UNION_ROWS[name]]
    if final == "device":
        assert got[0] == "value"


def test_clean_rows_of_a_dirty_batch_equal_their_single_answers():
    graphs = DIRTY_BATCHES["path_into_n"]
    got = C3_PAIR.torch.analyze_batch(graphs, 16, kind="bridges")
    assert got[1] == C3_PAIR.torch.find_bridges(*graphs[1], 16) \
        == {(0, 1), (1, 2), (2, 3)}


def test_dirty_rows_keep_their_deletion_keys():
    """A row answered alone keeps its own deletion keys. (The program
    counters differ from the reference's here by design: the row runs
    through a one-graph program beside the union's.)"""
    graphs = [([0, 1, 2, 16], [1, 2, 0, 3]), ([0, 1, 2], [1, 2, 0])]
    delete = [([1], [2]), ([0], [1])]
    for kind in ("bridges", "cuts"):
        got = C3_PAIR.torch.analyze_batch(graphs, 16, kind=kind,
                                          delete=delete)
        assert got == C3_PAIR.jax.analyze_batch(graphs, 16, kind=kind,
                                                delete=delete)
        assert got == [C3_PAIR.torch.analyze(s, d, 16, kind=kind,
                                             delete=k)
                       for (s, d), k in zip(graphs, delete)]
