"""Port parity of streaming ingest against ``repro`` (JAX on the CPU),
mirroring ``tests/test_ingest.py``: ``ChunkedEdgeStream`` (admit,
tombstone, replay, the ring and its counters), ``Certificate.stream_load``,
the streamed engine (``load_stream``/``ingest_chunk`` and the streamed
branches of ``insert_edges``, ``delete_edges`` and the lazy
materialization) through ``EnginePair``, the zero-new-miss steady state,
the sharded streaming merge, the streamed live bytes and the checkpoint
refusal.

Tolerance: exact equality (answers, buffers, rings and counters are
integers, booleans or sets of them). Shapes stay in one bucket family
(n = 48 -> n_bucket 64, chunk bucket 16, one-shot buffer 256), and one
module-level pair is shared, so the JAX side compiles each program once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import certs as jcerts
from repro.core import merge as jmerge
from repro.core.certificate import certificate_capacity
from repro.core.partition import partition_edges
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import certs as tcerts
from repro_torch.core import merge as tmerge
from repro_torch.engine import BridgeEngine
from repro_torch.engine.state import live_state_tree
from repro_torch.graph import datastructs as tds

from torch_engine_pair import (
    EnginePair,
    assert_buffers_equal,
    assert_rings_equal,
)

N, E0 = 48, 150
CHUNK = 16
KINDS = ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")

PAIR = EnginePair()  # one pair: each JAX program compiles once


def _host(kind, s, d, n=N):
    return get_analysis(kind).host_fn(np.asarray(s, np.int32),
                                      np.asarray(d, np.int32), n)


def _valid_certs(kind):
    """``None`` (the kind's default) and every override the engine takes."""
    out = [None]
    for name in tcerts.certificate_names():
        try:
            PAIR.torch._resolve_certificate(get_analysis(kind), name)
        except ValueError:
            continue
        out.append(name)
    return out


def _streams(**kw):
    return (jds.ChunkedEdgeStream(N, chunk_edges=CHUNK, **kw),
            tds.ChunkedEdgeStream(N, chunk_edges=CHUNK, device="cpu", **kw))


def _chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_nodes == w.n_nodes
        assert_buffers_equal((g.src, g.dst, g.mask), (w.src, w.dst, w.mask),
                             "chunk")


# ------------------------------------------------------ ChunkedEdgeStream
def test_bucket_capacity_is_admission_capacity():
    assert tds.bucket_capacity is tds.admission_capacity
    for m, minimum in ((1, 16), (16, 16), (17, 16), (500, 16), (3, 1)):
        assert (tds.bucket_capacity(m, minimum)
                == jds.bucket_capacity(m, minimum))


@pytest.mark.parametrize("edges", [0, 7, 16, 40, 65])
def test_stream_admit_matches_reference(edges):
    s, d = gen.random_graph(N, 80, seed=0)
    s, d = s[:edges], d[:edges]
    js, ts = _streams()
    _chunks_equal(ts.admit(s, d), js.admit(s, d))
    _chunks_equal(ts.admit(d[:5], s[:5]), js.admit(d[:5], s[:5]))
    assert_rings_equal(ts, js)
    assert ts.device_chunk_bytes == js.device_chunk_bytes == CHUNK * 9
    for g, w in zip(ts.to_numpy(), js.to_numpy()):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_admit_each_uploads_one_chunk_at_a_time():
    """The engine's path spills and uploads a segment only when its chunk
    is asked for, and ends as ``admit`` does."""
    s, d = gen.random_graph(N, 40, seed=0)
    js, ts = _streams()
    chunks = ts.admit_each(s, d)
    assert (ts.ring_segments, ts.chunks_in, ts.count) == (0, 0, 0)
    first = next(chunks)
    assert (ts.ring_segments, ts.chunks_in, ts.count) == (1, 1, CHUNK)
    _chunks_equal([first, *chunks], js.admit(s, d))
    assert_rings_equal(ts, js)


def test_stream_admit_length_mismatch_raises():
    _, ts = _streams()
    with pytest.raises(ValueError, match="mismatch"):
        ts.admit(np.zeros(3, np.int32), np.zeros(2, np.int32))


def _parallel_graph():
    """40 random edges, then 6 of them again reversed (parallel copies)."""
    s, d = gen.random_graph(N, 40, seed=1)
    return np.concatenate([s, d[:6]]), np.concatenate([d, s[:6]])


#: deletion keys: reversed pairs, absent pairs, a duplicate key, ids out
#: of range, nothing, and every edge
TOMBSTONES = {
    "reversed": lambda s, d: (d[:6], s[:6]),
    "absent": lambda s, d: (np.array([0, 1], np.int32),
                            np.array([0, 1], np.int32)),
    "duplicate_key": lambda s, d: (np.array([s[3], s[3], d[9]], np.int32),
                                   np.array([d[3], d[3], s[9]], np.int32)),
    "out_of_range": lambda s, d: (np.array([-1, N, s[0]], np.int32),
                                  np.array([s[1], 2 ** 31 - 1, d[0]],
                                           np.int32)),
    "none": lambda s, d: (np.zeros(0, np.int32), np.zeros(0, np.int32)),
    "all": lambda s, d: (s, d),
}


@pytest.mark.parametrize("keys", list(TOMBSTONES))
def test_stream_tombstone_and_replay_match_reference(keys):
    s, d = _parallel_graph()
    js, ts = _streams()
    js.admit(s[:20], d[:20])
    ts.admit(s[:20], d[:20])
    js.admit(s[20:], d[20:])
    ts.admit(s[20:], d[20:])
    ks, kd = TOMBSTONES[keys](s, d)
    removed = ts.tombstone(ks, kd)
    assert removed == js.tombstone(ks, kd)
    assert_rings_equal(ts, js)
    _chunks_equal(list(ts.replay()), list(js.replay()))
    # a tombstone that removes an edge re-chunks the survivors
    assert ts.ring_segments == (-(-ts.count // CHUNK) if removed else 4)
    assert ts.tombstone(ks, kd) == js.tombstone(ks, kd) == 0
    assert_rings_equal(ts, js)


def test_stream_tombstone_on_an_empty_ring():
    js, ts = _streams()
    assert ts.tombstone([0], [1]) == js.tombstone([0], [1]) == 0
    assert list(ts.replay()) == list(js.replay()) == []
    assert_rings_equal(ts, js)


@pytest.mark.parametrize("cert", tcerts.certificate_names())
def test_stream_load_matches_reference(cert):
    s, d = gen.random_graph(N, E0, seed=2)
    js, ts = _streams()
    cap = certificate_capacity(N)
    want = jcerts.get_certificate(cert).stream_load(js.admit(s, d), cap)
    got = tcerts.get_certificate(cert).stream_load(ts.admit(s, d), cap)
    assert_buffers_equal(got, want, cert)


# ------------------------------------------- the streamed engine, in pairs
def _worlds():
    p = np.arange(N - 1, dtype=np.int32)
    bs, bd, _, _ = gen.barbell(6, 8)
    return {"sparse": gen.random_graph(N, E0, seed=3), "path": (p, p + 1),
            "barbell": (bs, bd)}


@pytest.mark.parametrize("world", list(_worlds()))
@pytest.mark.parametrize("kind", KINDS)
def test_streamed_engine_matches_reference(kind, world):
    """Every valid certificate and both finals off one streamed load: the
    answers, every live state slot for slot, the ring and the counters
    (``EnginePair``), and the host truth."""
    s, d = _worlds()[world]
    PAIR.call("load_stream", s, d, N, chunk_edges=CHUNK)
    for cert in _valid_certs(kind):
        for final in ("device", "host"):
            got = PAIR.call("current_analysis", kind, final=final,
                            certificate=cert)
            want = _host(kind, s, d)
            assert (np.array_equal(got, want) if kind == "2ecc"
                    else got == want), (cert, final)


def test_edgeless_stream_replays_the_empty_ring():
    """An edgeless stream: lazy certificates certify the empty world from
    one all-masked chunk, which counts as a fold."""
    empty = np.zeros(0, np.int32)
    PAIR.call("load_stream", empty, empty, N, chunk_edges=CHUNK)
    for kind in ("bridges", "cuts", "bcc"):
        PAIR.call("current_analysis", kind)
    assert PAIR.torch.snapshot()["ingest"]["folds"] == 2
    s, d = gen.random_graph(N, 30, seed=4)
    PAIR.call("ingest_chunk", s, d)
    PAIR.call("current_analysis", "cuts", certificate="hybrid")


def test_ingest_chunk_requires_a_streamed_live_graph():
    s, d = gen.random_graph(N, 20, seed=5)
    eng = BridgeEngine(device="cpu")
    with pytest.raises(RuntimeError, match="load_stream"):
        eng.ingest_chunk(s, d)
    eng.load(s, d, N)
    with pytest.raises(RuntimeError, match="load_stream"):
        eng.ingest_chunk(s, d)


def test_load_stream_refuses_a_mesh():
    eng = BridgeEngine(device="cpu")
    eng.mesh = object()  # any mesh: the check comes before it is read
    with pytest.raises(NotImplementedError, match="stream_shard_states"):
        eng.load_stream([0], [1], N)


def test_insert_on_a_streamed_graph_is_an_ingest():
    s, d = gen.random_graph(N, E0, seed=6)
    PAIR.call("load_stream", s[:50], d[:50], N, chunk_edges=CHUNK)
    assert PAIR.call("insert_edges", s[50:], d[50:], kind="bridges") \
        == _host("bridges", s, d)
    assert PAIR.torch.num_live_graph_edges == E0
    assert PAIR.torch._live.stream.chunks_in == -(-50 // CHUNK) \
        + -(-100 // CHUNK)
    assert PAIR.call("ingest_chunk", s[:3], d[:3], kind="cuts") \
        == _host("cuts", np.concatenate([s, s[:3]]),
                 np.concatenate([d, d[:3]]))


def test_interleaved_ingest_and_delete_match_reference():
    """Ingest and delete interleaved on one streamed live graph, with lazy
    certificates materialized between: after every call the pair agrees
    and answers like a host recomputation on the surviving edges."""
    rng = np.random.default_rng(11)
    s, d = gen.random_graph(N, E0, seed=8)
    live_s, live_d = list(s[:60]), list(d[:60])
    PAIR.call("load_stream", s[:60], d[:60], N, chunk_edges=CHUNK)
    lo = 60
    for turn in range(6):
        if turn % 2 == 0:
            hi = lo + 25
            PAIR.call("ingest_chunk", s[lo:hi], d[lo:hi])
            live_s += list(s[lo:hi])
            live_d += list(d[lo:hi])
            lo = hi
        else:
            idx = rng.choice(len(live_s), size=6, replace=False)
            ks = np.array([live_s[i] for i in idx], np.int32)
            kd = np.array([live_d[i] for i in idx], np.int32)
            PAIR.call("delete_edges", ks, kd, kind="cuts")
            kset = set(zip(np.minimum(ks, kd).tolist(),
                           np.maximum(ks, kd).tolist()))
            keep = [(a, b) for a, b in zip(live_s, live_d)
                    if (min(a, b), max(a, b)) not in kset]
            live_s = [a for a, _ in keep]
            live_d = [b for _, b in keep]
        assert PAIR.torch.num_live_graph_edges == len(live_s)
        for kind in ("bridges", "cuts", "2ecc"):
            got = PAIR.call("current_analysis", kind)
            want = _host(kind, live_s, live_d)
            assert (np.array_equal(got, want) if kind == "2ecc"
                    else got == want), (turn, kind)
    info = PAIR.torch.snapshot()["ingest"]
    assert info["spilled"] == 60 + 3 * 25 and info["replays"] >= 1


def test_no_new_program_across_varying_delta_sizes():
    """After one warm pass, fresh streams and deltas of any size in the
    same chunk bucket reuse the warm programs: no miss, on either side."""
    s, d = gen.random_graph(N, E0, seed=7)
    PAIR.call("load_stream", s[:40], d[:40], N, chunk_edges=CHUNK)
    PAIR.call("ingest_chunk", s[40:70], d[40:70])
    for kind in KINDS:
        PAIR.call("current_analysis", kind)
    PAIR.call("delete_edges", s[:8], d[:8])
    warm = PAIR.torch.stats.misses
    for base, step in ((25, 9), (80, 33), (3, 1)):
        PAIR.call("load_stream", s[:base], d[:base], N, chunk_edges=CHUNK)
        lo = base
        while lo < E0:
            PAIR.call("ingest_chunk", s[lo:lo + step], d[lo:lo + step])
            lo += step
        for kind in KINDS:
            PAIR.call("current_analysis", kind)
        PAIR.call("delete_edges", s[:8], d[:8])
    assert PAIR.torch.stats.misses == warm


def test_streamed_peak_below_one_shot():
    s, d = gen.random_graph(N, E0, seed=10)
    PAIR.call("load", s, d, N)
    for kind in KINDS:
        PAIR.call("current_analysis", kind)
    one_shot = PAIR.torch.peak_live_bytes
    PAIR.call("load_stream", s, d, N, chunk_edges=CHUNK)
    for kind in KINDS:
        PAIR.call("current_analysis", kind)
    streamed = PAIR.torch.peak_live_bytes
    assert 0 < streamed < one_shot
    assert PAIR.torch.live_bytes <= streamed


def test_live_state_tree_refuses_a_streamed_state():
    s, d = gen.random_graph(N, 30, seed=12)
    eng = BridgeEngine(device="cpu").load_stream(s, d, N, chunk_edges=CHUNK)
    with pytest.raises(ValueError, match="spill ring"):
        live_state_tree(eng._live)


def test_streaming_spans_match_reference():
    """The streamed calls record the same engine and stage spans (names,
    nesting, attributes) under both tracers; the port's per-round forest
    spans and host syncs are left out, since the reference records none
    inside a compiled program."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    s, d = gen.random_graph(N, 60, seed=13)

    def record(eng, obs):
        tr = obs.enable_tracing()
        try:
            eng.load_stream(s[:40], d[:40], N, chunk_edges=CHUNK)
            eng.ingest_chunk(s[40:], d[40:])
            eng.current_analysis("cuts")
            eng.delete_edges(s[:4], d[:4])
        finally:
            obs.disable_tracing()
        return [(x["name"], x["depth"], x["attrs"]) for x in tr.spans()
                if not x["name"].startswith(("kernel/", "sync/"))]

    got, want = record(PAIR.torch, tobs), record(PAIR.jax, jobs)
    assert got == want
    assert {"engine/load_stream", "stage/ingest", "stage/merge/2ec"} \
        <= {name for name, _, _ in got}


# ------------------------------------------ the sharded streaming merge
@pytest.mark.parametrize("schedule", ["paper", "xor"])
def test_sharded_streaming_merge_matches_reference(schedule):
    s, d = gen.random_graph(N, E0, seed=9)
    m = 4
    psrc, pdst, pmask = partition_edges(s, d, N, m, seed=2)
    jshards = [jds.EdgeList(psrc[i], pdst[i], pmask[i], N) for i in range(m)]
    tshards = [tds.EdgeList(torch.from_numpy(psrc[i]),
                            torch.from_numpy(pdst[i]),
                            torch.from_numpy(pmask[i]), N) for i in range(m)]
    want, jstreams = jmerge.simulate_stream_merge_host(jshards, CHUNK,
                                                       schedule=schedule)
    got, tstreams = tmerge.simulate_stream_merge_host(tshards, CHUNK,
                                                      schedule=schedule)
    for g, w in zip(got, want):
        assert_buffers_equal((g.src, g.dst, g.mask), (w.src, w.dst, w.mask),
                             schedule)
    for g, w in zip(tstreams, jstreams):
        assert_rings_equal(g, w)
    answer = _host("bridges", *got[0].to_numpy())
    assert answer == _host("bridges", s, d)


def test_stream_shard_states_edgeless_shard_matches_reference():
    """A shard with no edge streams one all-masked chunk (one fold)."""
    s, d = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    empty = np.zeros(4, np.int32)
    mask = np.array([True, True, False, False])
    jsh = [jds.EdgeList(np.pad(s, (0, 2)), np.pad(d, (0, 2)), mask, N),
           jds.EdgeList(empty, empty, np.zeros(4, bool), N)]
    tsh = [tds.EdgeList(torch.from_numpy(np.asarray(x.src)),
                        torch.from_numpy(np.asarray(x.dst)),
                        torch.from_numpy(np.asarray(x.mask)), N)
           for x in jsh]
    for cert in ("2ec", "sfs"):
        want, jst = jmerge.stream_shard_states(jsh, CHUNK, certificate=cert)
        got, tst = tmerge.stream_shard_states(tsh, CHUNK, certificate=cert)
        for g, w in zip(got, want):
            assert_buffers_equal((g.src, g.dst, g.mask),
                                 (w.src, w.dst, w.mask), cert)
        for g, w in zip(tst, jst):
            assert_rings_equal(g, w)
        assert [x.folds for x in tst] == [1, 1]
