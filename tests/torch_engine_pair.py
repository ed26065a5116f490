"""One call sequence through two engines: ``repro.engine.BridgeEngine``
(JAX on the CPU) and ``repro_torch.engine.BridgeEngine(device="cpu")``.

``EnginePair.call`` runs a method on both with the same numpy inputs and
holds the answers equal; after every call the live state (every
materialized certificate state slot for slot, and the full buffer, or,
when the live graph is streamed, the host spill ring segment for segment)
and the ``snapshot()`` counters, ``ingest`` and ``checkpoint`` among
them, and the checkpoint clock (applied write ops) are held equal too.
Tolerance: exact equality (every output is an integer, a boolean or a set
of them).
"""
import numpy as np

from repro.engine import BridgeEngine as JaxEngine
from repro_torch.engine import BridgeEngine as TorchEngine

#: the counters of ``snapshot()`` the two engines must agree on
SNAPSHOT_KEYS = ("programs", "hits", "misses", "traces", "rebuilds",
                 "rebuilds_total", "live_graph_edges", "live_bytes",
                 "peak_live_bytes", "ingest", "checkpoint")


def same(got, want) -> bool:
    """Answers equal: arrays by dtype and value, lists element by element,
    everything else by ``==``."""
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(same(g, w) for g, w in zip(got, want)))
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want))
    return got == want


def assert_buffers_equal(got, want, what: str) -> None:
    """Torch tensors against JAX arrays, dtype and value, bit for bit."""
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert np.array_equal(g, w), (what, i)


def assert_rings_equal(got, want) -> None:
    """Two ``ChunkedEdgeStream``s: the same spill ring segment for segment
    (dtype and value), and the same counters."""
    assert got.ring_segments == want.ring_segments
    for (gs, gd), (ws, wd) in zip(got._ring, want._ring):
        for g, w in ((gs, ws), (gd, wd)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    for key in ("n_nodes", "chunk_bucket", "count", "chunks_in", "folds",
                "spilled_edges", "replays", "device_chunk_bytes"):
        assert getattr(got, key) == getattr(want, key), key


class EnginePair:
    """The two engines, built with the same keywords."""

    def __init__(self, **kw):
        self.jax = JaxEngine(**kw)
        self.torch = TorchEngine(device="cpu", **kw)

    def call(self, method: str, *args, **kw):
        want = getattr(self.jax, method)(*args, **kw)
        got = getattr(self.torch, method)(*args, **kw)
        if isinstance(want, JaxEngine):  # load, load_stream, ingest_chunk
            assert got is self.torch, method
        else:
            assert same(got, want), (method, got, want)
        self.check_state()
        return got

    def check_state(self) -> None:
        """Live buffers and counters equal (the live state once loaded)."""
        jl, tl = self.jax._live, self.torch._live
        assert (jl is None) == (tl is None)
        if jl is not None:
            assert jl.count == tl.count and jl.n_bucket == tl.n_bucket
            assert set(jl.certs) == set(tl.certs)
            for name, state in jl.certs.items():
                assert (state is None) == (tl.certs[name] is None), name
                if state is not None:
                    assert_buffers_equal(tl.certs[name], state, name)
            assert (jl.full is None) == (tl.full is None)
            if jl.full is None:
                assert_rings_equal(tl.stream, jl.stream)
            else:
                assert_buffers_equal(tl.full, jl.full, "full")
            assert tl.rebuilds == jl.rebuilds
        assert self.torch._write_ops == self.jax._write_ops
        js, ts = self.jax.snapshot(), self.torch.snapshot()
        for key in SNAPSHOT_KEYS:
            assert ts.get(key) == js.get(key), (key, ts.get(key), js.get(key))
