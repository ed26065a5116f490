"""Port parity of the certificate registry and the vertex-connectivity
certificates: ``repro_torch.core.certs`` and ``core.certificate``'s
``sfs``/``hybrid`` builders and warm-start merge against ``repro``'s on the
same numpy inputs (``device="cpu"``). Tolerance: exact equality, slot for
slot (every output is an integer or a boolean)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.bridges_dense import SMOKE
from repro.core import certificate as jcert
from repro.core import certs as jcerts
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core import certificate as tcert
from repro_torch.core import certs as tcerts
from repro_torch.interop import edgelist_from_numpy

from helpers import bucketed_graph

N = 48  # the cert worlds of tests/test_certs.py: n_bucket 64, cap 256
CAP = 256


def _np(x):
    return np.asarray(x)


def _pair(src, dst, n, capacity=None):
    jel = jds.EdgeList.from_arrays(src, dst, n, capacity=capacity)
    tel = edgelist_from_numpy(_np(jel.src), _np(jel.dst), _np(jel.mask), n,
                              device="cpu")
    return jel, tel


def _same(want, got):
    """Two flat sequences of arrays/tensors, equal leaf for leaf."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert _np(a).dtype == b.numpy().dtype
        assert np.array_equal(_np(a), b.numpy())


def _leaves(el):
    return (el.src, el.dst, el.mask)


def _worlds():
    """(name, src, dst, n, capacity): failure scenarios, the sparse / path
    / barbell worlds of tests/test_certs.py, bucketed multigraphs, smoke."""
    out = [(f"scenario{i}", sc["src"], sc["dst"], sc["n"], None)
           for i, sc in enumerate(gen.failure_scenarios())]
    bs, bd, _, bn = gen.barbell(6, 8)
    path = np.arange(N - 1, dtype=np.int32)
    out += [("sparse", *gen.random_graph(N, 150, seed=3), N, CAP),
            ("sparser", *gen.random_graph(N, N, seed=4), N, CAP),
            ("path", path, path + 1, N, CAP),
            ("barbell", bs, bd, bn, CAP)]
    for seed in (0, 2):
        src, dst, n, el = bucketed_graph(seed, simple=False)
        out.append((f"bucket{seed}m", src, dst, n, el.capacity))
    s, d, _ = gen.planted_bridge_graph(SMOKE.n_nodes, SMOKE.n_edges, 3, seed=0)
    out.append(("smoke", s, d, SMOKE.n_nodes, None))
    return out


WORLDS = _worlds()
IDS = [w[0] for w in WORLDS]


# ----------------------------------------------------------------- builders
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_sfs_certificate_matches(world):
    _, src, dst, n, cap = world
    jel, tel = _pair(src, dst, n, capacity=cap)
    jc, jp, jl, (jr1, jr2) = jcert.sfs_certificate_ex(jel)
    tc, tp, tl, (tr1, tr2) = tcert.sfs_certificate_ex(tel)
    _same(_leaves(jc) + (jp, jl), _leaves(tc) + (tp, tl))
    assert (int(jr1), int(jr2)) == (tr1, tr2)
    _same(_leaves(jcert.sfs_certificate(jel)),
          _leaves(tcert.sfs_certificate(tel)))


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_hybrid_certificate_matches(world):
    _, src, dst, n, cap = world
    jel, tel = _pair(src, dst, n, capacity=cap)
    jc, jr = jcert.hybrid_certificate_ex(jel)
    tc, tr = tcert.hybrid_certificate_ex(tel)
    _same(_leaves(jc), _leaves(tc))
    assert tuple(int(r) for r in jr) == tr
    _same(_leaves(jcert.hybrid_certificate(jel)),
          _leaves(tcert.hybrid_certificate(tel)))


def test_hybrid_bounds_bfs_rounds_on_a_path():
    """On a long path the hybrid contracts the chain: its BFS passes take a
    few rounds where the SFS certificate takes one per vertex."""
    _, src, dst, n, cap = WORLDS[IDS.index("path")]
    _, tel = _pair(src, dst, n, capacity=cap)
    _, _, _, (r1, _) = tcert.sfs_certificate_ex(tel)
    _, (_, h1, h2) = tcert.hybrid_certificate_ex(tel)
    assert r1 == n and max(h1, h2) <= 3


@pytest.mark.parametrize("idx", [0, 4, 7])
def test_merge_certificates_incremental_matches(idx):
    """Certify the first half, then fold in the second with the warm-start
    merge: certificate, both label arrays and both round counts."""
    _, src, dst, n, _ = WORLDS[idx]
    half = len(src) // 2
    cap = jds.admission_capacity(len(src))
    ja, ta = _pair(src[:half], dst[:half], n, capacity=cap)
    jb, tb = _pair(src[half:], dst[half:], n, capacity=cap)
    jc, jl1, jl2, _ = jcert.sparse_certificate_ex(ja)
    tc, tl1, tl2, _ = tcert.sparse_certificate_ex(ta)
    jm, jm1, jm2, jr = jcert.merge_certificates_incremental(jc, jl1, jl2, jb)
    tm, tm1, tm2, tr = tcert.merge_certificates_incremental(tc, tl1, tl2, tb)
    _same(_leaves(jm) + (jm1, jm2), _leaves(tm) + (tm1, tm2))
    assert tuple(int(r) for r in jr) == tr


# ----------------------------------------------------------------- registry
def test_registry_contents_match():
    assert tcerts.CERTIFICATE_NAMES == jcerts.CERTIFICATE_NAMES == (
        "2ec", "sfs", "hybrid")
    assert tcerts.primary_certificate() == jcerts.primary_certificate()
    assert tcerts.PRESERVABLE == jcerts.PRESERVABLE
    for name in tcerts.certificate_names():
        a, b = jcerts.get_certificate(name), tcerts.get_certificate(name)
        assert (a.preserves, a.lazy, a.warm_merge, a.summary) == (
            b.preserves, b.lazy, b.warm_merge, b.summary)
    assert tcerts.certificate_builder("hybrid") is tcert.hybrid_certificate
    assert tcerts.certificate_builder("sfs") is tcert.sfs_certificate
    assert tcerts.certificate_builder("2ec") is tcert.sparse_certificate


def test_registry_validation_errors():
    ok = tcerts.get_certificate("sfs")
    with pytest.raises(ValueError, match="choose from"):
        tcerts.get_certificate("nope")
    with pytest.raises(ValueError, match="non-empty"):
        tcerts.register_certificate(dataclasses.replace(ok, name=""))
    with pytest.raises(ValueError, match="unknown structure"):
        tcerts.register_certificate(dataclasses.replace(
            ok, name="bad", preserves=frozenset({"kappa9"})))
    assert "bad" not in tcerts.certificate_names()
    with pytest.raises(ValueError, match="no chunks"):
        ok.stream_load([], CAP)


def _chunks(src, dst, n, k, chunk_cap):
    """The edges split into ``k`` chunks of ``chunk_cap`` slots each, in
    both packages."""
    bounds = np.linspace(0, len(src), k + 1).astype(int)
    pairs = [_pair(src[a:b], dst[a:b], n, capacity=chunk_cap)
             for a, b in zip(bounds[:-1], bounds[1:])]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("name", ["2ec", "sfs", "hybrid"])
@pytest.mark.parametrize("world", ["sparse", "barbell", "scenario1"])
def test_stream_load_matches(name, world):
    """``stream_load`` over three chunks equals the JAX package's leaf for
    leaf, and answers every kind the certificate preserves as one-shot
    ``load_state`` of the whole buffer does."""
    _, src, dst, n, _ = WORLDS[IDS.index(world)]
    jchunks, tchunks = _chunks(src, dst, n, 3, 128)
    jstate = jcerts.get_certificate(name).stream_load(jchunks, CAP)
    tstate = tcerts.get_certificate(name).stream_load(tchunks, CAP)
    _same(jstate, tstate)
    _, tel = _pair(src, dst, n, capacity=CAP)
    cert = tcerts.get_certificate(name)
    one_shot = cert.load_state(tel, CAP)
    kinds = (("bridges", "2ecc", "bridge_tree") if name == "2ec"
             else ("cuts", "bcc"))
    for kind in kinds:
        host = get_analysis(kind).host_fn
        truth = host(np.asarray(src), np.asarray(dst), n)
        for state in (tstate, one_shot):
            s, d, m = (x.numpy() for x in state[:3])
            got = host(s[m], d[m], n)
            assert (np.array_equal(got, truth) if kind == "2ecc"
                    else got == truth)


def test_fold_state_matches():
    """One ``fold_state`` per certificate from a loaded state, leaf for
    leaf (the 2ec warm fold and the rescan fold)."""
    _, src, dst, n, _ = WORLDS[IDS.index("sparse")]
    half = len(src) // 2
    ja, ta = _pair(src[:half], dst[:half], n, capacity=CAP)
    jb, tb = _pair(src[half:], dst[half:], n, capacity=128)
    for name in tcerts.certificate_names():
        jc, tc = jcerts.get_certificate(name), tcerts.get_certificate(name)
        _same(jc.fold_state(jc.load_state(ja, CAP), jb, CAP),
              tc.fold_state(tc.load_state(ta, CAP), tb, CAP))
