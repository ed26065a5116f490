"""Port parity of buffers, the Borůvka forest and the 2-edge certificate:
the same numpy inputs through ``repro`` (JAX on the CPU, defaults) and
``repro_torch`` (``device="cpu"``). Tolerance: exact equality (every output
is an integer or a boolean)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.bridges_dense import SMOKE
from repro.core import certificate as jcert
from repro.core.forest import connected_components as j_components
from repro.core.forest import scan_first_forest as j_sfs
from repro.core.forest import scan_first_forest_ex as j_sfs_ex
from repro.core.forest import spanning_forest_ex as j_forest_ex
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch.core import certificate as tcert
from repro_torch.core.forest import (
    _sfs_impl,
    connected_components,
    scan_first_forest,
    scan_first_forest_ex,
    spanning_forest_ex,
)
from repro_torch.kernels.boruvka_round.ref import frontier_round_ref
from repro_torch.graph import datastructs as tds
from repro_torch.interop import edgelist_from_numpy, edgelist_to_numpy

from helpers import bucketed_graph


def _np(x):
    return np.asarray(x)


def _pair(src, dst, n, capacity=None):
    """The same buffer in both packages: (JAX EdgeList, port EdgeList)."""
    jel = jds.EdgeList.from_arrays(src, dst, n, capacity=capacity)
    tel = edgelist_from_numpy(_np(jel.src), _np(jel.dst), _np(jel.mask), n,
                              device="cpu")
    return jel, tel


def _same_buffer(jel, tel):
    for a, b in zip((jel.src, jel.dst, jel.mask), edgelist_to_numpy(tel)):
        assert a.dtype == b.dtype
        assert np.array_equal(_np(a), b)
    assert jel.n_nodes == tel.n_nodes


def _worlds():
    """(name, src, dst, n, capacity): the failure worlds, the bucketed
    shapes (simple and multigraph) and the smoke configuration."""
    out = [(f"scenario{i}", sc["src"], sc["dst"], sc["n"], None)
           for i, sc in enumerate(gen.failure_scenarios())]
    for seed in range(3):
        for simple in (True, False):
            src, dst, n, el = bucketed_graph(seed, simple=simple)
            out.append((f"bucket{seed}{'s' if simple else 'm'}", src, dst, n,
                        el.capacity))
    s, d, _ = gen.planted_bridge_graph(SMOKE.n_nodes, SMOKE.n_edges, 3, seed=0)
    out.append(("smoke", s, d, SMOKE.n_nodes, None))
    return out


WORLDS = _worlds()
IDS = [w[0] for w in WORLDS]


# ------------------------------------------------------------------ buffers
def test_admission_capacity_matches():
    for m in (0, 1, 15, 16, 17, 1000, 10_000_000):
        for minimum in (1, 16):
            assert (tds.admission_capacity(m, minimum)
                    == jds.admission_capacity(m, minimum))


def test_pad_and_compact_match():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 20, 40).astype(np.int32)
    dst = rng.integers(0, 20, 40).astype(np.int32)
    jel, tel = _pair(src, dst, 20)
    _same_buffer(jds.pad_edges(jel, 64), tds.pad_edges(tel, 64))
    keep = rng.random(64) < 0.5
    jp, tp = jds.pad_edges(jel, 64), tds.pad_edges(tel, 64)
    for cap in (8, 40, 64, 80):  # 8: the selection overflows the capacity
        _same_buffer(jds.compact_edges(jp, cap, keep=jnp.asarray(keep)),
                     tds.compact_edges(tp, cap, keep=torch.as_tensor(keep)))
    # shrinking back to the real edges keeps them; one slot less raises
    _same_buffer(jds.pad_edges(jp, 40), tds.pad_edges(tp, 40))
    with pytest.raises(ValueError, match="would drop 1 of 40"):
        tds.pad_edges(tp, 39)
    with pytest.raises(ValueError, match="would drop 1 of 40"):
        jds.pad_edges(jp, 39)
    _same_buffer(jds.concat_edges(jel, jp), tds.concat_edges(tel, tp))


def test_build_csr_matches():
    src, dst, n, _ = bucketed_graph(4, simple=False)
    for a, b in zip(jds.build_csr(src, dst, n), tds.build_csr(src, dst, n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("ids,n", [
    (([0, 1, 2], [1, 2, -1]), 3),      # -1: add.at's slot 0
    (([0, -3, 2], [1, 2, -5]), 3),     # wraps to the last slots
    (([], []), 4),                     # no edges
    (([0, 1], [1, 3]), 3),             # id n: add.at raises
    (([0, 1], [1, -6]), 3),            # id below -(n + 2): raises
])
def test_build_csr_out_of_range_ids_as_reference(ids, n):
    src, dst = (np.array(a, np.int32) for a in ids)
    outcomes = []
    for fn in (jds.build_csr, tds.build_csr):
        try:
            outcomes.append(fn(src, dst, n))
        except IndexError:
            outcomes.append(IndexError)
    want, got = outcomes
    if want is IndexError:
        assert got is IndexError
    else:
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ forests
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_spanning_forest_matches(world):
    _, src, dst, n, cap = world
    jel, tel = _pair(src, dst, n, capacity=cap)
    jf, jl, jr = j_forest_ex(jel)
    tf, tl, tr = spanning_forest_ex(tel)
    assert tf.dtype == torch.bool and tl.dtype == torch.int32
    assert np.array_equal(_np(jf), tf.numpy())
    assert np.array_equal(_np(jl), tl.numpy())
    assert int(jr) == tr
    assert np.array_equal(_np(j_components(jel)),
                          connected_components(tel).numpy())


@pytest.mark.parametrize("world", WORLDS[:3] + WORLDS[-1:],
                         ids=IDS[:3] + IDS[-1:])
def test_spanning_forest_warm_start_matches(world):
    """``init_labels``: warm start from the components of the first half of
    the edges, then hook the whole buffer."""
    _, src, dst, n, cap = world
    half = len(src) // 2
    jhalf, _ = _pair(src[:half], dst[:half], n)
    init = np.array(j_forest_ex(jhalf)[1])
    jel, tel = _pair(src, dst, n, capacity=cap)
    jf, jl, jr = j_forest_ex(jel, init_labels=jnp.asarray(init))
    tf, tl, tr = spanning_forest_ex(tel, init_labels=torch.as_tensor(init))
    assert np.array_equal(_np(jf), tf.numpy())
    assert np.array_equal(_np(jl), tl.numpy())
    assert int(jr) == tr


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_scan_first_forest_matches(world):
    """The BFS-layer forest: forest mask, parent, level, root labels and
    the round count, against the JAX package's."""
    _, src, dst, n, cap = world
    jel, tel = _pair(src, dst, n, capacity=cap)
    want = j_sfs_ex(jel)
    got = scan_first_forest_ex(tel)
    for a, b, dtype in zip(want[:4], got[:4], (torch.bool,) + (torch.int32,) * 3):
        assert b.dtype == dtype
        assert np.array_equal(_np(a), b.numpy())
    assert int(want[4]) == got[4]
    for a, b in zip(j_sfs(jel), scan_first_forest(tel)):
        assert np.array_equal(_np(a), b.numpy())


def test_scan_first_forest_path_rounds():
    """A path rooted at vertex 0 needs one round per layer (n - 1 layers,
    then one round that reaches nothing), as in the JAX package; the plain
    round function gives the same forest."""
    n = 40
    src = np.arange(n - 1, dtype=np.int32)
    jel, tel = _pair(src, src + 1, n)
    want = j_sfs_ex(jel)
    got = scan_first_forest_ex(tel)
    assert got[4] == int(want[4]) == n
    assert got[2].tolist() == list(range(n))
    _, labels, _ = spanning_forest_ex(tel)
    plain = _sfs_impl(tel.src, tel.dst, tel.mask, n, labels,
                      round_fn=frontier_round_ref)
    for a, b in zip(got[:4], plain[:4]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- certificates
@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_sparse_certificate_matches(world):
    _, src, dst, n, cap = world
    jel, tel = _pair(src, dst, n, capacity=cap)
    jc, jl1, jl2, (jr1, jr2) = jcert.sparse_certificate_ex(jel)
    tc, tl1, tl2, (tr1, tr2) = tcert.sparse_certificate_ex(tel)
    _same_buffer(jc, tc)
    assert np.array_equal(_np(jl1), tl1.numpy())
    assert np.array_equal(_np(jl2), tl2.numpy())
    assert (int(jr1), int(jr2)) == (tr1, tr2)
    _same_buffer(jcert.sparse_certificate(jel), tcert.sparse_certificate(tel))
    jm, jf1 = jcert.certificate_mask(jel)
    tm, tf1 = tcert.certificate_mask(tel)
    assert np.array_equal(_np(jm), tm.numpy())
    assert np.array_equal(_np(jf1), tf1.numpy())
    assert tcert.certificate_capacity(n) == jcert.certificate_capacity(n)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_merge_certificates_matches(idx):
    """Two halves of a world, certified apart and merged (one paper merge
    step): the same slots in both packages."""
    _, src, dst, n, _ = WORLDS[idx]
    half = len(src) // 2
    cap = tds.admission_capacity(len(src))
    ja, ta = _pair(src[:half], dst[:half], n, capacity=cap)
    jb, tb = _pair(src[half:], dst[half:], n, capacity=cap)
    _same_buffer(
        jcert.merge_certificates(jcert.sparse_certificate(ja),
                                 jcert.sparse_certificate(jb)),
        tcert.merge_certificates(tcert.sparse_certificate(ta),
                                 tcert.sparse_certificate(tb)))
