"""Port parity of the device final stage's machinery: the Euler tour, the
sparse table range reduce and every field of ``tour_state``, JAX on the CPU
against ``repro_torch`` on ``device="cpu"``. Tolerance: exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.bridges_dense import SMOKE
from repro.connectivity.common import tour_state as j_tour_state
from repro.core import euler as jeuler
from repro.core.forest import spanning_forest as j_forest
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch.connectivity.common import tour_state
from repro_torch.core import euler as teuler
from repro_torch.interop import edgelist_from_numpy

from helpers import bucketed_graph


def _isolated_zero():
    """A cycle and a pendant path over vertices 1..7; vertex 0 is isolated."""
    src = np.array([1, 2, 3, 4, 4, 6], np.int32)
    dst = np.array([2, 3, 1, 5, 1, 7], np.int32)
    return src, dst, 9


def _worlds():
    """(name, src, dst, mask, n) buffers, padded as the engine pads."""
    raw = [(f"scenario{i}", sc["src"], sc["dst"], sc["n"])
           for i, sc in enumerate(gen.failure_scenarios())]
    for seed in range(3):
        for simple in (True, False):
            src, dst, n, _ = bucketed_graph(seed, simple=simple)
            raw.append((f"bucket{seed}{'s' if simple else 'm'}", src, dst, n))
    raw.append(("isolated0",) + _isolated_zero())
    s, d, _ = gen.planted_bridge_graph(SMOKE.n_nodes, SMOKE.n_edges, 3, seed=0)
    raw.append(("smoke", s, d, SMOKE.n_nodes))
    out = []
    for name, src, dst, n in raw:
        el = jds.EdgeList.from_arrays(src, dst, n,
                                      capacity=jds.admission_capacity(len(src)))
        out.append((name, np.asarray(el.src), np.asarray(el.dst),
                    np.asarray(el.mask), n))
    # every slot masked: no tree, every vertex isolated
    out.append(("all_masked", np.zeros(16, np.int32), np.zeros(16, np.int32),
                np.zeros(16, bool), 6))
    return out


WORLDS = _worlds()
IDS = [w[0] for w in WORLDS]


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, what
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_euler_tour_matches(world):
    _, src, dst, mask, n = world
    jel = jds.EdgeList(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), n)
    tree, labels = (np.array(x) for x in j_forest(jel))
    tsrc = np.where(tree, src, 0).astype(np.int32)
    tdst = np.where(tree, dst, 0).astype(np.int32)
    want = jeuler.euler_tour(jnp.asarray(tsrc), jnp.asarray(tdst),
                             jnp.asarray(tree), jnp.asarray(labels), n)
    got = teuler.euler_tour(torch.as_tensor(tsrc), torch.as_tensor(tdst),
                            torch.as_tensor(tree), torch.as_tensor(labels), n)
    assert set(want) == set(got)
    for key in want:
        _same(want[key], got[key], key)


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_tour_state_matches(world):
    _, src, dst, mask, n = world
    want = jax.jit(j_tour_state, static_argnums=3)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), n)
    tel = edgelist_from_numpy(src, dst, mask, n, device="cpu")
    got = tour_state(tel.src, tel.dst, tel.mask, n)
    assert set(want) == set(got)
    for key in want:
        _same(want[key], got[key], key)


@pytest.mark.parametrize("p", [1, 2, 7, 64, 100])
def test_sparse_table_range_reduce_matches(p):
    rng = np.random.default_rng(p)
    values = rng.integers(-1000, 1000, p).astype(np.int32)
    lo = rng.integers(-2, p + 2, 50).astype(np.int32)
    hi = (lo + rng.integers(-3, p, 50)).astype(np.int32)
    for jfn, tfn, ident in ((jnp.minimum, torch.minimum, jds.INF32),
                            (jnp.maximum, torch.maximum, -1)):
        jt = jeuler.build_sparse_table(jnp.asarray(values), jfn, ident)
        tt = teuler.build_sparse_table(torch.as_tensor(values), tfn)
        _same(jt, tt, "table")
        _same(jeuler.range_reduce(jt, jnp.asarray(lo), jnp.asarray(hi), jfn),
              teuler.range_reduce(tt, torch.as_tensor(lo), torch.as_tensor(hi),
                                  tfn), "range_reduce")
