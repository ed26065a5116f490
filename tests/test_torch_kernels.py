"""Port parity of the kernel modules on the CPU: the port's plain versions
and dispatch against the JAX package's Pallas kernels (interpret mode) and
jnp oracles, on the shapes of tests/test_kernels.py.

The connectivity kernels' outputs are integers, so their tolerance is exact
equality; embedding_bag's are floats, held within 1e-5 (the sums run in
another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.graph import generators as gen
from repro.graph.datastructs import EdgeList as JEdgeList
from repro.kernels.boruvka_round.kernel import (
    boruvka_round_pallas,
    frontier_round_pallas,
)
from repro.kernels.boruvka_round.ops import (
    boruvka_round_bytes as j_boruvka_round_bytes,
)
from repro.kernels.boruvka_round.ops import (
    frontier_round_bytes as j_frontier_round_bytes,
)
from repro.kernels.boruvka_round.ref import boruvka_round_ref as j_boruvka_ref
from repro.kernels.boruvka_round.ref import frontier_round_ref as j_frontier_ref
from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag_ref
from repro.kernels.segment_min.kernel import segment_min_pallas
from repro.kernels.segment_min.ref import segment_min_ref as j_segment_min_ref
from repro_torch.core.api import pad_graph
from repro_torch.core.forest import hook_round
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.boruvka_round import (
    EDGE_SLOT_BYTES,
    boruvka_round,
    boruvka_round_bytes,
    frontier_round,
    frontier_round_bytes,
    kernel_path,
)
from repro_torch.kernels.boruvka_round.kernel import PACKED_INF, split_packed
from repro_torch.kernels.boruvka_round.ref import (
    boruvka_round_ref,
    frontier_round_ref,
)
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_bytes,
    embedding_bag_bytes_read,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.segment_min import segment_min
from repro_torch.kernels.segment_min.kernel import check_key_space
from repro_torch.kernels.segment_min.ref import segment_min_ref

INF32 = np.iinfo(np.int32).max


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_both(pallas_fn, ref_fn, *args):
    """The JAX kernel in interpret mode and its oracle, which must agree."""
    got = np.asarray(pallas_fn(*args, interpret=True))
    want = np.asarray(ref_fn(*args))
    assert np.array_equal(got, want)
    return want


def _segment_min_case(keys, ids, n):
    want = _jax_both(segment_min_pallas, j_segment_min_ref,
                     jnp.asarray(keys), jnp.asarray(ids), n)
    for fn in (segment_min_ref, segment_min):
        got = fn(_t(keys), _t(ids), n)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "e,n", [(7, 3), (100, 30), (1024, 512), (1500, 513), (4096, 1024), (33, 1)]
)
def test_segment_min_shapes(e, n):
    rng = np.random.default_rng(e * 31 + n)
    keys = rng.integers(0, 1 << 20, e).astype(np.int32)
    ids = rng.integers(0, n, e).astype(np.int32)
    _segment_min_case(keys, ids, n)


def test_segment_min_empty_segments_inf():
    _segment_min_case(np.array([5, 3], np.int32), np.array([0, 0], np.int32), 4)


def test_segment_min_drops_out_of_range_ids_and_inf_keys():
    rng = np.random.default_rng(7)
    e, n = 600, 128
    keys = rng.integers(-50, 1 << 15, e).astype(np.int32)
    keys[::7] = INF32
    ids = rng.integers(-20, n + 20, e).astype(np.int32)
    ids[:3] = [np.iinfo(np.int32).min, INF32, n]
    _segment_min_case(keys, ids, n)


def _edge_buffer(e, n, seed, self_loop_frac=0.1, mask_frac=0.2):
    """tests/test_kernels.py's masked multigraph buffer: duplicates,
    self-loops, tombstones."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    loops = rng.random(e) < self_loop_frac
    dst = np.where(loops, src, dst)
    if e >= 8:
        src[e // 2 : e // 2 + e // 4] = src[: e // 4]
        dst[e // 2 : e // 2 + e // 4] = dst[: e // 4]
    mask = rng.random(e) >= mask_frac
    return src, dst, mask


def _boruvka_case(src, dst, mask, labels, n):
    want = _jax_both(boruvka_round_pallas, j_boruvka_ref, jnp.asarray(src),
                     jnp.asarray(dst), jnp.asarray(mask), jnp.asarray(labels),
                     n)
    for fn in (boruvka_round_ref, boruvka_round):
        got = fn(_t(src), _t(dst), _t(mask), _t(labels), n)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "e,n", [(7, 5), (100, 30), (1024, 512), (1500, 513), (2048, 1024), (33, 1)]
)
def test_boruvka_round_shapes(e, n):
    rng = np.random.default_rng(e * 17 + n)
    src, dst, mask = _edge_buffer(e, n, seed=e + n)
    labels = rng.integers(0, n, n).astype(np.int32)
    _boruvka_case(src, dst, mask, labels, n)


def test_boruvka_round_all_masked_or_loops():
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 1, 3, 0], np.int32)  # slot 1 is a self-loop
    mask = np.array([False, True, False, False])
    labels = np.arange(5, dtype=np.int32)
    _boruvka_case(src, dst, mask, labels, 5)
    out = boruvka_round(_t(src), _t(dst), _t(mask), _t(labels), 5)
    assert (out.numpy() == INF32).all()


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_boruvka_round_parity_on_failure_scenarios(idx):
    sc = gen.failure_scenarios()[idx]
    el = JEdgeList.from_arrays(sc["src"], sc["dst"], sc["n"])
    n = el.n_nodes
    rng = np.random.default_rng(idx)
    for labels in (np.arange(n, dtype=np.int32),
                   rng.integers(0, n, n).astype(np.int32)):
        _boruvka_case(np.asarray(el.src), np.asarray(el.dst),
                      np.asarray(el.mask), labels, n)


def test_key_space_guard_rejects_overflow():
    ok = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="segment-id space"):
        segment_min(ok, torch.zeros(2, dtype=torch.int32),
                    num_segments=(1 << 31) - 10)
    with pytest.raises(ValueError, match="segment-id space"):
        boruvka_round(ok, ok, torch.ones(2, dtype=torch.bool),
                      torch.zeros(1, dtype=torch.int32),
                      num_segments=(1 << 31) - 10)
    with pytest.raises(ValueError, match="edge-key space"):
        check_key_space((1 << 31) - 10, 4)
    check_key_space(1 << 20, 1 << 20)
    # the same bounds as the JAX guard: the last accepted shapes agree
    from repro.kernels.segment_min.kernel import check_key_space as j_check

    for e, n in ((INF32 - 1024, 1), (1, INF32 - 512)):
        check_key_space(e, n)
        j_check(e, n)
    for e, n in ((INF32 - 1023, 1), (1, INF32 - 511)):
        with pytest.raises(ValueError):
            check_key_space(e, n)
        with pytest.raises(ValueError):
            j_check(e, n)


def test_ops_validate_inputs_and_dispatch_on_cpu():
    reset_launch_counts()
    keys = torch.tensor([3, 1], dtype=torch.int32)
    ids = torch.tensor([0, 0], dtype=torch.int32)
    assert segment_min(keys, ids, 2).tolist() == [1, INF32]
    with pytest.raises(TypeError):
        segment_min(keys.long(), ids, 2)
    with pytest.raises(ValueError):
        segment_min(keys, ids[:1], 2)
    with pytest.raises(ValueError):
        segment_min(torch.arange(4, dtype=torch.int32)[::2], ids, 2)
    src = torch.tensor([0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 2], dtype=torch.int32)
    msk = torch.tensor([True, True])
    labels = torch.arange(3, dtype=torch.int32)
    assert boruvka_round(src, dst, msk, labels, 3).tolist() == [0, 0, 1]
    with pytest.raises(TypeError):
        boruvka_round(src, dst, msk.int(), labels, 3)
    assert kernel_path("cpu") == "ref" and kernel_path("cuda") == "cuda"
    # the CPU path runs the plain version and launches nothing
    assert launch_counts() == {"boruvka_round": 0, "frontier_round": 0,
                               "segment_min": 0, "embedding_bag": 0,
                               "flash_attention_mma": 0,
                               "flash_attention_tf32x3": 0}


def test_round_byte_model_matches_jax():
    """With every slot live the round moves the JAX package's fused byte
    model (9 B per slot) plus the labels read and the result written; a
    masked slot costs only its mask byte."""
    assert EDGE_SLOT_BYTES == 9
    for e, n in ((1, 1), (1000, 64), (1 << 24, 1 << 17)):
        assert boruvka_round_bytes(e, n, e) == j_boruvka_round_bytes(
            e, fused=True) + 8 * n
        assert boruvka_round_bytes(e, n, 0) == e + 8 * n
        assert (boruvka_round_bytes(e, n, e // 2)
                == boruvka_round_bytes(e, n, 0) + 8 * (e // 2))


def _out_of_range(src, dst, n, seed):
    """A fifth of the endpoints moved outside ``[0, n)``: some in
    ``[-n, -1]`` (JAX's gather wraps them), some beyond (clamped)."""
    rng = np.random.default_rng(seed)
    src, dst = src.copy(), dst.copy()
    for a in (src, dst):
        hit = rng.random(a.shape[0]) < 0.2
        a[hit] = rng.integers(-3 * n, 3 * n, int(hit.sum()))
    return src, dst


def test_boruvka_round_wraps_negative_ids_as_jax():
    """A negative endpoint gathers ``labels[n + id]``, as JAX's gather
    does, and ids beyond the ends are clamped; the contract is the JAX
    ``boruvka_round_ref``. (The Pallas kernel pads the labels to a multiple
    of 512 and agrees with its own oracle on such ids only where n is one,
    so it is compared there.)"""
    src = np.array([-1, 0], np.int32)
    dst = np.array([0, 1], np.int32)
    mask = np.array([True, False])
    labels = np.array([0, 1], np.int32)
    want = np.asarray(j_boruvka_ref(*map(jnp.asarray, (src, dst, mask,
                                                      labels)), 2))
    assert want.tolist() == [0, 0]  # labels[-1] is labels[1]
    assert np.array_equal(boruvka_round_ref(*map(_t, (src, dst, mask, labels)),
                                            2).numpy(), want)
    for n in (30, 512):
        s, d, m = _edge_buffer(1500, n, seed=n)
        s, d = _out_of_range(s, d, n, seed=n + 1)
        labels = np.random.default_rng(n).integers(0, n, n).astype(np.int32)
        args = tuple(map(jnp.asarray, (s, d, m, labels)))
        want = np.asarray(j_boruvka_ref(*args, n))
        if n % 512 == 0:
            assert np.array_equal(
                np.asarray(boruvka_round_pallas(*args, n, interpret=True)),
                want)
        for fn in (boruvka_round_ref, boruvka_round):
            got = fn(*map(_t, (s, d, m, labels)), n)
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("labels", ["identity", "round2"])
def test_boruvka_round_on_the_sorted_planted_buffer(labels):
    """The round as the bridge pipeline runs it: a planted-bridge buffer in
    its generator's order (slots sorted by their smaller endpoint, padding
    after), every live non-loop slot valid, with the first round's identity
    labels and the labels after one hooking round (a few components)."""
    s, d, _ = gen.planted_bridge_graph(300, 1800, 3, seed=2)
    key = np.minimum(s, d).astype(np.int64) * 300 + np.maximum(s, d)
    assert (np.diff(key) > 0).all()  # the generator's order
    el = pad_graph(s, d, 300, device="cpu")
    n = el.n_nodes
    valid = el.mask & (el.src != el.dst)
    lab = torch.arange(n, dtype=torch.int32)
    if labels == "round2":
        lab = hook_round(el.src, el.dst, valid, lab, n)[0]
        assert 1 < torch.unique(lab[:300]).numel() < 300
    _boruvka_case(el.src.numpy(), el.dst.numpy(), valid.numpy(), lab.numpy(),
                  n)


# ------------------------------------------------------------ frontier round
def _frontier_case(src, dst, mask, frontier, visited, n, pallas=True):
    """The port's plain version and op against the JAX oracle and, where
    ``pallas``, the Pallas kernel in interpret mode."""
    args = tuple(map(jnp.asarray, (src, dst, mask, frontier, visited)))
    want = [np.asarray(x) for x in j_frontier_ref(*args, n)]
    if pallas:
        got = frontier_round_pallas(*args, n, interpret=True)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), b)
    for fn in (frontier_round_ref, frontier_round):
        got = fn(*map(_t, (src, dst, mask, frontier, visited)), n)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            assert np.array_equal(a.numpy(), b)
    return want


@pytest.mark.parametrize(
    "e,n", [(7, 5), (100, 30), (1024, 512), (1500, 513), (2048, 1024)]
)
def test_frontier_round_shapes(e, n):
    rng = np.random.default_rng(e * 13 + n)
    src, dst, mask = _edge_buffer(e, n, seed=e * 3 + n)
    frontier = rng.random(n) < 0.4
    visited = (rng.random(n) < 0.5) | frontier
    _frontier_case(src, dst, mask, frontier, visited, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frontier_round_property_shape(seed):
    """tests/test_kernels.py's property shape (E = 512, n = 128)."""
    rng = np.random.default_rng(seed ^ 0x5F5F)
    src, dst, mask = _edge_buffer(512, 128, seed=seed + 7)
    frontier = rng.random(128) < 0.3
    visited = (rng.random(128) < 0.5) | frontier
    _frontier_case(src, dst, mask, frontier, visited, 128)


@pytest.mark.parametrize("n", [30, 512])
def test_frontier_round_out_of_range_ids(n):
    """Endpoints outside ``[0, n)``: gathers wrap and clamp as JAX's do and
    arc ids outside the segments are dropped. Against the oracle, and the
    Pallas kernel where n is a multiple of its 512-vertex padding."""
    rng = np.random.default_rng(n)
    src, dst, mask = _edge_buffer(1500, n, seed=n + 3)
    src, dst = _out_of_range(src, dst, n, seed=n + 4)
    frontier = rng.random(n) < 0.4
    visited = (rng.random(n) < 0.5) | frontier
    _frontier_case(src, dst, mask, frontier, visited, n, pallas=n % 512 == 0)


def test_frontier_round_edge_cases():
    # slot 0: 2-1; slots 1-3: three parallel copies of {0, 1}; slot 4 a
    # self-loop at frontier vertex 3; slot 5: 3-4; vertex 5 isolated
    src = np.array([2, 0, 0, 1, 3, 3], np.int32)
    dst = np.array([1, 1, 1, 0, 3, 4], np.int32)
    mask = np.array([True, False, True, True, True, True])
    n = 7
    frontier = np.zeros(n, bool)
    frontier[[0, 2, 3]] = True
    visited = frontier.copy()
    best_p, best_e = _frontier_case(src, dst, mask, frontier, visited, n)
    # vertex 1: minimum frontier neighbour 0 (not 2), minimum live slot to
    # 0 is 2 (slot 1 is masked); vertex 4 by slot 5; nothing else reached
    assert best_p.tolist() == [INF32, 0, INF32, INF32, 3, INF32, INF32]
    assert best_e.tolist() == [INF32, 2, INF32, INF32, 5, INF32, INF32]
    # isolated vertex 0 in the frontier reaches nothing
    fr0 = np.zeros(n, bool)
    fr0[0] = True
    p, e = _frontier_case(src[4:], dst[4:], mask[4:], fr0, fr0, n)
    assert (p == INF32).all() and (e == INF32).all()
    # empty frontier, all-masked buffer: nothing is reached
    for fr, m in ((np.zeros(n, bool), mask), (frontier, np.zeros(6, bool))):
        p, e = _frontier_case(src, dst, m, fr, visited, n)
        assert (p == INF32).all() and (e == INF32).all()


@pytest.mark.parametrize("n,odd_ids", [(30, True), (512, True),
                                       (513, False)])
def test_split_packed_gives_back_the_pair(n, odd_ids):
    """The frontier kernel's packed keys ``best_p * 2^32 + best_e`` split
    back into the plain version's two int32 tensors (negative parents from
    wrapped ids and the INF32 pair included), as the card's op reads
    them."""
    rng = np.random.default_rng(n)
    src, dst, mask = _edge_buffer(1500, n, seed=n + 5)
    if odd_ids:
        src, dst = _out_of_range(src, dst, n, seed=n + 6)
    frontier = rng.random(n) < 0.4
    visited = (rng.random(n) < 0.5) | frontier
    best_p, best_e = frontier_round_ref(
        *map(_t, (src, dst, mask, frontier, visited)), n)
    assert (best_p == INF32).any() and (best_p < INF32).any()
    packed = (best_p.long() << 32) | (best_e.long() & 0xFFFFFFFF)
    assert (packed[best_p == INF32] == PACKED_INF).all()
    got_p, got_e = split_packed(packed)
    for got, want in ((got_p, best_p), (got_e, best_e)):
        assert got.dtype == torch.int32
        assert torch.equal(got, want)


def test_frontier_round_validates_inputs_and_key_space():
    src = torch.tensor([0, 1], dtype=torch.int32)
    msk = torch.tensor([True, True])
    fr = torch.tensor([True, False, False])
    frontier_round(src, src + 1, msk, fr, fr, 3)
    with pytest.raises(TypeError, match="frontier must be torch.bool"):
        frontier_round(src, src + 1, msk, fr.int(), fr, 3)
    with pytest.raises(ValueError, match="differ in length"):
        frontier_round(src, src + 1, msk, fr, fr[:2], 3)
    with pytest.raises(ValueError, match="1-D and non-empty"):
        frontier_round(src, src + 1, msk, fr[:0], fr[:0], 3)
    with pytest.raises(ValueError, match="segment-id space"):
        frontier_round(src, src + 1, msk, fr, fr, (1 << 31) - 10)


def test_frontier_round_byte_model():
    """With every slot live a round moves the JAX package's fused byte
    model (9 B per slot) plus frontier and visited read (2n B) and the two
    results written (8n B); a masked slot costs only its mask byte."""
    for e, n in ((1, 1), (1000, 64), (1 << 24, 1 << 17)):
        assert frontier_round_bytes(e, n, e) == j_frontier_round_bytes(
            e, fused=True) + 10 * n
        assert frontier_round_bytes(e, n, 0) == e + 10 * n


# ------------------------------------------------------------- embedding bag
MODES = ("sum", "mean", "max")


def _bag_case(table, idx, mask, mode, pallas=True):
    """The port's plain version and op against the JAX oracle and, where
    ``pallas``, the Pallas kernel in interpret mode; tolerance 1e-5."""
    jargs = (jnp.asarray(table), jnp.asarray(idx),
             None if mask is None else jnp.asarray(mask))
    want = np.asarray(j_bag_ref(*jargs, mode=mode))
    if pallas:
        got = np.asarray(embedding_bag_pallas(*jargs, mode=mode,
                                              interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    targs = (_t(table), _t(idx), None if mask is None else _t(mask))
    for fn in (embedding_bag_ref, embedding_bag):
        got = fn(*targs, mode=mode)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    return want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,l,v,d", [(13, 7, 1000, 32), (8, 1, 64, 16),
                                     (3, 50, 4096, 64)])
def test_embedding_bag_matches_jax(mode, b, l, v, d):
    """tests/test_kernels.py's cases (same seeds)."""
    rng = np.random.default_rng(b * l)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) > 0.3
    _bag_case(table, idx, mask, mode)


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_one_bag_of_the_retrieval_step(mode):
    """SASRec's retrieval shape: one right-aligned history of 50 with its
    padding masked, D 50, the shape the one-bag branch takes on the card."""
    rng = np.random.default_rng(50)
    table = rng.normal(size=(4096, 50)).astype(np.float32)
    idx = np.zeros((1, 50), np.int32)
    idx[0, 16:] = rng.integers(1, 4096, 34)
    _bag_case(table, idx, idx != 0, mode)


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_empty_bag_and_no_mask(mode):
    table = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    idx = np.array([[3, 1, 0], [2, 2, 9]], np.int32)
    mask = np.array([[True, True, False], [False, False, False]])
    out = _bag_case(table, idx, mask, mode)
    assert (out[1] == 0).all()  # an empty bag pools to zero
    _bag_case(table, idx, None, mode)  # no mask: every entry counts


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_wraps_negative_ids(mode):
    """An id in [-V, -1] reads row V + id, as ``jnp.take`` does; the Pallas
    kernel agrees."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    idx = rng.integers(-64, 64, (9, 6)).astype(np.int32)
    mask = rng.random((9, 6)) > 0.3
    out = _bag_case(table, idx, mask, mode)
    wrapped = np.where(idx < 0, idx + 64, idx).astype(np.int32)
    assert (idx < 0).any() and np.isfinite(out).all()
    assert np.array_equal(out, _bag_case(table, wrapped, mask, mode,
                                         pallas=False))


def test_embedding_bag_out_of_range_ids_follow_the_oracle():
    """An id outside [-V, V) reads a NaN row (``jnp.take``'s fill mode). The
    oracle multiplies by the mask after the gather, so in sum and mean such
    an id gives a NaN bag even where it is masked; max skips it where
    masked. The Pallas kernel clamps instead (ROADMAP §C, noted in the
    reference): the port follows the oracle and is compared with it only."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[-1, 5, 1], [7, 0, 2], [-5, 1, 1]], np.int32)
    mask = np.array([[True, False, True], [True, True, True],
                     [False, True, False]])
    want = {mode: _bag_case(table, idx, mask, mode, pallas=False)
            for mode in MODES}
    assert np.isnan(want["sum"][0]).all() and np.isnan(want["mean"][0]).all()
    assert want["max"][0].tolist() == [9.0, 10.0, 11.0]
    assert np.isnan(want["max"][1]).all()  # valid out-of-range id
    assert want["max"][2].tolist() == [3.0, 4.0, 5.0]
    rng = np.random.default_rng(9)
    idx = rng.integers(-200, 200, (20, 8)).astype(np.int32)
    table = rng.normal(size=(100, 8)).astype(np.float32)
    for mode in MODES:
        _bag_case(table, idx, rng.random((20, 8)) > 0.4, mode, pallas=False)


def test_embedding_bag_max_propagates_nan_rows():
    table = np.ones((6, 4), np.float32)
    table[2, 1] = np.nan
    idx = np.array([[0, 2, 1], [2, 0, 1]], np.int32)
    mask = np.array([[True, True, True], [False, True, True]])
    out = _bag_case(table, idx, mask, "max", pallas=False)
    assert np.isnan(out[0, 1]) and np.isfinite(out[1]).all()


def test_embedding_bag_validates_and_counts_no_cpu_launch():
    reset_launch_counts()
    table = torch.ones((5, 3))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, idx, mode="min")
    with pytest.raises(TypeError):
        embedding_bag(table, idx.long())
    with pytest.raises(TypeError):
        embedding_bag(table, idx, torch.ones((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(torch.ones((3, 5)).T, idx)
    with pytest.raises(ValueError, match="2-D"):
        embedding_bag(torch.ones(5), idx)
    assert embedding_bag(table, idx, mode="mean").tolist() == [[1.0] * 3] * 2
    assert launch_counts()["embedding_bag"] == 0


def test_embedding_bag_byte_model():
    """Rows gathered (B·L·D·4), the indices and mask bytes (B·L·5) and the
    output (B·D·4): the retrieval shape and the train-batch shape."""
    assert embedding_bag_bytes(1, 50, 50) == 50 * 50 * 4 + 250 + 200
    big = embedding_bag_bytes(65_536, 50, 50)
    assert big == 65_536 * (50 * 50 * 4 + 50 * 5 + 50 * 4)
    assert 6.8e8 < big < 6.9e8  # ≈ 685 MB


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_bytes_read_counts_distinct_sectors(mode):
    """The bound's byte count: every 32-byte sector of the distinct rows
    the mode reads, once (brute force over byte addresses), plus indices,
    mask and output. Negative ids wrap, out-of-range ids read no row, and
    ``max`` reads no masked row."""
    rng = np.random.default_rng(11)
    table = torch.tensor(rng.normal(size=(40, 50)).astype(np.float32))
    idx = rng.integers(-60, 60, (6, 9)).astype(np.int32)
    mask = rng.random((6, 9)) > 0.3
    read = {int(i) % 40 for i, m in zip(idx.ravel(), mask.ravel())
            if -40 <= i < 40 and (m or mode != "max")}
    base = table.data_ptr()

    def sectors(rows):
        return len({(base + r * 200 + byte) // 32
                    for r in rows for byte in range(200)})

    got = embedding_bag_bytes_read(table, torch.from_numpy(idx),
                                   torch.from_numpy(mask), mode)
    assert got == 32 * sectors(read) + idx.size * 5 + 6 * 50 * 4
    same = torch.full((4, 8), 3, dtype=torch.int32)  # one row, 32 lookups
    got = embedding_bag_bytes_read(table, same, mode=mode)
    assert got == 32 * sectors({3}) + 32 * 4 + 4 * 50 * 4
    assert got < embedding_bag_bytes(4, 8, 50)
