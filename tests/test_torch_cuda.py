"""The Hopper kernels on the card: each against its plain version (the
connectivity kernels bit for bit, since their outputs are integers;
embedding_bag within 1e-5 in float32; flash_attention within 2e-5 in
float32 and 3e-2 in bf16, the plain version's products in full float32,
TF32 off, and both its kernels under the gate of ``ops.ATTN_GATES`` too),
and the port's pipelines and models, the language model's serving and
training paths and the mixture-of-experts layer among them, on the card
against the same on the CPU. These tests need an NVIDIA card; the
``cuda`` fixture skips them where there is none. On the card:

    python -m pytest -m gpu tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import analyze, find_bridges
from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core.api import masked_arrays, pad_graph
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.core.certs import certificate_builder
from repro_torch.core.merge import (
    build_distributed_analysis_fn,
    certify_shards,
    simulate_merge_host,
)
from repro_torch.core.partition import partition_edges
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import (
    RING_SLOT_IDS,
    RING_SLOTS,
    STAGED_MIN_IDS,
    EdgeList,
    admission_capacity,
    concat_edges,
)
from repro_torch.kernels import cuda_lib, launch_counts, reset_launch_counts
from repro_torch.kernels.boruvka_round import boruvka_round, frontier_round
from repro_torch.kernels.boruvka_round.kernel import (
    boruvka_round_without_table,
    previous_boruvka_round,
    previous_frontier_round,
)
from repro_torch.kernels.boruvka_round.ref import (
    boruvka_round_ref,
    frontier_round_ref,
)
from repro_torch.configs import sasrec
from repro_torch.data.pipeline import recsys_batches
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.kernel import (
    BLOCK_ITEMS_MAX,
    block_embedding_bag,
    previous_embedding_bag,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention import (
    attention_gate,
    flash_attention,
)
from repro_torch.kernels.flash_attention.kernel import (
    KERNEL_OF,
    float32_core_kernel,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_min import segment_min
from repro_torch.kernels.segment_min.kernel import (
    filled_segment_min,
    previous_segment_min,
)
from repro_torch.kernels.segment_min.ref import segment_min_ref
from repro_torch.models import recsys as rec
from repro_torch.checkpoint import reshard_checkpoint
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import Parallelism
from repro_torch.optim import (
    adamw_init,
    compress_int8,
    decompress_int8,
)
from repro_torch.optim.compression import compressed_psum_tree
from repro_torch.optim.tree import tree_leaves
from repro_torch.training.steps import make_recsys_steps
from torch_gnn_cases import GNN_CHECK_CASES, GNN_CHECK_TOL, gnn_batch

pytestmark = pytest.mark.gpu

INF32 = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    """The card, decided here and not at import (xdist workers must all
    collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    cuda_lib.library()
    return torch.device("cuda")


def _edge_buffer(e, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst = np.where(rng.random(e) < 0.1, src, dst)
    mask = rng.random(e) >= 0.2
    labels = rng.integers(0, n, n).astype(np.int32)
    return [torch.as_tensor(x) for x in (src, dst, mask, labels)]


@pytest.mark.parametrize("e,n", [(7, 5), (1500, 513), (1 << 16, 4096),
                                 (1 << 20, 1 << 17)])
def test_boruvka_round_kernel_equals_plain(cuda, e, n):
    cpu = _edge_buffer(e, n, seed=e + n)
    gpu = [t.to(cuda) for t in cpu]
    for labels in (torch.arange(n, dtype=torch.int32), cpu[3]):
        args = cpu[:3] + [labels]
        want = boruvka_round_ref(*args, n)
        got = boruvka_round(*[t.to(cuda) for t in args], n)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, boruvka_round_ref(*gpu[:3], labels.to(cuda), n))


@pytest.mark.parametrize("e,n", [(7, 3), (4096, 1024), (524_284, 131_072)])
def test_segment_min_kernel_equals_plain(cuda, e, n):
    rng = np.random.default_rng(e)
    keys = rng.integers(-50, 1 << 20, e).astype(np.int32)
    keys[::5] = INF32
    ids = rng.integers(-10, n + 10, e).astype(np.int32)
    keys, ids = torch.as_tensor(keys), torch.as_tensor(ids)
    want = segment_min_ref(keys, ids, n)
    got = segment_min(keys.to(cuda), ids.to(cuda), n)
    assert torch.equal(got.cpu(), want)


def test_launches_counted_on_the_card_only(cuda):
    keys = torch.tensor([3, 1], dtype=torch.int32)
    ids = torch.tensor([0, 0], dtype=torch.int32)
    reset_launch_counts()
    segment_min(keys, ids, 2)
    assert launch_counts()["segment_min"] == 0
    segment_min(keys.to(cuda), ids.to(cuda), 2)
    assert launch_counts()["segment_min"] == 1


@pytest.mark.parametrize("final", ["host", "device"])
def test_pipeline_on_card_equals_cpu(cuda, final):
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    cpu_el = pad_graph(s, d, 3000, device="cpu")
    gpu_el = pad_graph(s, d, 3000, device=cuda)
    fn = make_analysis_fn(cpu_el.n_nodes, final=final)
    for a, b in zip(fn(cpu_el.src, cpu_el.dst, cpu_el.mask),
                    fn(gpu_el.src, gpu_el.dst, gpu_el.mask)):
        assert torch.equal(a, b.cpu())
    for sc in gen.failure_scenarios():
        got = find_bridges(sc["src"], sc["dst"], sc["n"], final=final)
        assert got == sc["bridges"] == bridges_dfs(sc["src"], sc["dst"], sc["n"])
    assert find_bridges(s, d, 3000, final=final) == planted


def _out_of_range(t, n, seed):
    """A fifth of the entries moved to ``[-3n, 3n)``: negative ids wrap in
    gathers, ids past the ends clamp, and either is dropped as a segment."""
    rng = np.random.default_rng(seed)
    a = t.numpy().copy()
    hit = rng.random(a.shape[0]) < 0.2
    a[hit] = rng.integers(-3 * n, 3 * n, int(hit.sum()))
    return torch.as_tensor(a)


def test_boruvka_round_kernel_wraps_negative_ids(cuda):
    src, dst, mask, labels = _edge_buffer(1500, 513, seed=3)
    src, dst = _out_of_range(src, 513, 4), _out_of_range(dst, 513, 5)
    want = boruvka_round_ref(src, dst, mask, labels, 513)
    got = boruvka_round(*[t.to(cuda) for t in (src, dst, mask, labels)], 513)
    assert torch.equal(got.cpu(), want)


def _sorted_buffer(e, n, seed):
    """Slots sorted by their smaller endpoint, as the bridge pipeline's
    buffer is (either endpoint may be ``src``), with self-loops and masked
    slots."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, e).astype(np.int32)
    v = rng.integers(0, n, e).astype(np.int32)
    v = np.where(rng.random(e) < 0.05, u, v)
    order = np.lexsort((np.maximum(u, v), np.minimum(u, v)))
    mask = rng.random(e) >= 0.1
    return [torch.as_tensor(x) for x in (u[order], v[order], mask)]


def _few_components(n, k, seed):
    """Labels of ``k`` components, each named by one of its vertices."""
    rng = np.random.default_rng(seed)
    roots = rng.choice(n, k, replace=False).astype(np.int32)
    return torch.as_tensor(roots[rng.integers(0, k, n)])


def _at_offset(t, offset, device):
    """A contiguous copy of ``t`` on ``device`` that starts ``offset``
    elements into a buffer of its own."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
    view = buf[offset:]
    view.copy_(t)
    assert view.is_contiguous()
    return view


def _rounds_equal(cuda, src, dst, mask, labels, n, offsets=(0, 0, 0)):
    """The Borůvka op, the kernel without its table and the first kernel on
    ``src``/``dst``/``mask`` at the given offsets, each bit for bit against
    the plain version on the CPU."""
    want = boruvka_round_ref(src, dst, mask, labels, n)
    args = [_at_offset(t, k, cuda) for t, k in zip((src, dst, mask), offsets)]
    args += [labels.to(cuda), n]
    reset_launch_counts()
    got = boruvka_round(*args)
    assert launch_counts()["boruvka_round"] == (1 if src.numel() else 0)
    assert torch.equal(got.cpu(), want)
    for fn in (boruvka_round_without_table, previous_boruvka_round):
        assert torch.equal(fn(*args).cpu(), want), fn.__name__
    return want


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (1, 2, 3)])
@pytest.mark.parametrize("e", [1, 3, 33, 1027, (1 << 20) + 5])
def test_boruvka_round_warp_kernel_on_sorted_slots(cuda, e, offsets):
    """The redesigned round on slots sorted by their smaller endpoint, with
    identity labels and with 1, 2 and 3 components, the buffers as views at
    offsets that move them off 16-byte alignment (the same offset on all
    three keeps one scalar head; different offsets leave no 16-byte part)."""
    n = max(8, min(e, 1 << 16))
    src, dst, mask = _sorted_buffer(e, n, seed=e)
    label_sets = [torch.arange(n, dtype=torch.int32)]
    label_sets += [_few_components(n, k, seed=e + k) for k in (1, 2, 3)]
    for labels in label_sets:
        want = _rounds_equal(cuda, src, dst, mask, labels, n, offsets)
        if torch.unique(labels).numel() == 1:
            assert (want == INF32).all()


def test_boruvka_round_warp_kernel_odd_ids_in_one_warp(cuda):
    """Negative endpoints (wrapped), endpoints past n (clamped), negative
    labels and labels past num_segments (dropped) inside the lanes of one
    warp step, all sharing one smaller endpoint, at every head offset."""
    n, e = 64, 4 * 128 + 7
    rng = np.random.default_rng(21)
    src = np.full(e, 5, np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[::7] = rng.integers(-2 * n, -1, dst[::7].shape[0])
    dst[3::11] = rng.integers(n, 3 * n, dst[3::11].shape[0])
    src[::5] = 5 - n  # wraps to 5
    mask = rng.random(e) >= 0.1
    labels = rng.integers(0, 3, n).astype(np.int32) * 7
    labels[::9] = -4
    labels[4::9] = 40
    t = torch.as_tensor
    for num_segments in (n, 30):
        for k in range(4):
            _rounds_equal(cuda, t(src), t(dst), t(mask), t(labels),
                          num_segments, (k, k, k))


def _frontier_equal(cuda, src, dst, mask, frontier, visited, n):
    want = frontier_round_ref(src, dst, mask, frontier, visited, n)
    got = frontier_round(*[t.to(cuda) for t in (src, dst, mask, frontier,
                                                visited)], n)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a.cpu(), b)
    return want


@pytest.mark.parametrize("e,n", [(7, 5), (1500, 513), (1 << 16, 4096),
                                 (1 << 20, 1 << 17)])
def test_frontier_round_kernel_equals_plain(cuda, e, n):
    src, dst, mask, _ = _edge_buffer(e, n, seed=e * 3 + n)
    rng = np.random.default_rng(e + n)
    for p in (0.001, 0.05, 0.4):  # a thin, a middle and a wide frontier
        frontier = torch.as_tensor(rng.random(n) < p)
        visited = torch.as_tensor(rng.random(n) < 0.5) | frontier
        _frontier_equal(cuda, src, dst, mask, frontier, visited, n)


def test_frontier_round_kernel_edge_cases(cuda):
    n = 513
    src, dst, mask, _ = _edge_buffer(4096, n, seed=11)
    rng = np.random.default_rng(12)
    frontier = torch.as_tensor(rng.random(n) < 0.3)
    visited = torch.as_tensor(rng.random(n) < 0.5) | frontier
    oor = (_out_of_range(src, n, 13), _out_of_range(dst, n, 14))
    _frontier_equal(cuda, *oor, mask, frontier, visited, n)
    none = torch.zeros(n, dtype=torch.bool)
    p, e = _frontier_equal(cuda, src, dst, mask, none, visited, n)
    assert (p == INF32).all() and (e == INF32).all()
    p, e = _frontier_equal(cuda, src, dst, torch.zeros_like(mask), frontier,
                           visited, n)
    assert (p == INF32).all() and (e == INF32).all()
    # parallel copies of {0, 1} (slot 1 masked), a self-loop at frontier
    # vertex 3, vertex 5 isolated: the tie on the parent goes to slot 2
    t = torch.tensor
    p, e = _frontier_equal(
        cuda, t([2, 0, 0, 1, 3, 3], dtype=torch.int32),
        t([1, 1, 1, 0, 3, 4], dtype=torch.int32),
        t([True, False, True, True, True, True]),
        t([True, False, True, True, False, False, False]),
        t([True, False, True, True, False, False, False]), 7)
    assert p.tolist() == [INF32, 0, INF32, INF32, 3, INF32, INF32]
    assert e.tolist() == [INF32, 2, INF32, INF32, 5, INF32, INF32]


def _frontier_rounds_equal(cuda, src, dst, mask, frontier, visited, n,
                          offsets=(0, 0, 0)):
    """The frontier op (the redesigned kernel) and the first kernel on
    ``src``/``dst``/``mask`` at the given offsets, each bit for bit against
    the plain version on the CPU; the op counts one launch."""
    want = frontier_round_ref(src, dst, mask, frontier, visited, n)
    args = [_at_offset(t, k, cuda) for t, k in zip((src, dst, mask), offsets)]
    args += [frontier.to(cuda), visited.to(cuda), n]
    reset_launch_counts()
    got = frontier_round(*args)
    assert launch_counts()["frontier_round"] == (1 if src.numel() else 0)
    for fn, pair in (("op", got), ("previous", previous_frontier_round(*args))):
        for a, b in zip(pair, want):
            assert a.dtype == torch.int32, fn
            assert torch.equal(a.cpu(), b), fn
    return want


def _frontier_sets(n, seed, p=0.2):
    rng = np.random.default_rng(seed)
    frontier = torch.as_tensor(rng.random(n) < p)
    return frontier, torch.as_tensor(rng.random(n) < 0.3) | frontier


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (1, 2, 3)])
@pytest.mark.parametrize("e", [1, 3, 33, 1027, (1 << 20) + 5])
def test_frontier_round_warp_kernel_on_sorted_and_shuffled_slots(cuda, e,
                                                                 offsets):
    """The redesigned round on slots sorted by their smaller endpoint and on
    the same slots shuffled, with a thin, a middle and a wide frontier, the
    buffers as views at offsets that move them off 16-byte alignment."""
    n = max(8, min(e, 1 << 16))
    src, dst, mask = _sorted_buffer(e, n, seed=e + 1)
    perm = torch.as_tensor(np.random.default_rng(e).permutation(e))
    for order in (torch.arange(e), perm):
        for p in (0.01, 0.2, 0.6):
            frontier, visited = _frontier_sets(n, seed=e + int(100 * p), p=p)
            _frontier_rounds_equal(cuda, src[order], dst[order], mask[order],
                                   frontier, visited, n, offsets)


def test_frontier_round_warp_kernel_masked_groups(cuda):
    """Whole groups of four masked slots (whose endpoints the kernel never
    reads) beside partly masked groups, at every head offset."""
    e, n = 4 * 300 + 3, 97
    src, dst, mask, _ = _edge_buffer(e, n, seed=31)
    groups = np.random.default_rng(32).random(e // 4 + 1) < 0.5
    mask = mask & torch.as_tensor(~np.repeat(groups, 4)[:e])
    frontier, visited = _frontier_sets(n, seed=33, p=0.4)
    for k in range(4):
        _frontier_rounds_equal(cuda, src, dst, mask, frontier, visited, n,
                               (k, k, k))


def test_frontier_round_warp_kernel_odd_ids_in_one_warp(cuda):
    """Negative endpoints (wrapped in gathers, dropped as targets),
    endpoints past n (clamped, dropped) and targets past num_segments
    (dropped) inside the lanes of one warp step, at every head offset."""
    n, e = 64, 4 * 128 + 7
    rng = np.random.default_rng(41)
    src = np.full(e, 5, np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[::7] = rng.integers(-2 * n, -1, dst[::7].shape[0])
    dst[3::11] = rng.integers(n, 3 * n, dst[3::11].shape[0])
    src[::5] = 5 - n  # wraps to 5
    src[2::13] = rng.integers(-2 * n, 3 * n, src[2::13].shape[0])
    mask = rng.random(e) >= 0.1
    t = torch.as_tensor
    for fr5 in (True, False):  # vertex 5 in the frontier, or a target
        frontier, visited = _frontier_sets(n, seed=42, p=0.3)
        frontier[5], visited[5] = fr5, fr5
        for num_segments in (n, 30):
            for k in range(4):
                _frontier_rounds_equal(cuda, t(src), t(dst), t(mask),
                                       frontier, visited, num_segments,
                                       (k, k, k))


def test_frontier_round_warp_kernel_tie_goes_to_the_lower_slot(cuda):
    """Parallel edges to one unvisited vertex: the higher parent sits in
    the earlier lanes, the lower parent in later lanes of the same and of
    later warp steps; the minimum parent wins, then its lowest slot."""
    n, e = 16, 3 * 128 + 5
    src = np.full(e, 9, np.int32)  # parent 9: lanes before the lower parent
    dst = np.full(e, 7, np.int32)  # vertex 7, unvisited
    for slot in (6, 23, 130, 131, 260):  # lanes 1, 5; step 1; step 2
        src[slot] = 2
    src[e - 2:] = 3
    dst[::17] = 11  # other targets mixed in
    mask = np.ones(e, bool)
    mask[6] = False  # the lowest copy from parent 2 is masked
    frontier = torch.zeros(n, dtype=torch.bool)
    frontier[[2, 3, 9]] = True
    visited = frontier.clone()
    t = torch.as_tensor
    for k in range(4):
        p, s = _frontier_rounds_equal(cuda, t(src), t(dst), t(mask),
                                      frontier, visited, n, (k, k, k))
        assert p[7] == 2 and s[7] == 23
        assert p[11] == 9 and s[11] == 0


def _segment_min_all_equal(cuda, keys, ids, n, offsets=(0, 0)):
    """The segment-min op (the cooperative kernel), the same body after a
    separate fill and the first kernel, with ``keys``/``ids`` at the given
    offsets, each bit for bit against the plain version on the CPU; the op
    counts one launch."""
    want = segment_min_ref(keys, ids, n)
    args = [_at_offset(t, k, cuda) for t, k in zip((keys, ids), offsets)]
    reset_launch_counts()
    got = segment_min(*args, n)
    assert launch_counts()["segment_min"] == (1 if keys.numel() else 0)
    assert torch.equal(got.cpu(), want)
    for fn in (filled_segment_min, previous_segment_min):
        assert torch.equal(fn(*args, n).cpu(), want), fn.__name__
    return want


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 2)])
@pytest.mark.parametrize("e", [1, 3, 33, 1027, (1 << 20) + 5])
def test_segment_min_vec_kernel_sizes_and_offsets(cuda, e, offsets):
    """INF32 keys and ids below 0, at n and past it, at every size, the
    buffers as views that move them off 16-byte alignment (the same offset
    keeps one scalar head; different offsets leave no 16-byte part)."""
    n = max(4, min(e // 3, 1 << 17))
    rng = np.random.default_rng(e + 7)
    keys = rng.integers(-50, 1 << 20, e).astype(np.int32)
    keys[rng.random(e) < 0.1] = INF32
    ids = rng.integers(-10, n + 10, e).astype(np.int32)
    ids[:4] = [np.iinfo(np.int32).min, INF32, n, -1][:e]
    _segment_min_all_equal(cuda, torch.as_tensor(keys), torch.as_tensor(ids),
                           n, offsets)


def test_segment_min_vec_kernel_edge_cases(cuda):
    """Every id in one segment, one segment, only INF32 keys, only
    out-of-range ids, and more segments than keys."""
    rng = np.random.default_rng(51)
    e = 4096 + 3
    keys = torch.as_tensor(rng.integers(0, 1 << 30, e).astype(np.int32))
    same = torch.full((e,), 5, dtype=torch.int32)
    for k in range(4):
        _segment_min_all_equal(cuda, keys, same, 9, (k, k))
        _segment_min_all_equal(cuda, keys, same - 5, 1, (k, k))
    want = _segment_min_all_equal(cuda, torch.full((e,), INF32,
                                                   dtype=torch.int32),
                                  same, 9)
    assert (want == INF32).all()
    want = _segment_min_all_equal(cuda, keys, same + 100, 9)
    assert (want == INF32).all()
    _segment_min_all_equal(cuda, keys[:5], same[:5] - 3, 1 << 20)


#: every (kind, certificate) the analysis registry allows
COMBOS = [("bridges", "2ec"), ("2ecc", "2ec"), ("bridge_tree", "2ec"),
          ("cuts", "sfs"), ("cuts", "hybrid"), ("bcc", "sfs"),
          ("bcc", "hybrid")]


def _same(kind, a, b):
    return np.array_equal(a, b) if kind == "2ecc" else a == b


@pytest.mark.parametrize("final", ["host", "device"])
def test_analyze_on_card_equals_cpu(cuda, final):
    s, d, _ = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    cpu_el = pad_graph(s, d, 3000, device="cpu")
    gpu_el = pad_graph(s, d, 3000, device=cuda)
    worlds = [(sc["src"], sc["dst"], sc["n"]) for sc in gen.failure_scenarios()]
    worlds.append((s, d, 3000))
    for kind, cert in COMBOS:
        fn = make_analysis_fn(cpu_el.n_nodes, kind, final, certificate=cert)
        want = fn(cpu_el.src, cpu_el.dst, cpu_el.mask)
        got = fn(gpu_el.src, gpu_el.dst, gpu_el.mask)
        if isinstance(want, torch.Tensor):
            want, got = (want,), (got,)
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu()), (kind, cert)
        for src, dst, n in worlds:
            on_card = analyze(src, dst, n, kind=kind, final=final,
                              certificate=cert)
            assert _same(kind, on_card, analyze(
                src, dst, n, kind=kind, final=final, certificate=cert,
                device="cpu")), (kind, cert, n)


@pytest.mark.parametrize("cert", ["sfs", "hybrid"])
def test_cuts_host_final_launches_frontier_round(cuda, cert):
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    reset_launch_counts()
    got = analyze(s, d, 3000, kind="cuts", final="host", certificate=cert)
    counts = launch_counts()
    assert got == {v for pair in planted for v in pair}
    assert counts["frontier_round"] > 0 and counts["boruvka_round"] > 0


# ------------------------------------------------------------- embedding bag
def _bag_inputs(b, l, v, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32))
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) > 0.3
    mask[0] = False  # an empty bag
    return table.to(dtype), torch.as_tensor(idx), torch.as_tensor(mask)


def _bag_equal(cuda, table, idx, mask, mode, tol):
    want = embedding_bag_ref(table.to(cuda), idx.to(cuda),
                             None if mask is None else mask.to(cuda), mode)
    got = embedding_bag(table.to(cuda), idx.to(cuda),
                        None if mask is None else mask.to(cuda), mode)
    assert got.dtype == table.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)
    return got.float().cpu().numpy()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("b,l,v,d", [(1, 50, 4096, 50), (13, 7, 1000, 32),
                                     (1000, 33, 5000, 130), (64, 1, 64, 16)])
def test_embedding_bag_kernel_equals_plain(cuda, mode, b, l, v, d):
    table, idx, mask = _bag_inputs(b, l, v, d, seed=b + l + d)
    _bag_equal(cuda, table, idx, mask, mode, 1e-5)
    _bag_equal(cuda, table, idx, None, mode, 1e-5)
    # bf16 table: float32 sums in the kernel, one rounding at the store
    _bag_equal(cuda, table.to(torch.bfloat16), idx, mask, mode, 3e-2)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_kernel_ids_and_nan(cuda, mode):
    """Negative ids wrap, ids outside [-V, V) read NaN rows (a NaN bag in
    sum and mean even where masked), max propagates a NaN row."""
    table, idx, mask = _bag_inputs(40, 9, 100, 24, seed=3)
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(-300, 300, (40, 9)).astype(np.int32))
    got = _bag_equal(cuda, table, idx, mask, mode, 1e-5)
    assert np.isnan(got).any() and (got[0] == 0).all() == (mode == "max")
    table[7, 3] = float("nan")
    idx = torch.as_tensor(rng.integers(-100, 100, (40, 9)).astype(np.int32))
    idx[1, 0] = 7
    mask[1, 0] = True
    got = _bag_equal(cuda, table, idx, mask, mode, 1e-5)
    assert np.isnan(got[1, 3]) and np.isfinite(got[1, :3]).all()


#: bag counts around the threshold between the two embedding_bag kernels
#: (at D <= 64 a bag is one work item)
BAGS = {"one": 1, "below": BLOCK_ITEMS_MAX - 1, "at": BLOCK_ITEMS_MAX,
        "above": BLOCK_ITEMS_MAX + 1}


def _same_floats(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("l", [1, 9, 50, 300])
@pytest.mark.parametrize("bags", list(BAGS))
def test_embedding_bag_either_kernel_equals_plain(cuda, bags, l, mode):
    """The op on either side of BLOCK_ITEMS_MAX: bit for bit the block
    kernel up to it and the first kernel above it, both within 1e-5 of the
    plain version (3e-2 with a bf16 table), with an all-masked bag, a NaN
    row, wrapped negative ids and ids outside [-V, V). A float32 sum's
    rounding grows with the square root of its length, so ``sum`` over
    bags longer than the 50 of the other tests takes 1e-5 * sqrt(L / 50)."""
    b, v, d = BAGS[bags], 3000, 50
    f32_tol = 1e-5 * (max(1.0, l / 50) ** 0.5 if mode == "sum" else 1.0)
    table, idx, mask = _bag_inputs(b, l, v, d, seed=b + l)
    mask[0] = True
    table[7, 3] = float("nan")
    idx[0, 0] = 7  # a NaN row, valid
    if b > 1:
        mask[-1] = False  # an all-masked bag
        idx[1, -1] = v + 7  # outside [-V, V): a NaN row
        idx[b // 2, 0] = -v  # wraps to row 0
    chosen = block_embedding_bag if b <= BLOCK_ITEMS_MAX else \
        previous_embedding_bag
    for tab, tol in ((table, f32_tol), (table.to(torch.bfloat16), 3e-2)):
        args = [x.to(cuda) for x in (tab, idx, mask)]
        got = _bag_equal(cuda, tab, idx, mask, mode, tol)
        _same_floats(embedding_bag(*args, mode),
                     chosen(*args, mode))
        for fn in (block_embedding_bag, previous_embedding_bag):
            np.testing.assert_allclose(fn(*args, mode).float().cpu().numpy(),
                                       got, atol=tol, rtol=tol)
    if b == 1:  # the one bag all masked
        _bag_equal(cuda, table, idx, torch.zeros_like(mask), mode, 1e-5)


# ------------------------------------------------------------ flash attention
ATTN_CASES = [
    # b, sq, skv, hq, hkv, d
    (2, 64, 64, 4, 2, 32),     # GQA group 2
    (1, 128, 128, 8, 1, 64),   # MQA
    (3, 1, 1000, 4, 2, 128),   # decode: one query vs cache
    (2, 17, 63, 2, 2, 16),     # ragged, non-block-aligned
    (1, 300, 300, 2, 2, 128),  # d_head = 128, ragged tiles
    (1, 70, 20, 2, 1, 64),     # Sq > Skv: causal rows 0-49 see no key
]
#: the tensor-core kernels' edges: (b, sq, skv, hq, hkv, d)
MMA_CASES = [
    (2, 77, 131, 4, 2, 64),      # Sq, Skv not multiples of 16 or 64
    (1, 45, 45, 2, 1, 128),      # one ragged tile each way
    (2, 100, 150, 4, 4, 16),     # D 16
    (1, 129, 200, 4, 2, 32),     # D 32, a one-row last query tile
    (1, 150, 37, 4, 2, 64),      # Sq > Skv: causal rows 0-112 see no key
    (4, 1, 777, 8, 4, 128),      # decode, Hq / Hkv = 2
    (1, 2048, 2048, 4, 2, 128),  # a long causal prefill
]


def _attn_inputs(case, dtype, device, seed):
    b, sq, skv, hq, hkv, d = case
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=shape).astype(np.float32))
                 .to(device, dtype)
                 for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, d)))


def _attn_launched(q, k, v, causal):
    """One op call; asserts that it launched the kernel of q's dtype
    (bf16: flash_attention_mma, float32: flash_attention_tf32x3) once and
    no other kernel."""
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    ran = {name: n for name, n in launch_counts().items() if n}
    assert ran == {KERNEL_OF[q.dtype]: 1}
    return got


def _attn_gate(got, want, sq, skv, causal):
    """Rows that see no key are NaN in both; the others pass the gate."""
    blind = sq - skv if causal and sq > skv else 0
    assert torch.isnan(got[:, :blind]).all() and torch.isnan(want[:, :blind]).all()
    verdict = attention_gate(got[:, blind:], want[:, blind:])
    assert verdict["pass"], verdict


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_equals_plain(cuda, case, causal, dtype, tol):
    assert not torch.backends.cuda.matmul.allow_tf32
    b, sq, skv, hq, hkv, d = case
    q, k, v = _attn_inputs(case, dtype, cuda, seed=sum(case))
    want = attention_ref(q, k, v, causal=causal)
    got = _attn_launched(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)
    if causal and sq > skv:
        assert torch.isnan(got[:, : sq - skv]).all()
    _attn_gate(got, want, sq, skv, causal)


@pytest.mark.parametrize("case", MMA_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mma_kernel_edges(cuda, case, causal):
    """The bf16 kernel at ragged lengths, every head size, NaN rows,
    decoding with a GQA group of 2 and a 2,048-long causal prefill, under
    the smoke's gate (ops.ATTN_GATES)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    b, sq, skv, hq, hkv, d = case
    q, k, v = _attn_inputs(case, torch.bfloat16, cuda, seed=sum(case) + 1)
    want = attention_ref(q, k, v, causal=causal)
    got = _attn_launched(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _attn_gate(got, want, sq, skv, causal)


@pytest.mark.parametrize("case", MMA_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tf32x3_kernel_edges(cuda, case, causal):
    """The float32 kernel on the same edges, under the float32 gate."""
    assert not torch.backends.cuda.matmul.allow_tf32
    b, sq, skv, hq, hkv, d = case
    q, k, v = _attn_inputs(case, torch.float32, cuda, seed=sum(case) + 2)
    want = attention_ref(q, k, v, causal=causal)
    got = _attn_launched(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _attn_gate(got, want, sq, skv, causal)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_f32_core_kernel_equals_plain(cuda, case, dtype):
    """The first, float32-core kernel, which no op reaches any more,
    through its entry: still the plain version under the gate (the
    yardstick that chip_smoke.py times); its launches are not counted."""
    b, sq, skv, hq, hkv, d = case
    q, k, v = _attn_inputs(case, dtype, cuda, seed=sum(case) + 3)
    reset_launch_counts()
    got = float32_core_kernel(q, k, v, True, d ** -0.5)
    assert not any(launch_counts().values())
    assert got.dtype == dtype and got.shape == q.shape
    _attn_gate(got, attention_ref(q, k, v, causal=True), sq, skv, True)


def test_flash_attention_refuses_no_keys(cuda):
    q = torch.zeros((1, 3, 2, 16), device=cuda)
    kv = torch.zeros((1, 0, 2, 16), device=cuda)
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="no keys"):
            flash_attention(q.to(dtype), kv.to(dtype), kv.to(dtype),
                            causal=False)
    assert not any(launch_counts().values())


def _unaligned_views_agree(cuda, dtype):
    """Contiguous inputs whose data is not 16-byte aligned (views into a
    buffer at an odd offset) give the same output."""
    case = (1, 40, 90, 4, 2, 32)
    q, k, v = _attn_inputs(case, dtype, cuda, seed=5)
    shifted = []
    for x in (q, k, v):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    want = _attn_launched(q, k, v, True)
    got = _attn_launched(*shifted, True)
    assert torch.equal(got, want)


def test_flash_attention_mma_kernel_unaligned_views(cuda):
    _unaligned_views_agree(cuda, torch.bfloat16)


def test_flash_attention_tf32x3_kernel_unaligned_views(cuda):
    _unaligned_views_agree(cuda, torch.float32)


def test_flash_attention_kernel_rejects_head_size(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="flash_attention_mma takes head"):
        flash_attention(*(q.bfloat16(),) * 3)
    with pytest.raises(TypeError):
        flash_attention(*(q[..., :32].half(),) * 3)


# ------------------------------------------------------------------ SASRec
def test_recsys_steps_on_card_equal_cpu(cuda):
    cfg = sasrec.SMOKE
    params = rec.init_sasrec(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    on_card = {key: val.to(cuda) for key, val in params.items()
               if key != "blocks"}
    on_card["blocks"] = [{key: val.to(cuda) for key, val in blk.items()}
                         for blk in params["blocks"]]
    seq = recsys_batches(cfg.n_items, 8, cfg.seq_len, seed=1)(0)["seq"]
    steps = make_recsys_steps(cfg)
    for got, want in ((steps["serve"](on_card, seq),
                       steps["serve"](params, seq)),
                      (steps["bulk"](on_card, seq)[0],
                       steps["bulk"](params, seq)[0])):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)
    cand = np.arange(1, 200, dtype=np.int32)
    reset_launch_counts()
    got = steps["retrieval"](on_card, seq[:1], seq[:1] != 0, cand)
    assert launch_counts()["embedding_bag"] == 1
    want = steps["retrieval"](params, seq[:1], seq[:1] != 0, cand)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def _params_on(params: dict, device) -> dict:
    out = {key: val.to(device) for key, val in params.items()
           if key != "blocks"}
    out["blocks"] = [{key: val.to(device) for key, val in blk.items()}
                     for blk in params["blocks"]]
    return out


def test_train_step_on_card_equals_cpu(cuda):
    """Three train steps at the smoke config (warmup 2, so the params
    move) on the card against the CPU: loss, grad_norm and lr within 1e-5
    relative; moments within 1e-5 of each leaf's largest magnitude, params
    and master besides within 1% of the summed lr (AdamW's normalised step
    on a near-cancelling gradient element; ``test_torch_training.py``);
    no kernel launched (the training path reaches none)."""
    cfg = sasrec.SMOKE
    cpu = rec.init_sasrec(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    card = _params_on(cpu, cuda)
    train = make_recsys_steps(cfg, warmup=2, total_steps=20)["train"]
    opt_cpu, opt_card = adamw_init(cpu), adamw_init(card)
    batches = recsys_batches(cfg.n_items, 8, cfg.seq_len, seed=2)
    lr_sum = 0.0
    reset_launch_counts()
    for step in range(3):
        card, opt_card, got = train(card, opt_card, batches(step))
        cpu, opt_cpu, want = train(cpu, opt_cpu, batches(step))
        for key in ("loss", "grad_norm", "lr"):
            assert got[key].device.type == "cuda"
            np.testing.assert_allclose(got[key].item(), want[key].item(),
                                       rtol=1e-5, err_msg=key)
        lr_sum += want["lr"].item()
    assert not any(launch_counts().values())
    assert opt_card["step"].dtype == torch.int32 and int(opt_card["step"]) == 3
    for key, atol in (("m", 0.0), ("v", 0.0), ("master", 0.01 * lr_sum)):
        for a, b in zip(tree_leaves(opt_card[key]), tree_leaves(opt_cpu[key])):
            assert a.device.type == "cuda"
            scale = float(b.abs().max())
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * scale + atol
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * scale + 0.01 * lr_sum


@pytest.fixture
def nccl_grid(cuda, tmp_path):
    """A one-rank NCCL group and a (1, 1) ``("data", "model")`` mesh built
    by the port's ``make_test_mesh``."""
    import datetime

    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_test_mesh(1, shape=(1, 1))
    finally:
        dist.destroy_process_group()


def test_recsys_mesh_on_one_rank_equals_meshless(nccl_grid):
    """SASRec's multi-card branches on a one-rank NCCL mesh, the weights
    placed by ``reshard_checkpoint``: serve, bulk and retrieval equal the
    meshless steps bit for bit (retrieval's mean is the kernel's sum over
    the same count, one IEEE division either way), the retrieval branch
    launches ``embedding_bag`` once; ``compressed_psum_tree`` on one rank
    is ``compress_int8`` then ``decompress_int8``."""
    cfg = sasrec.SMOKE
    par = Parallelism(mesh=nccl_grid, dp_axes=("data",), tp_axis="model")
    params = rec.init_sasrec(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    placed = reshard_checkpoint(params, nccl_grid, rec.param_specs(cfg, par))
    seq = recsys_batches(cfg.n_items, 8, cfg.seq_len, seed=1)(0)["seq"]
    mesh_steps, steps = make_recsys_steps(cfg, par), make_recsys_steps(cfg)
    assert torch.equal(mesh_steps["serve"](placed, seq),
                       steps["serve"](params, seq))
    for got, want in zip(mesh_steps["bulk"](placed, seq),
                         steps["bulk"](params, seq)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    cand = np.arange(1, 200, dtype=np.int32)
    reset_launch_counts()
    got = mesh_steps["retrieval"](placed, seq[:2], seq[:2] != 0, cand)
    assert launch_counts()["embedding_bag"] == 1
    assert torch.equal(got, steps["retrieval"](params, seq[:2], seq[:2] != 0,
                                               cand))
    grads = {"a": params["item_emb"][:100] * 10, "b": params["pos_emb"]}
    errs = {k: torch.full_like(v, 1e-4) for k, v in grads.items()}
    new_g, new_e = compressed_psum_tree(grads, errs)
    for key, g in grads.items():
        q, scale, err = compress_int8(g, errs[key])
        assert torch.equal(new_g[key], decompress_int8(q, scale))
        assert torch.equal(new_e[key], err)


# ------------------------------------------------- the merge across machines
def _stacked_shards(s, d, n, m, device, seed=0):
    """The partition over ``m`` machines, rows padded to their power-of-two
    bucket as the distributed entry point pads them."""
    psrc, pdst, pmask = partition_edges(s, d, n, m, seed=seed)
    cap = admission_capacity(psrc.shape[1], 16)
    pad = ((0, 0), (0, cap - psrc.shape[1]))
    return [torch.from_numpy(np.pad(a, pad)).to(device)
            for a in (psrc, pdst, pmask)]


@pytest.mark.parametrize("cert", ["2ec", "sfs", "hybrid"])
@pytest.mark.parametrize("schedule", ["paper", "xor", "hierarchical"])
def test_simulated_merge_on_card_equals_cpu(cuda, schedule, cert):
    """The host simulator with every certificate built on the card, machine
    by machine, against the same simulator on the CPU, buffer for buffer
    (n = 3,000, not a power of two; M = 8 on a 2 x 4 grid)."""
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    certify = certificate_builder(cert)
    merged = {}
    for dev in ("cpu", cuda):
        local = certify_shards(*_stacked_shards(s, d, 3000, 8, dev), 3000,
                               certify=certify)
        merged[dev] = simulate_merge_host(local, schedule, certify=certify,
                                          grid=(2, 4))
    for a, b in zip(merged["cpu"], merged[cuda]):
        for name in ("src", "dst", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name).cpu())
    c = merged[cuda][0]
    assert bridges_dfs(*masked_arrays((c.src, c.dst, c.mask)), 3000) == planted


def _path_buffers(cuda):
    """Buffers the distributed path hands the kernels, at n = 3,000: a row
    of stacked ``[8, cap]`` shards (a view at a nonzero offset), a phase's
    union of two certificates (2 * 2(n - 1) slots) and one certificate
    (2(n - 1) = 5,998 slots: not a multiple of four)."""
    s, d, _ = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    shards = _stacked_shards(s, d, 3000, 8, cuda)
    row = EdgeList(*(t[5] for t in shards), 3000)
    certs = certify_shards(*shards, 3000)
    return {"shard_row": row, "union": concat_edges(certs[0], certs[1]),
            "certificate": certs[2]}


@pytest.mark.parametrize("buffer", ["shard_row", "union", "certificate"])
def test_connectivity_kernels_on_the_distributed_path_buffers(cuda, buffer):
    el = _path_buffers(cuda)[buffer]
    n = el.n_nodes
    if buffer == "shard_row":
        assert el.src.storage_offset() > 0
    if buffer == "certificate":
        assert el.capacity % 4 == 2
    valid = el.mask & (el.src != el.dst)
    ident = torch.arange(n, dtype=torch.int32, device=cuda)
    labels = [ident, torch.as_tensor(np.random.default_rng(3).integers(
        0, n, n).astype(np.int32)).to(cuda)]
    for lab in labels:
        for m in (valid, el.mask):
            got = boruvka_round(el.src, el.dst, m, lab, n)
            assert torch.equal(got, boruvka_round_ref(el.src, el.dst, m, lab,
                                                      n))
    rng = np.random.default_rng(4)
    for p in (0.01, 0.3):
        frontier = torch.as_tensor(rng.random(n) < p).to(cuda)
        visited = frontier | torch.as_tensor(rng.random(n) < 0.3).to(cuda)
        args = (el.src, el.dst, valid, frontier, visited, n)
        for a, b in zip(frontier_round(*args), frontier_round_ref(*args)):
            assert torch.equal(a, b)
    slots = torch.arange(el.capacity, dtype=torch.int32, device=cuda)
    keys = torch.where(el.mask, slots, INF32)
    for ids in (el.src, el.dst):
        assert torch.equal(segment_min(keys, ids, n),
                           segment_min_ref(keys, ids, n))


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """A one-rank NCCL group (its own file store) and a one-dim mesh."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield DeviceMesh("cuda", torch.arange(1),
                         mesh_dim_names=("machines",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("final", ["host", "device"])
def test_one_rank_nccl_program_equals_simulator(nccl_world, final):
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    shards = _stacked_shards(s, d, 3000, 1, "cuda")
    fn = build_distributed_analysis_fn(nccl_world, ("machines",), 3000,
                                       final=final)
    got = fn(*(t[0] for t in shards))
    cert = simulate_merge_host(certify_shards(*shards, 3000), "paper")[0]
    if final == "host":
        want = (cert.src, cert.dst, cert.mask)
    else:
        st = tour_state(cert.src, cert.dst, cert.mask, 3000)
        want = get_analysis("bridges").device_fn(cert.src, cert.dst,
                                                 cert.mask, 3000, st, 2999)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert find_bridges(s, d, 3000, final=final, mesh=nccl_world) == planted


# ------------------------------------------------------------- the engine
def _engine_call(engines, method, *args, **kw):
    """One call on the card's engine and the CPU's, answers equal; then the
    live buffers slot for slot and the counters."""
    card, cpu = engines
    got = getattr(card, method)(*args, **kw)
    want = getattr(cpu, method)(*args, **kw)
    if want is cpu:  # load, load_stream, ingest_chunk
        assert got is card, method
    elif isinstance(want, list):
        assert all(_same_answer(g, w) for g, w in zip(got, want)), method
    else:
        assert _same_answer(got, want), method
    if cpu._live is not None:
        for name, state in cpu._live.certs.items():
            other = card._live.certs[name]
            assert (state is None) == (other is None), name
            for a, b in zip(state or (), other or ()):
                assert torch.equal(a, b.cpu()), name
        if cpu._live.full is None:  # streamed: the host spill rings
            assert card._live.full is None
            for a, b in zip(cpu._live.stream.to_numpy(),
                            card._live.stream.to_numpy()):
                assert np.array_equal(a, b)
        else:
            for a, b in zip(cpu._live.full, card._live.full):
                assert torch.equal(a, b.cpu())
    snap, card_snap = cpu.snapshot(), card.snapshot()
    for key in ("programs", "hits", "misses", "traces", "rebuilds",
                "live_graph_edges", "live_bytes", "peak_live_bytes",
                "ingest"):
        assert card_snap.get(key) == snap.get(key), key
    return got


def _same_answer(a, b):
    if isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_engine_on_card_equals_cpu(cuda):
    """The live graph (load, inserts, a free deletion, a rebuilding one,
    the lazy sfs and hybrid certificates), a batched union with per-graph
    deletions and a one-shot ``delete=``: the engine on the card against
    the engine on the CPU, answers, live buffers and counters."""
    from repro_torch.engine import BridgeEngine

    engines = (BridgeEngine(), BridgeEngine(device="cpu"))
    assert engines[0].device.type == "cuda"
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    _engine_call(engines, "load", s, d, 3000)
    assert _engine_call(engines, "current_bridges") == planted
    for kind in ("cuts", "bcc", "2ecc"):
        _engine_call(engines, "current_analysis", kind)
    _engine_call(engines, "current_analysis", "cuts", certificate="hybrid")
    for step in range(2):
        ds, dd = gen.random_graph(3000, 16, seed=40 + step)
        _engine_call(engines, "insert_edges", ds, dd, kind="cuts")
    # free: edges of no certificate; rebuild: a planted bridge
    cs, cd, cm = (x.cpu().numpy() for x in engines[1]._live.certs["2ec"][:3])
    cert = set(zip(cs[cm].tolist(), cd[cm].tolist()))
    free = [(a, b) for a, b in zip(s.tolist(), d.tolist())
            if (a, b) not in cert and (b, a) not in cert][:16]
    _engine_call(engines, "delete_edges", *map(np.array, zip(*free)))
    assert engines[0].live_rebuilds["2ec"] == 0
    bridge = sorted(planted)[0]
    _engine_call(engines, "delete_edges", [bridge[0]], [bridge[1]],
                 kind="bcc", certificate="hybrid")
    assert engines[0].live_rebuilds["2ec"] == 1
    graphs = [gen.planted_bridge_graph(700, 9_000, 3, seed=k)[:2]
              for k in range(3)]
    dels = [(graphs[0][0][:9], graphs[0][1][:9]), None,
            (graphs[2][0][::50], graphs[2][1][::50])]
    for kind, final in (("bridges", "device"), ("cuts", "host"),
                        ("bcc", "device")):
        _engine_call(engines, "analyze_batch", graphs, 700, kind=kind,
                     final=final, delete=dels)
    for kind in ("bridges", "cuts"):
        _engine_call(engines, "analyze", s, d, 3000, kind=kind,
                     delete=(s[:20], d[:20]))


def test_engine_batch_is_one_union_pass(cuda):
    """A batched certificate pass launches each round once for the whole
    batch: the slowest row's rounds, not the sum over rows."""
    from repro_torch.core.certificate import sparse_certificate_ex
    from repro_torch.engine import BatchedEdgeList, make_batched_pipeline

    graphs = [gen.planted_bridge_graph(700, 9_000, 3, seed=k)[:2]
              for k in range(4)]
    tb = BatchedEdgeList.from_graphs(graphs, 1024, capacity=16_384)
    per_row = [sparse_certificate_ex(tb[b])[3] for b in range(4)]
    reset_launch_counts()
    make_batched_pipeline(1024, final="host")(tb.src, tb.dst, tb.mask)
    launched = launch_counts()["boruvka_round"]
    assert launched == max(r[0] for r in per_row) + max(r[1] for r in per_row)
    assert launched < sum(sum(r) for r in per_row)


def _fold_inputs(cuda, shape):
    """What the engine's fold programs hand the kernels: the 2ec warm fold
    scans a 16-slot delta (12 live) against 4,096 vertices with the live
    certificate's warm labels; the sfs rescan fold a certificate ∪ delta
    (5,998 + 16 slots at n = 3,000: not a multiple of four)."""
    from repro_torch.core.certificate import certificate_capacity
    from repro_torch.core.certs import get_certificate

    n = 4096 if shape == "warm_fold" else 3000
    s, d, _ = gen.planted_bridge_graph(n, 20 * n, 5, seed=2)
    ds, dd = gen.random_graph(n, 12, seed=3)
    delta = EdgeList.from_arrays(ds, dd, n, capacity=16, device=cuda)
    el = EdgeList.from_arrays(s, d, n, device=cuda)
    if shape == "warm_fold":
        state = get_certificate("2ec").load_state(el, certificate_capacity(n))
        return delta, state[3]
    cs, cd, cm = get_certificate("sfs").load_state(el,
                                                   certificate_capacity(n))
    return concat_edges(EdgeList(cs, cd, cm, n), delta), None


@pytest.mark.parametrize("shape", ["warm_fold", "rescan_fold"])
def test_connectivity_kernels_at_the_engine_fold_shapes(cuda, shape):
    """The three kernels bit for bit at the engine's fold shapes."""
    el, warm = _fold_inputs(cuda, shape)
    src, dst, mask, n = el.src, el.dst, el.mask, el.n_nodes
    if shape == "rescan_fold":
        assert el.capacity == 6014 and el.capacity % 4 == 2
    valid = mask & (src != dst)
    ident = torch.arange(n, dtype=torch.int32, device=cuda)
    for labels in (ident,) if warm is None else (warm, ident):
        assert torch.equal(boruvka_round(src, dst, valid, labels, n),
                           boruvka_round_ref(src, dst, valid, labels, n))
    rng = np.random.default_rng(el.capacity)
    for p in (0.05, 0.5):
        frontier = torch.as_tensor(rng.random(n) < p).to(cuda)
        visited = frontier | torch.as_tensor(rng.random(n) < 0.3).to(cuda)
        args = (src, dst, valid, frontier, visited, n)
        for a, b in zip(frontier_round(*args), frontier_round_ref(*args)):
            assert torch.equal(a, b)
    slots = torch.arange(el.capacity, dtype=torch.int32, device=cuda)
    keys = torch.where(mask, slots, INF32)
    for ids in (src, dst):
        assert torch.equal(segment_min(keys, ids, n),
                           segment_min_ref(keys, ids, n))


def test_one_rank_nccl_engine_deletions_equal_simulator(nccl_world):
    """``BridgeEngine(mesh=...).analyze(..., delete=...)`` twice on a
    one-rank NCCL group: the simulator's deletion rule, and the second
    call a cache hit."""
    from repro_torch.core.merge import simulate_churn_host
    from repro_torch.engine import BridgeEngine

    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    keys = (np.concatenate([s[:30], [sorted(planted)[0][0]]]),
            np.concatenate([d[:30], [sorted(planted)[0][1]]]))
    eng = BridgeEngine(mesh=nccl_world)
    shards = _stacked_shards(s, d, 3000, 1, "cuda")
    cert = simulate_churn_host([EdgeList(*(t[0] for t in shards), 3000)],
                               *keys)[0]
    want = bridges_dfs(*masked_arrays((cert.src, cert.dst, cert.mask)), 3000)
    for run in range(2):
        assert eng.analyze(s, d, 3000, final="host", delete=keys) == want
        assert (eng.stats.misses, eng.stats.hits) == (1, run)
    assert sorted(planted)[0] not in want


# ------------------------------------------------------- streaming ingest
def test_streamed_engine_on_card_equals_cpu(cuda):
    """A streamed live graph (ragged ingest steps, the lazy sfs and hybrid
    certificates by ring replay, an insert as an ingest, a free deletion
    and a rebuilding one by replay): the engine on the card against the
    engine on the CPU, answers, live states, rings and counters."""
    from repro_torch.engine import BridgeEngine

    engines = (BridgeEngine(), BridgeEngine(device="cpu"))
    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    _engine_call(engines, "load_stream", s[:20_000], d[:20_000], 3000,
                 chunk_edges=4096)
    steps = range(20_000, len(s), 7_001)
    for lo in steps:
        _engine_call(engines, "ingest_chunk", s[lo:lo + 7_001],
                     d[lo:lo + 7_001])
    assert engines[0]._live.stream.chunks_in == -(-20_000 // 4096) + sum(
        -(-len(s[lo:lo + 7_001]) // 4096) for lo in steps)
    assert _engine_call(engines, "current_bridges") == planted
    for kind in ("cuts", "bcc", "2ecc", "bridge_tree"):
        _engine_call(engines, "current_analysis", kind)
    _engine_call(engines, "current_analysis", "cuts", certificate="hybrid")
    ds, dd = gen.random_graph(3000, 40, seed=41)
    _engine_call(engines, "insert_edges", ds, dd, kind="cuts")
    cs, cd, cm = (x.cpu().numpy() for x in engines[1]._live.certs["2ec"][:3])
    cert = set(zip(cs[cm].tolist(), cd[cm].tolist()))
    free = [(a, b) for a, b in zip(s.tolist(), d.tolist())
            if (a, b) not in cert and (b, a) not in cert][:16]
    _engine_call(engines, "delete_edges", *map(np.array, zip(*free)))
    bridge = sorted(planted)[0]
    _engine_call(engines, "delete_edges", [bridge[0]], [bridge[1]],
                 kind="bcc", certificate="hybrid")
    assert engines[0].live_rebuilds["2ec"] == 1
    assert engines[0].snapshot()["ingest"]["replays"] >= 3


def _chunk_inputs(cuda, shape):
    """What streaming hands the kernels: a ragged 4,096-slot chunk (2,905
    live) against 4,096 vertices with the live 2ec state's warm labels;
    the rescan of the sfs state ∪ a chunk (5,998 + 4,096 slots at
    n = 3,000: not a multiple of four)."""
    from repro_torch.core.certificate import certificate_capacity
    from repro_torch.core.certs import get_certificate
    from repro_torch.graph.datastructs import ChunkedEdgeStream

    n = 4096 if shape == "chunk_fold" else 3000
    s, d, _ = gen.planted_bridge_graph(n, 20 * n, 5, seed=2)
    ds, dd = gen.random_graph(n, 2_905, seed=3)
    chunk, = ChunkedEdgeStream(n, 4096, device=cuda).admit(ds, dd)
    el = EdgeList.from_arrays(s, d, n, device=cuda)
    if shape == "chunk_fold":
        state = get_certificate("2ec").load_state(el, certificate_capacity(n))
        return chunk, state[3]
    cs, cd, cm = get_certificate("sfs").load_state(el,
                                                   certificate_capacity(n))
    return concat_edges(EdgeList(cs, cd, cm, n), chunk), None


@pytest.mark.parametrize("shape", ["chunk_fold", "chunk_rescan"])
def test_connectivity_kernels_at_the_chunk_shapes(cuda, shape):
    """The three kernels bit for bit against ``ref.py`` at the chunk
    shapes."""
    el, warm = _chunk_inputs(cuda, shape)
    src, dst, mask, n = el.src, el.dst, el.mask, el.n_nodes
    assert el.capacity == (4096 if shape == "chunk_fold" else 10_094)
    valid = mask & (src != dst)
    ident = torch.arange(n, dtype=torch.int32, device=cuda)
    for labels in (ident,) if warm is None else (warm, ident):
        assert torch.equal(boruvka_round(src, dst, valid, labels, n),
                           boruvka_round_ref(src, dst, valid, labels, n))
    rng = np.random.default_rng(el.capacity)
    for p in (0.05, 0.5):
        frontier = torch.as_tensor(rng.random(n) < p).to(cuda)
        visited = frontier | torch.as_tensor(rng.random(n) < 0.3).to(cuda)
        args = (src, dst, valid, frontier, visited, n)
        for a, b in zip(frontier_round(*args), frontier_round_ref(*args)):
            assert torch.equal(a, b)
    slots = torch.arange(el.capacity, dtype=torch.int32, device=cuda)
    keys = torch.where(mask, slots, INF32)
    for ids in (src, dst):
        assert torch.equal(segment_min(keys, ids, n),
                           segment_min_ref(keys, ids, n))


def test_sharded_streaming_on_card_equals_cpu(cuda):
    """``simulate_stream_merge_host`` with every shard streamed on the card
    against the same on the CPU, buffer for buffer; machine 0 answers."""
    from repro_torch.core.merge import simulate_stream_merge_host

    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=4)
    for cert in ("2ec", "sfs"):
        (card, card_streams), (cpu, cpu_streams) = [
            simulate_stream_merge_host(
                [EdgeList(*(t[i] for t in shards), 3000) for i in range(4)],
                4096, certificate=cert)
            for shards in (_stacked_shards(s, d, 3000, 4, dev)
                           for dev in (cuda, "cpu"))]
        for a, b in zip(card, cpu):
            for x, y in zip((a.src, a.dst, a.mask), (b.src, b.dst, b.mask)):
                assert torch.equal(x.cpu(), y)
        assert ([st.folds for st in card_streams]
                == [st.folds for st in cpu_streams])
        assert bridges_dfs(*masked_arrays(
            (card[0].src, card[0].dst, card[0].mask)), 3000) == planted


# ---------------------------------------------------------------- repairs
def test_repairs_on_the_card_in_a_subprocess(cuda):
    """Ids outside ``[0, n)`` (the device finals) and batches with a row
    outside the bucket, on the card, in a process of their own: a
    surviving out-of-range index would be a device-side assert there, and
    would end only that process's CUDA context. The answers are
    ``chip_smoke.REPAIR_*``, the JAX package's."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.phase_repairs()"],
        capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cuda" and rec["checked"] == 20


# ---------------------------------------- scheduler, checkpoints, failover
def _sched_script(engine, rows, writes):
    """One submission script through a fresh ``BridgeScheduler``: the
    power-of-two warmup, everything submitted then drained, ragged waves,
    a churn turn on row 0's live graph, a ``cuts`` wave with the host
    final. Returns the answers, the ``SchedStats`` and the cache counters."""
    from repro_torch.engine import BridgeScheduler
    from repro_torch.obs import MetricsRegistry

    sched = BridgeScheduler(engine, max_batch=4, metrics=MetricsRegistry())
    tickets = []
    for b in (1, 2, 4):
        tickets += [sched.submit("warm", *rows[0]) for _ in range(b)]
        sched.drain_all()
    engine.load(*rows[0])
    tickets += [sched.submit(f"t{i % 3}", *r) for i, r in enumerate(rows)]
    sched.drain_all()
    for wave in (3, 1):
        tickets += [sched.submit("t", *r) for r in rows[:wave]]
        sched.drain()
    tickets += [sched.submit("t0", *rows[1])]
    tickets += [sched.submit("t0", *w, op=op) for op, w in writes]
    sched.drain_all()
    tickets += [sched.submit("t1", *r, kind="cuts", final="host")
                for r in rows[:3]]
    sched.drain_all()
    return ([t.result() for t in tickets], sched.stats.snapshot(),
            engine.cache_info())


def test_scheduler_on_card_equals_cpu(cuda):
    """The same submission script through the scheduler on the card and on
    the CPU: the same answers, ``SchedStats`` and program counters, every
    bridges answer the planted one, and the card's dispatches launching
    the kernels."""
    from repro_torch.engine import BridgeEngine

    graphs = [gen.planted_bridge_graph(700 - k % 3, 9_000, 3, seed=k)
              for k in range(6)]
    rows = [(s, d, 700 - k % 3) for k, (s, d, _) in enumerate(graphs)]
    writes = [("insert_edges", gen.random_graph(600, 64, seed=5)),
              ("delete_edges", (graphs[0][0][:32], graphs[0][1][:32]))]
    reset_launch_counts()
    card = _sched_script(BridgeEngine(), rows, writes)
    launches = launch_counts()
    cpu = _sched_script(BridgeEngine(device="cpu"), rows, writes)
    assert all(_same_answer(a, b) for a, b in zip(card[0], cpu[0]))
    assert card[1:] == cpu[1:]
    assert card[0][7:13] == [p for _, _, p in graphs]
    assert all(launches[k] for k in ("boruvka_round", "frontier_round",
                                     "segment_min"))


def test_checkpoint_restore_live_on_card_runs_no_program(cuda, tmp_path):
    """``restore_live`` on the card: no program run (traces and cache keys
    unchanged), every restored array on the card, the answers those of
    the snapshot, and the restored state equal to the CPU engine's after
    the same calls. (The random inserts join the planted blobs, so the
    snapshot's bridges are not the planted ones.)"""
    from repro_torch.engine import BridgeEngine

    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=2)
    engines = (BridgeEngine(), BridgeEngine(device="cpu"))
    for eng, sub in zip(engines, ("card", "cpu")):
        eng.enable_checkpoints(tmp_path / sub, every=2)
    _engine_call(engines, "load", s, d, 3000)
    assert _engine_call(engines, "current_analysis", "bridges") == planted
    _engine_call(engines, "current_analysis", "cuts")
    for k in range(2):
        _engine_call(engines, "insert_edges",
                     *gen.random_graph(3000, 64, seed=60 + k))
    want = _engine_call(engines, "current_analysis", "bridges")
    _engine_call(engines, "insert_edges", *gen.random_graph(3000, 64, seed=9))
    card = engines[0]
    traces, keys = card.stats.traces, set(card._cache.keys())
    assert _engine_call(engines, "restore_live") == 2
    assert card.stats.traces == traces and set(card._cache.keys()) == keys
    assert all(t.is_cuda for t in card._live.full)
    assert all(t.is_cuda for st in card._live.certs.values()
               if st is not None for t in st)
    assert _engine_call(engines, "current_analysis", "bridges") == want
    assert card.snapshot()["checkpoint"] == engines[1].snapshot()["checkpoint"]


@pytest.mark.parametrize("kill,ckpt", [({}, None), ({0: 1}, 1), ({0: 1}, None),
                                       ({3: 0, 1: 2}, 1)],
                         ids=["clean", "checkpoint", "recertify", "two"])
def test_simulated_failover_on_card_equals_cpu(cuda, tmp_path, kill, ckpt):
    """``simulate_failover_host`` on the card against the CPU, slot for
    slot, with the same info dict; the disk store's snapshots go back onto
    the card before they fold (the launches count the fold's rounds)."""
    from repro_torch.checkpoint import MachineCheckpoints
    from repro_torch.core.merge import simulate_failover_host
    from repro_torch.runtime import FailureInjector

    s, d, planted = gen.planted_bridge_graph(3000, 60_000, 5, seed=3)
    out = []
    for dev in (cuda, "cpu"):
        psrc, pdst, pmask = _stacked_shards(s, d, 3000, 4, dev)
        rows = [EdgeList(psrc[i], pdst[i], pmask[i], 3000) for i in range(4)]
        store = (MachineCheckpoints(tmp_path / str(dev)) if ckpt else None)
        reset_launch_counts()
        out.append(simulate_failover_host(
            rows, "paper", FailureInjector(kill_schedule=dict(kill)),
            checkpoint_every=ckpt, checkpoints=store))
        out[-1] += (launch_counts()["boruvka_round"],)
    (alive, certs, info, launched), (calive, ccerts, cinfo, _) = out
    assert (alive, info) == (calive, cinfo) and launched > 0
    for a, b in zip(certs, ccerts):
        assert a.src.is_cuda
        for x, y in zip((a.src, a.dst, a.mask), (b.src, b.dst, b.mask)):
            assert torch.equal(x.cpu(), y)
    ans = certs[alive.index(info["answering"])]
    assert bridges_dfs(*masked_arrays((ans.src, ans.dst, ans.mask)),
                       3000) == planted


def test_serve_failover_on_card_equals_cpu(cuda, tmp_path):
    """The serving drill at its smoke size on the card and on the CPU: the
    same report (minus the checkpoint directory and the latency)."""
    import types

    from repro_torch.launch.failover import serve_failover

    args = dict(machines=4, steps=8, kill_machine=1, kill_at_step=2,
                ckpt_every=1, schedule="paper", n=64, edges=512,
                delta_edges=16, seed=0)
    reports = []
    for dev in (cuda, "cpu"):
        rep = serve_failover(types.SimpleNamespace(
            **args, ckpt_dir=str(tmp_path / str(dev))), device=dev)
        rep.pop("ckpt_dir")
        rep["recovery"].pop("latency_s")
        reports.append(rep)
    assert reports[0] == reports[1]
    assert reports[0]["final_parity"]
    assert reports[0]["recovery"]["source"] == "checkpoint"


@pytest.mark.parametrize("argv", [
    ["--smoke", "--analysis", "all"],
    ["--smoke", "--workload", "churn", "--analysis", "all"],
    ["--smoke", "--workload", "multitenant", "--arrival-qps", "0"],
    ["--smoke", "--workload", "ingest"]],
    ids=["insert_all", "churn", "multitenant", "ingest"])
def test_serve_driver_on_card_equals_cpu(cuda, argv):
    """``launch/serve_bridges.py::main`` with ``--verify`` on the card and
    on the CPU: the same report without the clock's values
    (``tests/torch_serve_report.py``; ``kernel_path`` is ``cuda`` on the
    card, ``ref`` on the CPU), and the card's run launching the kernels."""
    from repro_torch.launch.serve_bridges import main

    from torch_serve_report import clock_free

    reset_launch_counts()
    card = main([*argv, "--verify"])
    launches = launch_counts()
    cpu = main([*argv, "--verify"], device="cpu")
    assert clock_free(card, kernel_path="path") == clock_free(
        cpu, kernel_path="path")
    assert launches["boruvka_round"] and launches["segment_min"]


@pytest.mark.parametrize("e", [64, 256, 1128])
def test_baseline_on_card_equals_cpu(cuda, e):
    """The Savage-Ja'Ja' baseline at Fig. 5's smoke width (V 48, seed 3;
    1,128 is the complete graph) on the card and on the CPU: mask for
    mask, its answer the host Tarjan's, and its forest launching
    ``boruvka_round``."""
    from repro_torch.core.baseline_savage_jaja import bridges_savage_jaja

    src, dst = gen.random_graph(48, e, seed=3)
    reset_launch_counts()
    card = bridges_savage_jaja(EdgeList.from_arrays(src, dst, 48, device=cuda))
    assert launch_counts()["boruvka_round"] > 0
    cpu = bridges_savage_jaja(EdgeList.from_arrays(src, dst, 48, device="cpu"))
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)
    got = {(min(int(a), int(b)), max(int(a), int(b)))
           for a, b in zip(src[cpu.numpy()], dst[cpu.numpy()])}
    assert got == bridges_dfs(src, dst, 48)


# ------------------------------------------------- the language-model path
LM_ARCHS = ["qwen3_0_6b", "qwen3_14b", "stablelm_12b"]
#: card against CPU, against the largest magnitude: float32 1e-5 (sums in
#: another order), bfloat16 3e-2 (a few units of 2^-8 after two layers)
LM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _lm_close(got, want, tol):
    got, want = got.float().cpu(), want.float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_smoke_on_card_equals_cpu(cuda, arch, dtype):
    """The prefill step (4 x 16 tokens, a cache of 24) and four decode
    steps, each fed the card's greedy tokens, on the card and on the CPU
    from one set of weights: logits and the cache within ``LM_TOL``; no
    kernel launched (the path reaches none of the five)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.tree import tree_map
    from repro_torch.training import make_lm_decode_step, make_lm_prefill_step

    cfg = dataclasses.replace(get(arch).smoke_config, param_dtype=dtype)
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    prompts = torch.randint(0, cfg.vocab, (4, 16),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    par = tfm.Parallelism.none()
    prefill, decode = make_lm_prefill_step(cfg, par, 24), \
        make_lm_decode_step(cfg, par)
    reset_launch_counts()
    got, got_cache = prefill(card, prompts.to(cuda))
    want, want_cache = prefill(cpu, prompts)
    for step in range(4):
        assert got.device.type == cuda.type and got.dtype == torch.float32
        _lm_close(got, want, LM_TOL[dtype])
        for a, b in zip(got_cache, want_cache):
            assert a.device.type == cuda.type and a.dtype == cfg.dtype
            _lm_close(a, b, LM_TOL[dtype])
        tok = got.argmax(-1)[:, None].to(torch.int32)
        got, got_cache = decode(card, got_cache, tok, 17 + step)
        want, want_cache = decode(cpu, want_cache, tok.cpu(), 17 + step)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serve_main_on_card(cuda, arch, capsys):
    """``launch/serve.py::main`` at ``--smoke`` on the card: its two lines,
    tokens of the vocabulary, the same tokens under the same seed, no
    kernel launched."""
    from repro_torch.configs import get
    from repro_torch.launch import serve

    reset_launch_counts()
    gen = serve.main(["--smoke", "--arch", arch], device=cuda)
    assert not any(launch_counts().values())
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("prefill 4x16 tok in ")
    vocab = get(arch).smoke_config.vocab
    assert gen.shape == (4, 32) and ((gen >= 0) & (gen < vocab)).all()
    assert np.array_equal(serve.main(["--smoke", "--arch", arch],
                                     device=cuda), gen)


def test_lm_decode_cache_in_place_on_card(cuda):
    """``decode_step`` writes into the card's cache and returns the same
    tensors (no copy of the cache); the rows it wrote equal the CPU's,
    rows elsewhere stay zero."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.tree import tree_map

    cfg = get("qwen3_14b").smoke_config
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    par = tfm.Parallelism.none()
    cache = tfm.init_cache(cfg, 2, 8, device=cuda)
    ptrs = [c.data_ptr() for c in cache]
    tok = torch.tensor([[3, 4], [5, 6]], dtype=torch.int32)
    logits, out = tfm.decode_step(card, cache, tok.to(cuda), 5, cfg, par)
    assert out[0] is cache[0] and out[1] is cache[1]
    assert [c.data_ptr() for c in out] == ptrs
    want_logits, want = tfm.decode_step(
        cpu, tfm.init_cache(cfg, 2, 8, device="cpu"), tok, 5, cfg, par)
    _lm_close(logits, want_logits, LM_TOL["float32"])
    for a, b in zip(out, want):
        _lm_close(a, b, LM_TOL["float32"])
        rows = a.abs().amax(dim=(0, 1, 3, 4)).cpu()
        assert rows[3:5].min() > 0
        assert not rows[:3].any() and not rows[5:].any()


# ------------------------------- language-model training, mixture of experts
LM_TRAIN_ARCHS = ["qwen3_0_6b", "qwen3_14b", "stablelm_12b", "dbrx_132b",
                  "qwen3_moe_235b_a22b"]


def _lm_state(params, seed: int) -> dict:
    """An AdamW state of ``params`` on the CPU past the warmup (step 5),
    m normal at 1e-3, v its square plus 1e-6: a step then moves every
    element by a smooth, full-lr update (``test_torch_lm_train.py``)."""
    from repro_torch.optim.tree import tree_map

    gen = torch.Generator().manual_seed(seed)
    m = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-3,
                 params)
    return {"step": torch.tensor(5, dtype=torch.int32),
            "master": tree_map(lambda p: p.float().clone(), params),
            "m": m, "v": tree_map(lambda a: a * a + 1e-6, m)}


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """One ``make_lm_train_step`` step at the float32 smoke config (step 5
    of 20, warmup 2) on the card and on the CPU from the same weights and
    state: loss, grad_norm, lr within 1e-5 relative; every param, master,
    m and v leaf within 1e-5 of its largest magnitude; the donated step
    (new values written into the given tensors) gives the pure step's
    bits on the card; no kernel launched."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.tree import tree_map
    from repro_torch.training import make_lm_train_step

    cfg = get(arch).smoke_config
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cpu = _lm_state(cpu, 1)
    card = tree_map(lambda t: t.to(cuda), cpu)
    opt_card = tree_map(lambda t: t.to(cuda), opt_cpu)
    kept = tree_map(lambda t: t.clone(), (card, opt_card))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 17),
                                     generator=torch.Generator().manual_seed(2),
                                     dtype=torch.int32)}
    par = tfm.Parallelism.none()
    step = make_lm_train_step(cfg, par, warmup=2, total_steps=20)
    reset_launch_counts()
    card1, opt1, got = step(card, opt_card, batch)
    assert not any(launch_counts().values())
    cpu1, opt_cpu1, want = step(cpu, opt_cpu, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key].item(), want[key].item(),
                                   rtol=1e-5, err_msg=key)
    for got_tree, want_tree in ((card1, cpu1), (opt1["master"],
                                                opt_cpu1["master"]),
                                (opt1["m"], opt_cpu1["m"]),
                                (opt1["v"], opt_cpu1["v"])):
        for a, b in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert a.device.type == "cuda"
            assert float((a.cpu() - b).abs().max()) <= \
                1e-5 * float(b.abs().max())
    donated = make_lm_train_step(cfg, par, warmup=2, total_steps=20,
                                 donate=True)
    p, o = kept
    ptrs = [t.data_ptr() for t in tree_leaves((p, o["m"]))]
    p2, o2, _ = donated(p, o, batch)
    assert [t.data_ptr() for t in tree_leaves((p2, o2["m"]))] == ptrs
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((card1, opt1))):
        assert torch.equal(a, b)


def _moe_grid(seed, t, d, e, f, dtype):
    gen = torch.Generator().manual_seed(seed)

    def grid(*shape):
        return (torch.randn(shape, generator=gen) * 4).round().clamp(
            -16, 16) / 16

    return [grid(t, d).to(dtype), grid(d, e).to(dtype),
            (torch.randn(e, d, f, generator=gen) / d ** 0.5).to(dtype),
            (torch.randn(e, d, f, generator=gen) / d ** 0.5).to(dtype),
            (torch.randn(e, f, d, generator=gen) / f ** 0.5).to(dtype)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kw", [{"n_experts": 8, "top_k": 2},
                                {"n_experts": 16, "top_k": 4,
                                 "capacity_factor": 0.5}])
def test_moe_ffn_local_on_card_equals_cpu(cuda, kw, dtype, tol):
    """``moe_ffn_local`` on the card against the CPU, x and the router on a
    grid of 2^-4 (exact float32 logits): the routing (ids, ranks, kept
    mask, C) equal, the output within ``tol`` of its largest magnitude,
    aux within 1e-6 relative; with drops at capacity factor 0.5."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_ff_expert=48, **kw)
    cpu = _moe_grid(3, 64, 32, cfg.n_experts, 48, dtype)
    card = [t.to(cuda) for t in cpu]
    e = cfg.n_experts
    r_card = moe.route(card[0], card[1], cfg, 0, e)
    r_cpu = moe.route(cpu[0], cpu[1], cfg, 0, e)
    assert r_card["cap"] == r_cpu["cap"]
    for key in ("ids", "rank", "kept"):
        assert torch.equal(r_card[key].cpu(), r_cpu[key]), key
    got, aux = moe.moe_ffn_local(*card, cfg=cfg, e_start=0, n_local=e)
    want, aux_cpu = moe.moe_ffn_local(*cpu, cfg=cfg, e_start=0, n_local=e)
    assert got.dtype == dtype and got.device.type == "cuda"
    _lm_close(got, want, tol)
    np.testing.assert_allclose(aux.item(), aux_cpu.item(), rtol=1e-6)


def test_lm_train_main_on_card(cuda, tmp_path, capsys):
    """``launch/train.py::main`` at ``--smoke`` on the card: the crash
    drill (30 steps straight; killed at 17 with exit 17, then restarted
    from step 10) lands on the same printed ``final_loss``; no kernel
    launched."""
    import re

    from repro_torch.launch import train

    def argv(name):
        return ["--smoke", "--steps", "30", "--batch", "2", "--seq", "32",
                "--ckpt-every", "10", "--ckpt-dir", str(tmp_path / name)]

    reset_launch_counts()
    train.main(argv("a"), device=cuda)
    straight = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        train.main(argv("b") + ["--fail-at", "17"], device=cuda)
    assert exc.value.code == 17
    capsys.readouterr()
    train.main(argv("b"), device=cuda)
    resumed = capsys.readouterr().out
    assert not any(launch_counts().values())
    assert "[resume] restored step 10" in resumed

    def final(out):
        return re.search(r"^final_loss (\S+)$", out, re.M).group(1)

    assert final(resumed) == final(straight)


# ----------------------------------- graph networks, pipeline parallelism
@pytest.mark.parametrize("arch,mode", GNN_CHECK_CASES)
def test_gnn_train_step_on_card_equals_cpu(cuda, arch, mode):
    """One ``make_gnn_train_step`` step at the smoke config on the card and
    on the CPU from the same weights and an AdamW state past the warmup:
    loss, grad_norm, lr and every param, master, m and v leaf within
    ``GNN_CHECK_TOL``; the leaves stay on the card; no kernel launched."""
    from repro_torch.configs import get
    from repro_torch.models import gnn
    from repro_torch.optim.tree import tree_map
    from repro_torch.training import make_gnn_train_step

    cfg = get(arch).smoke_config
    tol = GNN_CHECK_TOL[cfg.arch]
    cpu = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cpu = _lm_state(cpu, 1)
    card = tree_map(lambda t: t.to(cuda), cpu)
    opt_card = tree_map(lambda t: t.to(cuda), opt_cpu)
    batch = gnn_batch(cfg, mode, 0)
    step = make_gnn_train_step(cfg, None, mode, warmup=2, total_steps=20)
    reset_launch_counts()
    card1, opt1, got = step(card, opt_card, batch)
    assert not any(launch_counts().values())
    cpu1, opt_cpu1, want = step(cpu, opt_cpu, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key].item(), want[key].item(),
                                   rtol=tol, err_msg=key)
    for got_tree, want_tree in ((card1, cpu1),
                                (opt1["master"], opt_cpu1["master"]),
                                (opt1["m"], opt_cpu1["m"]),
                                (opt1["v"], opt_cpu1["v"])):
        for a, b in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert a.device.type == cuda.type
            _lm_close(a, b, tol)


def test_gnn_segment_ops_on_card_equal_cpu(cuda):
    """``gather_scatter``'s max and min bit for bit on the card (node 3's
    edges all masked: ``finfo`` extremes; nodes 8, 9 with none: 0), its sum
    and ``segment_mean`` within 1e-6; out-of-range ids dropped alike."""
    from repro_torch.models import gnn

    gen_ = torch.Generator().manual_seed(4)
    h = torch.randn(10, 6, generator=gen_)
    src = torch.tensor([0, 1, 2, -1, 4, 5, 6, 7, 12, -12, 1, 2])
    dst = torch.tensor([1, 2, 3, 3, 0, 4, 5, 6, 7, 1, -1, 20])
    mask = torch.tensor([1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1], dtype=torch.bool)
    for reduce in ("sum", "max", "min"):
        want = gnn.gather_scatter(h, src, dst, mask, 10, reduce)
        got = gnn.gather_scatter(h.to(cuda), src.to(cuda), dst.to(cuda),
                                 mask.to(cuda), 10, reduce).cpu()
        if reduce == "sum":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want)
    m_cpu, c_cpu = gnn.segment_mean(h[src.clamp(0, 9)], dst, 10, mask)
    m_card, c_card = gnn.segment_mean(h[src.clamp(0, 9)].to(cuda),
                                      dst.to(cuda), 10, mask.to(cuda))
    torch.testing.assert_close(m_card.cpu(), m_cpu, rtol=1e-6, atol=1e-6)
    assert torch.equal(c_card.cpu(), c_cpu)


@pytest.fixture
def nccl_pipe(cuda, tmp_path):
    """A one-rank NCCL group and a (1, 1) ``("pipe", "data")`` mesh."""
    import datetime

    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_test_mesh(1, ("pipe", "data"), (1, 1))
    finally:
        dist.destroy_process_group()


def test_one_rank_pipeline_on_card_is_lm_loss(nccl_pipe):
    """``make_pp_loss_fn`` with one stage on a one-rank NCCL ``("pipe",
    "data")`` mesh, in float32 on the card: the loss is the mean of
    ``lm_loss`` over the microbatches (1e-6 relative), and its gradient
    that mean's (1e-5 of each leaf's largest magnitude); no kernel
    launched."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import pipeline as pp_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.tree import tree_unflatten

    cfg = dataclasses.replace(get("qwen3_0_6b").smoke_config,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    tokens = torch.randint(0, cfg.vocab, (3, 2, 17),
                           generator=torch.Generator().manual_seed(1))
    par = Parallelism(mesh=nccl_pipe, dp_axes=("data",), tp_axis="model")
    loss_fn = pp_mod.make_pp_loss_fn(cfg, par, pp_mod.PipelineConfig(1, 3))
    staged = pp_mod.stageify_params(params, 1, 0)

    def value_and_grad(fn, tree):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
        loss = fn(tree_unflatten(tree, leaves))
        return loss.item(), torch.autograd.grad(loss, leaves)

    reset_launch_counts()
    got, g_pp = value_and_grad(lambda p: loss_fn(p, {"tokens": tokens}),
                               staged)
    assert not any(launch_counts().values())
    want, g_ref = value_and_grad(lambda p: sum(
        tfm.lm_loss(p, {"tokens": tokens[i]}, cfg, Parallelism.none())
        for i in range(3)) / 3, params)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(g_pp, g_ref):
        _lm_close(a.reshape(b.shape), b.cpu(), 1e-5)


def test_dryrun_cell_on_card(cuda, tmp_path):
    """``run_cell`` with fake tensors on the card's device type (SASRec's
    ``retrieval_cand``: the fake ``embedding_bag``) on the single mesh of
    256 fake ranks: status ok, no kernel launched, and the same record as
    with fake tensors on the CPU."""
    from repro_torch.launch.dryrun import run_cell

    reset_launch_counts()
    got = run_cell("sasrec", "retrieval_cand", "single", tmp_path / "cuda",
                   force=True, device="cuda")
    assert got["status"] == "ok", got.get("error")
    assert not any(launch_counts().values())
    want = run_cell("sasrec", "retrieval_cand", "single", tmp_path / "cpu",
                    force=True, device="cpu")
    for key in ("analysis", "memory", "collectives", "roofline"):
        assert got[key] == want[key], key


def test_fake_embedding_bag_gives_kernel_shapes(cuda):
    """A fake card table gets the shape-only result: the kernel's shape
    and dtype on real inputs of the same shapes, and no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    table = torch.randn(1000, 50, device="cuda")
    idx = torch.randint(0, 1000, (3, 7), dtype=torch.int32, device="cuda")
    mask = torch.rand(3, 7, device="cuda") < 0.5
    want = embedding_bag(table, idx, mask, mode="mean")
    reset_launch_counts()
    with FakeTensorMode() as mode:
        got = embedding_bag(mode.from_tensor(table), mode.from_tensor(idx),
                            mode.from_tensor(mask), mode="mean")
    assert not any(launch_counts().values())
    assert (got.shape, got.dtype, got.device) == (want.shape, want.dtype,
                                                  want.device)


def test_one_rank_dtensor_train_step_on_card(nccl_grid):
    """One ``make_lm_train_step`` step over ``DTensor`` params placed by
    ``param_specs`` (and an AdamW state by ``zero1_specs``) on a one-rank
    NCCL (data, model) mesh, against the same step on plain tensors, in
    float32 on the card: the loss and grad_norm within 1e-5 relative,
    every new param and moment within 1e-5 of its scale; the donated step
    from the same inputs equal to it bit for bit."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get
    from repro_torch.launch.mesh import spec_placements
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import zero1_specs
    from repro_torch.optim.tree import tree_map
    from repro_torch.training import make_lm_train_step

    cfg = dataclasses.replace(get("qwen3_0_6b").smoke_config,
                              param_dtype="float32")
    par = Parallelism(mesh=nccl_grid, dp_axes=("data",), tp_axis="model")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    tokens = torch.randint(0, cfg.vocab, (4, 17), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    pspecs = tfm.param_specs(cfg, par)

    def place(tree, specs):
        return tree_map(lambda t, s: distribute_tensor(
            t, nccl_grid, spec_placements(nccl_grid, s), src_data_rank=None),
            tree, specs)

    opt = adamw_init(params)
    dopt = {"step": opt["step"],
            **{k: place(opt[k], zero1_specs(pspecs, "data", params,
                                            dp_size=1)[k])
               for k in ("master", "m", "v")}}
    dtok = distribute_tensor(tokens, nccl_grid, spec_placements(
        nccl_grid, (("data",), None)), src_data_rank=None)
    step = make_lm_train_step(cfg, par, total_steps=20, warmup=2)
    plain_step = make_lm_train_step(cfg, Parallelism.none(), total_steps=20,
                                    warmup=2)
    got_p, got_o, got = step(place(params, pspecs), dopt, {"tokens": dtok})
    want_p, want_o, want = plain_step(params, opt, {"tokens": tokens})
    for key in ("loss", "grad_norm"):
        g = got[key].full_tensor() if hasattr(got[key], "full_tensor") \
            else got[key]
        np.testing.assert_allclose(g.item(), want[key].item(), rtol=1e-5)
    for a, b in zip(tree_leaves(got_p) + tree_leaves(got_o["m"]),
                    tree_leaves(want_p) + tree_leaves(want_o["m"])):
        _lm_close(a.full_tensor(), b.cpu(), 1e-5)
    # the donated step from copies of the same inputs writes the pure
    # step's bits into every param, master, m and v leaf
    donated = make_lm_train_step(cfg, par, total_steps=20, warmup=2,
                                 donate=True)
    d_p, d_o, _ = donated(place(params, pspecs), tree_map(torch.clone, dopt),
                          {"tokens": dtok})
    keys = ("master", "m", "v")
    for a, b in zip(tree_leaves(d_p) + tree_leaves([d_o[k] for k in keys]),
                    tree_leaves(got_p) + tree_leaves([got_o[k]
                                                      for k in keys])):
        assert torch.equal(a.to_local(), b.to_local())


# ------------------------------------------- host syncs and stream spans
def _sync_warnings(call) -> int:
    """The synchronizing CUDA operations ``call`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (the mode is
    set before the count starts: setting it may warn once of itself)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("kind", ["bridges", "cuts"])
def test_every_host_sync_is_a_span(cuda, kind):
    """One ``analyze`` call: the syncs the debug mode counts with tracing
    off equal the ``sync/*`` spans of the same call with tracing on."""
    from repro_torch import obs

    s, d, _ = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)

    def call():
        return analyze(s, d, 3000, kind=kind, final="device", device=cuda)

    want = call()
    torch.cuda.synchronize()
    warned = _sync_warnings(call)
    tr = obs.enable_tracing()
    try:
        assert call() == want
    finally:
        obs.disable_tracing()
    spans = [x["name"] for x in tr.spans() if x["name"].startswith("sync/")]
    print(f"\n{kind}: {warned} sync warnings, {len(spans)} sync spans "
          f"({', '.join(f'{n} {spans.count(n)}' for n in sorted(set(spans)))})")
    assert warned == len(spans) > 0


def test_stream_spans_close_with_their_synced_pipeline(cuda):
    """Each synced ``stage/pipeline/bridges`` span of a traced run: its
    stream interval ends at or before the host's close, within 100 us at
    the median, and the stream spans inside it lie within it."""
    import statistics

    from repro_torch import obs

    s, d, _ = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    analyze(s, d, 3000, kind="bridges", final="device", device=cuda)
    tr = obs.enable_tracing()
    try:
        for _ in range(30):
            analyze(s, d, 3000, kind="bridges", final="device", device=cuda)
    finally:
        obs.disable_tracing()
    spans = tr.spans()

    def end(x):
        return x["attrs"]["device_t0"] + x["attrs"]["device_ms"] / 1e3

    pipes = [x for x in spans if x["name"] == "stage/pipeline/bridges"]
    lag = [x["t0"] + x["dur"] - end(x) for x in pipes]
    print(f"\nhost close - stream close (us): min {1e6 * min(lag):.1f}, "
          f"median {1e6 * statistics.median(lag):.1f}, "
          f"max {1e6 * max(lag):.1f} over {len(lag)}")
    assert len(pipes) == 30 and min(lag) >= 0
    assert statistics.median(lag) <= 100e-6
    inner = {x["index"]: x for x in pipes}
    for x in spans:
        if x["parent"] in inner and "device_t0" in x["attrs"]:
            p = inner[x["parent"]]
            assert x["attrs"]["device_t0"] >= p["attrs"]["device_t0"] - 20e-6
            assert end(x) <= end(p) + 20e-6


# ------------------------------------------- the upload's pinned ring
def _upload_ids(m, form, seed):
    """Two id arrays of ``m`` ids each: int32, int64 (wrapping as numpy's
    cast does) or a strided int32 view."""
    rng = np.random.default_rng(seed)
    if form == "int64":
        return rng.integers(-2**40, 2**40, (2, m))
    width = 2 * m if form == "strided" else m
    wide = rng.integers(np.iinfo(np.int32).min, INF32, (2, width),
                        dtype=np.int32)
    return wide[:, ::2] if form == "strided" else wide


def _same_upload(got, want):
    for a, b in ((got.src, want.src), (got.dst, want.dst),
                 (got.mask, want.mask)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


UPLOAD_SIZES = {"threshold-1": STAGED_MIN_IDS - 1,
                "threshold": STAGED_MIN_IDS,
                "slot-1": RING_SLOT_IDS - 1, "slot": RING_SLOT_IDS,
                "slot+1": RING_SLOT_IDS + 1,
                "3slots+17": 3 * RING_SLOT_IDS + 17}


@pytest.mark.parametrize("form", ["int32", "int64", "strided"])
@pytest.mark.parametrize("size", list(UPLOAD_SIZES))
def test_staged_upload_is_the_plain_one(cuda, size, form):
    """Into the bucket's buffers on the card, through the pinned ring from
    the threshold up (the open span counts every byte as staged there, none
    below): the same bits as the plain upload on the CPU."""
    from repro_torch import obs

    m = UPLOAD_SIZES[size]
    src, dst = _upload_ids(m, form, m)
    cap = admission_capacity(m)
    tr = obs.enable_tracing()
    try:
        with tr.span("upload", staged_bytes=0) as sp:
            got = EdgeList.from_arrays(src, dst, 7, capacity=cap,
                                       device=cuda)
    finally:
        obs.disable_tracing()
    assert sp.attrs["staged_bytes"] == (8 * m if m >= STAGED_MIN_IDS else 0)
    torch.cuda.synchronize()
    _same_upload(got, EdgeList.from_arrays(src, dst, 7, capacity=cap,
                                           device="cpu"))


def test_staged_uploads_back_to_back_arrive_intact(cuda):
    """Three staged uploads of different arrays, each of more chunks than
    the ring has slots, issued with no sync behind a busy stream, the
    caller's arrays overwritten as each returns: each arrives intact (a
    slot refilled before the card read it would show)."""
    m = 3 * RING_SLOT_IDS + 17
    assert 2 * -(-m // RING_SLOT_IDS) > RING_SLOTS
    arrays = [_upload_ids(m, "int32", seed) for seed in range(3)]
    want = [a.copy() for a in arrays]
    a = torch.randn(8192, 8192, device=cuda)
    for _ in range(5):  # some 100 ms of work ahead of the copies
        a = a @ a
    got = []
    for ids in arrays:
        got.append(EdgeList.from_arrays(ids[0], ids[1], 7, device=cuda))
        ids[:] = -1
    torch.cuda.synchronize()
    for el, (s, d) in zip(got, want):
        assert torch.equal(el.src.cpu(), torch.from_numpy(s))
        assert torch.equal(el.dst.cpu(), torch.from_numpy(d))
        assert bool(el.mask.all())


def test_staged_uploads_from_many_threads(cuda):
    """Sixteen threads upload arrays of their own at once, the interpreter
    switching every 10 us: every one arrives intact."""
    import threading

    m = RING_SLOT_IDS + 17
    arrays = [_upload_ids(m, "int32", 100 + i) for i in range(16)]
    got, errors = [None] * 16, []

    def work(i):
        try:
            got[i] = EdgeList.from_arrays(arrays[i][0], arrays[i][1], 7,
                                          device=cuda)
        except Exception as exc:  # read back below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    torch.cuda.synchronize()
    for el, (s, d) in zip(got, arrays):
        assert torch.equal(el.src.cpu(), torch.from_numpy(s))
        assert torch.equal(el.dst.cpu(), torch.from_numpy(d))


def _staged_graph():
    s, d, _ = gen.planted_bridge_graph(3000, 4 * STAGED_MIN_IDS, 5, seed=2)
    assert len(s) >= STAGED_MIN_IDS
    return s, d


def test_traced_analyze_stages_every_byte(cuda):
    """Above the threshold the whole copy goes through the ring:
    ``staged_bytes`` is ``bytes`` on ``stage/pad/h2d``, and the answer is
    the CPU's."""
    from repro_torch import obs

    s, d = _staged_graph()
    want = analyze(s, d, 3000, kind="bridges", device="cpu")
    tr = obs.enable_tracing()
    try:
        got = analyze(s, d, 3000, kind="bridges", device=cuda)
    finally:
        obs.disable_tracing()
    assert got == want
    h2d = [x["attrs"] for x in tr.spans() if x["name"] == "stage/pad/h2d"]
    assert h2d == [{"bytes": 8 * len(s), "staged_bytes": 8 * len(s)}]


def test_staged_copy_is_pinned_in_the_profile(cuda):
    """The profiler sees the call's copy to the card as pinned host memory
    to the device, and no pageable copy."""
    from torch.profiler import ProfilerActivity, profile

    s, d = _staged_graph()
    analyze(s, d, 3000, kind="bridges", device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        analyze(s, d, 3000, kind="bridges", device=cuda)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    copies = sorted(n for n in names if "HtoD" in n)
    print(f"\nhost-to-card copies in the profile: {copies}")
    assert any("Pinned -> Device" in n for n in copies)
    assert not any("Pageable" in n for n in copies)
