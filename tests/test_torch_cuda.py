"""The Hopper kernels on the card: each against its plain version, bit for
bit (tolerance 0: integer outputs), and the port's pipeline on the card
against the same pipeline on the CPU. These tests need an NVIDIA card; the
``cuda`` fixture skips them where there is none. On the card:

    python -m pytest -m gpu tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import find_bridges
from repro_torch.core.api import pad_graph
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph import generators as gen
from repro_torch.kernels import cuda_lib, launch_counts, reset_launch_counts
from repro_torch.kernels.boruvka_round import boruvka_round
from repro_torch.kernels.boruvka_round.ref import boruvka_round_ref
from repro_torch.kernels.segment_min import segment_min
from repro_torch.kernels.segment_min.ref import segment_min_ref

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
    fn = make_analysis_fn(cpu_el.n_nodes, final)
    for a, b in zip(fn(cpu_el.src, cpu_el.dst, cpu_el.mask),
                    fn(gpu_el.src, gpu_el.dst, gpu_el.mask)):
        assert torch.equal(a, b.cpu())
    for sc in gen.failure_scenarios():
        got = find_bridges(sc["src"], sc["dst"], sc["n"], final=final)
        assert got == sc["bridges"] == bridges_dfs(sc["src"], sc["dst"], sc["n"])
    assert find_bridges(s, d, 3000, final=final) == planted
