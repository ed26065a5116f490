"""Port parity of the graph networks on the CPU: ``repro_torch.models.gnn``
and ``repro_torch.data.sampler`` against ``repro.models.gnn`` and
``repro.data.sampler``, on the smoke configs of the four archs.

The graph is ``gen.random_graph(40, 120)`` on 44 nodes (four with no
edge), padded to 160 slots whose masked ids are -1, -6, n, 2n and in-range
ids; every incoming edge of node 5 is masked and two real edges too. So the
gather's wrap and clamp, the segment ops' drops, an empty segment's ±inf
and an all-masked node's ``finfo`` extremes are all exercised. PNA is held
on the same buffer with node 5's edges left unmasked: in the reference an
all-masked node's ``finfo.min`` times the attenuation scaler is -inf, and
the forward turns NaN from there (a test holds the NaN rows equal). The
same numpy inputs and weights (JAX's ``init_gnn`` at key 0) go to both
packages.

Tolerances, each the largest |port - JAX| over the output's largest
magnitude: 1e-5 in float32 (the two libraries sum in other orders;
measured at most 2.1e-7), but 5e-4 for PNA (measured 6.4e-5): its std aggregator sqrt(sq - mean^2 + 1e-6) amplifies the
rounding of sq - mean^2 by up to 500, and its attenuation scaler
multiplies a node of degree 0 by 2.5e6, so JAX's own eager and jitted
forwards differ by 3e-5 of the scale here and each float32 forward lies
7e-5 to 9e-5 from a float64 one. The sampler, the segment max and min and
the configs: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get as j_get
from repro.data.sampler import NeighborSampler as JSampler
from repro.graph import generators as gen
from repro.models import gnn as J
from repro_torch.configs import get as t_get
from repro_torch.data import NeighborSampler as TSampler
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.models import gnn as T
from repro_torch.optim.tree import tree_leaves, tree_unflatten

ARCHS = ["graphsage_reddit", "pna", "egnn", "gatedgcn"]
N, CAP = 44, 160
TOL = {"graphsage": 1e-5, "pna": 5e-4, "egnn": 1e-5, "gatedgcn": 1e-5}
#: the graphs of the batched mode: G graphs of NB nodes and EB edge slots
G, NB, EB = 3, 12, 30


def padded_edges(seed: int = 0, n: int = N, cap: int = CAP,
                 all_masked: bool = True):
    """(src, dst, mask) int32/bool[cap]: random_graph(40, 120) padded
    with masked slots of out-of-range and wrapping ids; with
    ``all_masked``, every incoming edge of node 5 masked."""
    rng = np.random.default_rng(seed)
    src, dst = gen.random_graph(40, 120, seed=seed)
    e = len(src)
    junk = np.array([-1, -6, n, 2 * n, 3, 7], np.int32)
    src = np.concatenate([src, rng.choice(junk, cap - e)]).astype(np.int32)
    dst = np.concatenate([dst, rng.choice(junk[::-1], cap - e)]).astype(
        np.int32)
    mask = np.arange(cap) < e
    if all_masked:
        mask[dst == 5] = False  # node 5: every incoming edge masked
    mask[[2, 11]] = False
    return src, dst, mask


def graph_inputs(cfg, seed: int = 0, all_masked=None) -> dict:
    """A full-graph batch for ``cfg``'s arch, as numpy arrays; node 5's
    incoming edges all masked unless the arch is PNA (or ``all_masked``
    says otherwise)."""
    rng = np.random.default_rng(seed + 100)
    if all_masked is None:
        all_masked = cfg.arch != "pna"
    src, dst, mask = padded_edges(seed, all_masked=all_masked)
    g = {"src": src, "dst": dst, "mask": mask}
    if cfg.arch == "egnn":
        g.update(h=rng.standard_normal((N, cfg.d_feat)).astype(np.float32),
                 x=rng.standard_normal((N, 3)).astype(np.float32),
                 target=np.full((1,), 0.5, np.float32))
    else:
        g.update(feats=rng.standard_normal((N, cfg.d_feat)).astype(
                     np.float32),
                 labels=rng.integers(0, cfg.n_classes, N).astype(np.int32),
                 label_mask=rng.random(N) < 0.7)
    return g


def batched_inputs(cfg, seed: int = 0) -> dict:
    """G stacked graphs (each its own random multigraph with masked slots
    of ids -1 and NB) and a target per graph. Random real edges are masked
    too, except for PNA (a node left with masked edges only turns its
    forward NaN)."""
    rng = np.random.default_rng(seed + 200)
    src = rng.integers(0, NB, (G, EB)).astype(np.int32)
    dst = rng.integers(0, NB, (G, EB)).astype(np.int32)
    mask = (rng.random((G, EB)) < 0.8) | (cfg.arch == "pna")
    src[:, -3:], dst[:, -3:], mask[:, -3:] = -1, NB, False
    dst[:, -4] = NB + 2  # a real edge whose dst the segment ops drop
    graphs = {"src": src, "dst": dst, "mask": mask}
    feats = rng.standard_normal((G, NB, cfg.d_feat)).astype(np.float32)
    if cfg.arch == "egnn":
        graphs.update(h=feats, x=rng.standard_normal((G, NB, 3)).astype(
            np.float32))
    else:
        graphs["feats"] = feats
    return {"graphs": graphs,
            "targets": rng.standard_normal(G).astype(np.float32)}


def sampled_inputs(cfg, seed: int = 0, b: int = 8) -> dict:
    rng = np.random.default_rng(seed + 300)
    f1, f2 = cfg.sample_sizes
    m1 = rng.random((b, f1)) < 0.8
    m1[0] = False  # a seed with no neighbour
    return {"x0": rng.standard_normal((b, cfg.d_feat)).astype(np.float32),
            "x1": rng.standard_normal((b, f1, cfg.d_feat)).astype(np.float32),
            "x2": rng.standard_normal((b, f1, f2, cfg.d_feat)).astype(
                np.float32),
            "m1": m1, "m2": (rng.random((b, f1, f2)) < 0.7) & m1[:, :, None],
            "labels": rng.integers(0, cfg.n_classes, b).astype(np.int32)}


def weights(arch: str):
    """(JAX's config and params, the port's config and params) from one
    draw: JAX's ``init_gnn`` at key 0."""
    jc, tc = j_get(arch).smoke_config, t_get(arch).smoke_config
    jp = J.init_gnn(jc, jax.random.PRNGKey(0))
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    return jc, jp, tc, tp


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def close(got, want, tol: float) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


# ------------------------------------------------------------------ sampler
def _sampler_pair(n=200, m=1500, d=8, seed=1):
    src, dst = gen.random_graph(n, m, seed=0)
    feats = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    return (JSampler(src, dst, n, feats, seed=seed),
            TSampler(src, dst, n, feats, seed=seed))


@pytest.mark.parametrize("fanouts", [(5, 3), (20, 25)])
def test_sampler_batches_bit_for_bit(fanouts):
    """Every array of ``batch_at`` equal for three steps, at fan-outs under
    and over the degrees (both sampling branches); the CSR equal."""
    js, ts = _sampler_pair()
    np.testing.assert_array_equal(js.indptr, ts.indptr)
    np.testing.assert_array_equal(js.indices, ts.indices)
    labels = np.arange(200) % 5
    for step in range(3):
        a = js.batch_at(step, batch_nodes=16, fanouts=fanouts, labels=labels)
        b = ts.batch_at(step, batch_nodes=16, fanouts=fanouts, labels=labels)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sampler_isolated_nodes_are_masked():
    """Nodes with no edge: zero ids and a False mask, in both."""
    src, dst = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    feats = np.eye(6, dtype=np.float32)
    a = JSampler(src, dst, 6, feats).batch_at(0, 32, (2, 2), np.zeros(6))
    b = TSampler(src, dst, 6, feats).batch_at(0, 32, (2, 2), np.zeros(6))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not b["m1"].all()


def test_neighbor_sampler_shapes_and_validity():
    """``tests/test_substrates.py``'s sampler test through the port."""
    src, dst = gen.random_graph(200, 1500, seed=0)
    feats = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    labels = np.arange(200) % 5
    s = TSampler(src, dst, 200, feats, seed=1)
    batch = s.batch_at(0, batch_nodes=16, fanouts=(5, 3), labels=labels)
    assert batch["x1"].shape == (16, 5, 8)
    assert batch["x2"].shape == (16, 5, 3, 8)
    assert batch["m2"].shape == (16, 5, 3)
    b2 = s.batch_at(0, batch_nodes=16, fanouts=(5, 3), labels=labels)
    np.testing.assert_array_equal(batch["x1"], b2["x1"])


# -------------------------------------------------------------- aggregation
def _agg_inputs(d=6):
    src, dst, mask = padded_edges()
    h = np.random.default_rng(7).standard_normal((N, d)).astype(np.float32)
    return h, src, dst, mask


def test_segment_mean_matches_reference():
    """Masked slots, dropped ids (-1, -6, n, 2n), nodes with no edge and
    node 5 with only masked ones: the means and the counts."""
    h, src, dst, mask = _agg_inputs()
    vals = h[np.clip(np.where(src < 0, src + N, src), 0, N - 1)]
    jm, jc = J.segment_mean(jnp.asarray(vals), jnp.asarray(dst), N,
                            jnp.asarray(mask))
    tm, tc = T.segment_mean(torch.from_numpy(vals), torch.from_numpy(dst), N,
                            torch.from_numpy(mask))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc[5] == 0 and (tc[40:] == 0).all()


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_gather_scatter_matches_reference(reduce):
    """``gather_scatter`` on the padded buffer: node 5 (all incoming edges
    masked) keeps ``finfo.min``/``finfo.max`` under max/min, the nodes
    with no edge read 0."""
    h, src, dst, mask = _agg_inputs()
    want = np.asarray(J.gather_scatter(jnp.asarray(h), jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(mask),
                                       N, reduce))
    got = T.gather_scatter(torch.from_numpy(h), torch.from_numpy(src),
                           torch.from_numpy(dst), torch.from_numpy(mask), N,
                           reduce).numpy()
    if reduce == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        ext = np.finfo(np.float32).min if reduce == "max" else \
            np.finfo(np.float32).max
        assert (got[5] == ext).all()
        assert (got[40:] == 0).all()


def test_gather_wraps_once_then_clamps():
    """ids -1, 5, 7, -6, -9 over 5 rows read rows 4, 4, 4, 0, 0, as
    JAX's gather does; a segment sum drops -1 and 5."""
    h = np.arange(5, dtype=np.float32)[:, None]
    ids = np.array([-1, 5, 7, -6, -9], np.int32)
    want = np.asarray(jnp.asarray(h)[jnp.asarray(ids)])
    got = T.gather_scatter(torch.from_numpy(h), torch.from_numpy(ids),
                           torch.arange(5), torch.ones(5, dtype=torch.bool),
                           5)
    np.testing.assert_array_equal(want[:, 0], [4, 4, 4, 0, 0])
    np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])
    sums = T.gather_scatter(torch.from_numpy(h), torch.arange(5),
                            torch.tensor([-1, 5, 0, 0, 4]),
                            torch.ones(5, dtype=torch.bool), 5)
    np.testing.assert_array_equal(sums.numpy()[:, 0], [5, 0, 0, 0, 4])


def test_layer_norm_uses_the_population_variance():
    x = np.random.default_rng(3).standard_normal((7, 30)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal(30).astype(np.float32)
    want = np.asarray(J._ln(jnp.asarray(x), jnp.asarray(w)))
    got = T._ln(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    close(got, want, 1e-6)


# ----------------------------------------------------------------- forwards
@pytest.mark.parametrize("arch", ARCHS)
def test_full_graph_forward_matches_reference(arch):
    jc, jp, tc, tp = weights(arch)
    g = graph_inputs(jc)
    if jc.arch == "egnn":
        jpred, jx = J.egnn_forward(jp, jnp_tree(g), jc)
        tpred, tx = T.egnn_forward(tp, g, tc)
        close(tpred, jpred, TOL["egnn"])
        close(tx, jx, TOL["egnn"])
        return
    want = J.FORWARDS[jc.arch](jp, jnp_tree(g), jc)
    close(T.FORWARDS[tc.arch](tp, g, tc), want, TOL[jc.arch])


def test_pna_all_masked_node_turns_nan_in_both():
    """Node 5 with only masked incoming edges: its max is ``finfo.min``,
    times the attenuation scaler of a degree-0 node -inf, and PNA's output
    holds NaN in the same rows on both sides; the finite rows agree."""
    jc, jp, tc, tp = weights("pna")
    g = graph_inputs(jc, all_masked=True)
    want = np.asarray(J.pna_forward(jp, jnp_tree(g), jc))
    got = T.pna_forward(tp, g, tc).detach().numpy()
    nan = np.isnan(want)
    assert nan[5].all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    close(got[~nan.any(1)], want[~nan.any(1)], TOL["pna"])


def test_sampled_forward_matches_reference():
    jc, jp, tc, tp = weights("graphsage_reddit")
    batch = sampled_inputs(jc)
    want = J.graphsage_sampled_forward(jp, jnp_tree(batch), jc)
    close(T.graphsage_sampled_forward(tp, batch, tc), want, TOL["graphsage"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_forward_matches_vmap(arch):
    """The disjoint union against ``jax.vmap`` over the graphs: egnn's
    batch loss and per-graph predictions, the other archs' mean-pooled
    logits (``make_gnn_train_step``'s batched mode)."""
    jc, jp, tc, tp = weights(arch)
    batch = batched_inputs(jc)
    jb = jnp_tree(batch)
    if jc.arch == "egnn":
        want = jax.vmap(lambda g: J.egnn_forward(jp, g, jc)[0])(jb["graphs"])
        got = torch.stack([T.egnn_forward(tp, {k: v[i] for k, v in
                                               batch["graphs"].items()},
                                          tc)[0] for i in range(G)])
        close(got, want, TOL["egnn"])
        np.testing.assert_allclose(
            T.egnn_batch_loss(tp, batch, tc).item(),
            float(J.egnn_batch_loss(jp, jb, jc)), rtol=1e-5)
        return
    want = jax.vmap(lambda g: jnp.mean(J.FORWARDS[jc.arch](jp, g, jc),
                                       axis=0))(jb["graphs"])
    close(T.batched_pooled_logits(tp, batch["graphs"], tc), want,
          TOL[jc.arch])


@pytest.mark.parametrize("arch", ["graphsage_reddit", "pna", "gatedgcn"])
def test_node_classification_loss_matches_reference(arch):
    jc, jp, tc, tp = weights(arch)
    g = graph_inputs(jc)
    want = float(J.node_classification_loss(jp, jnp_tree(g), jc))
    got = T.node_classification_loss(tp, g, tc).item()
    np.testing.assert_allclose(got, want, rtol=TOL[jc.arch])


def test_init_draws_the_reference_shapes():
    """``init_gnn``'s tree (keys, list lengths, shapes, dtypes) is the
    reference's for every arch."""
    for arch in ARCHS:
        jc, jp, tc, _ = weights(arch)
        tp = T.init_gnn(tc, torch.Generator().manual_seed(0), device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jp)
        tl = tree_leaves(tp)
        assert len(jl) == len(tl)
        for (_, a), b in zip(jl, tl):
            assert tuple(b.shape) == a.shape and b.dtype == torch.float32


def test_graphsage_chunked_aggregation_matches_reference(monkeypatch):
    """GraphSAGE's aggregation 7 edges at a time (``EDGE_CHUNK``; it keeps
    no messages for its backward): the forward against the reference and
    the gradient of a loss against the whole-buffer aggregation's."""
    jc, jp, tc, tp = weights("graphsage_reddit")
    g = graph_inputs(jc)

    def value_and_grad():
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        loss = T.node_classification_loss(tree_unflatten(tp, leaves), g, tc)
        return loss.item(), torch.autograd.grad(loss, leaves)

    want_loss, want_grads = value_and_grad()
    monkeypatch.setattr(T, "EDGE_CHUNK", 7)
    close(T.graphsage_forward(tp, g, tc),
          J.graphsage_forward(jp, jnp_tree(g), jc), TOL["graphsage"])
    got_loss, got_grads = value_and_grad()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for a, b in zip(got_grads, want_grads):
        close(a, b.numpy(), 1e-6)
