"""Port parity of SASRec training on the CPU: the optimizer substrate
(``repro_torch.optim``), the loss and its gradients, the train step of
``make_recsys_steps`` and a restart through ``CheckpointManager`` across
the packages, against the JAX package (``par=None``), at the smoke config
(2,048 items, d = 16, 2 blocks, sequence 12); the data pipelines; the
partition specs.

Tolerances, measured before they were set:

* float32 reductions (the loss, the gradients, the global norm) sum in
  another order in XLA than in ATen: scalars within 1e-5 relative, tensor
  leaves within 1e-5 of the leaf's largest magnitude (the train step's
  moments after 6 steps differ by at most 9.4e-7 of it);
* params and master weights after train steps, besides that, by 1% of the
  lr summed over the steps: AdamW divides each element's first moment by
  the root of its second, so where an element's gradient nearly cancels
  (two positions' terms in one table row) the reordered sums' rounding
  moves that element's step by a share of the lr (6.0e-6 after 6 steps
  whose lr sums to 4.5e-3, in ``item_emb``);
* the schedule, the int8 compression and AdamW's elementwise update on
  equal inputs: within one float32 rounding (1e-7 relative); the step
  counter equal as an int32; the data pipelines and specs equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import sasrec as j_sasrec
from repro.data import pipeline as j_pipeline
from repro.models import recsys as j_rec
from repro.models.transformer import Parallelism as JParallelism
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.optim import schedule as j_schedule
from repro.training.steps import make_recsys_steps as j_make_steps
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import sasrec
from repro_torch.data import pipeline
from repro_torch.models import recsys as rec
from repro_torch.models.transformer import Parallelism
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    global_norm,
)
from repro_torch.optim.adamw import zero1_specs
from repro_torch.optim.tree import tree_leaves, tree_unflatten
from repro_torch.training import make_recsys_steps

from _hyp import given, st

CFG, J_CFG = sasrec.SMOKE, j_sasrec.SMOKE
#: relative tolerance of reduced scalars; of a leaf against its largest
#: magnitude
RTOL, LEAF_TOL = 1e-5, 1e-5
BATCH = 8


def _jax_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_trees_close(got, want, tol=LEAF_TOL, atol=0.0) -> None:
    """The port's tree (tensors) against the JAX package's, leaf by leaf in
    ``jax.tree.leaves``' order: shapes and dtypes equal, integer leaves
    equal, float leaves within ``tol`` of the leaf's largest magnitude plus
    ``atol``."""
    got, want = tree_leaves(interop.to_numpy(got)), _jax_leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype and np.array_equal(g, w), i
            continue
        w = w.astype(np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float32) - w).max())
        assert err <= tol * scale + atol, (i, err, scale)


def _assert_training_close(params, opt, jparams, jopt, lr_sum) -> None:
    """Params and optimizer state after train steps: the moments and the
    counter as ``_assert_trees_close``; params and master with 1% of the
    summed lr besides (the module's docstring says why)."""
    _assert_trees_close({k: opt[k] for k in ("m", "v", "step")},
                        {k: jopt[k] for k in ("m", "v", "step")})
    _assert_trees_close({"params": params, "master": opt["master"]},
                        {"params": jparams, "master": jopt["master"]},
                        atol=0.01 * lr_sum)


def _scalars_close(got: dict, want: dict, keys=("loss", "grad_norm", "lr")):
    for key in keys:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's smoke weights and the port's copy of them."""
    jparams = j_rec.init_sasrec(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, interop.sasrec_params_from_numpy(tree, CFG, device="cpu")


def _batch(step: int, seed: int = 0) -> dict:
    return pipeline.recsys_batches(CFG.n_items, BATCH, CFG.seq_len,
                                   seed=seed)(step)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10_000),
                                          (7, 7)])
def test_cosine_schedule_matches_jax(warmup, total):
    steps = [0, 1, 3, 5, 6, 7, 9, 10, 11, 50, 99, 100, 150, 10_000, 20_000]
    for step in steps:
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              warmup=warmup, total=total)
        want = j_schedule.cosine_schedule(jnp.asarray(step, jnp.int32),
                                          warmup=warmup, total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                                   atol=1e-7, err_msg=str(step))


def test_cosine_schedule_shape():
    """``tests/test_substrates.py``'s points."""
    def s(t):
        return float(cosine_schedule(torch.tensor(t), warmup=10, total=100))

    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 1e-6
    assert s(50) < 1.0
    assert abs(s(100) - 0.1) < 1e-6  # min_ratio floor
    assert s(5) == pytest.approx(0.5, rel=1e-3)


# ---------------------------------------------------------------- adamw
def _tree(rng, dtype=np.float32) -> dict:
    """A tree whose dict keys are not in sorted order."""
    return {"w": rng.normal(size=(4, 5)).astype(dtype),
            "blocks": [{"z": rng.normal(size=3).astype(dtype),
                        "a": rng.normal(size=(2, 2)).astype(dtype)}],
            "b": rng.normal(size=6).astype(dtype)}


def _to_torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype), tree)


def test_tree_leaves_follow_jax_order():
    tree = _tree(np.random.default_rng(0))
    got = tree_leaves(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    assert all(a is b for a, b in zip(got, want))


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(1))
    got = global_norm(_to_torch(tree))
    want = j_adamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_adamw_config_and_init_match_jax():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        j_adamw.AdamWConfig())
    tree = _tree(np.random.default_rng(2))
    state = adamw_init(_to_torch(tree, torch.bfloat16))
    want = j_adamw.adamw_init(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert all(x.dtype == torch.float32 for key in ("master", "m", "v")
               for x in tree_leaves(state[key]))
    _assert_trees_close(state, want, tol=0)


@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, clip):
    """Three updates on a tree (bfloat16 params keep a float32 master),
    the lr scale changing, the gradient norm under the clip or far above
    it."""
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    params = _to_torch(tree, tdt)
    jstate, state = j_adamw.adamw_init(jparams), adamw_init(params)
    cfg, jcfg = AdamWConfig(lr=1e-2), j_adamw.AdamWConfig(lr=1e-2)
    gain = 0.05 if clip == "inactive" else 1e3
    for i, lr_scale in enumerate((0.5, 1.0, 0.25)):
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * gain).astype(np.float32),
            tree)
        jparams, jstate, jm = j_adamw.adamw_update(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g), jstate,
            jparams, jcfg, jnp.float32(lr_scale))
        params, state, m = adamw_update(_to_torch(g, tdt), state, params, cfg,
                                        torch.tensor(lr_scale))
        if clip == "active":
            assert float(jm["grad_norm"]) > cfg.grad_clip * 100
        else:
            assert float(jm["grad_norm"]) < cfg.grad_clip
        _scalars_close(m, jm, ("grad_norm", "lr"))
        _assert_trees_close(state, jstate, tol=1e-6)
        assert all(p.dtype == tdt for p in tree_leaves(params))
        # a bfloat16 param is its master rounded: equal unless the masters
        # differ across a rounding boundary, which these inputs do not
        _assert_trees_close(params, jparams, tol=1e-6)


def test_master_moves_below_bfloat16_resolution():
    """``tests/test_substrates.py``'s case in both packages: the params
    stay at 1.0 in bfloat16 while the float32 master moves, equally."""
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    jparams = {"w": jnp.ones(8, jnp.bfloat16)}
    cfg = AdamWConfig(lr=1e-5, weight_decay=0.0)
    jcfg = j_adamw.AdamWConfig(lr=1e-5, weight_decay=0.0)
    p2, state, _ = adamw_update(
        {"w": torch.full((8,), 0.001, dtype=torch.bfloat16)},
        adamw_init(params), params, cfg)
    jp2, jstate, _ = j_adamw.adamw_update(
        {"w": jnp.full((8,), 0.001, jnp.bfloat16)}, j_adamw.adamw_init(jparams),
        jparams, jcfg)
    assert p2["w"].dtype == torch.bfloat16
    assert (p2["w"].float() == 1.0).all()
    assert float(state["master"]["w"][0]) != 1.0
    assert np.array_equal(state["master"]["w"].numpy(),
                          np.asarray(jstate["master"]["w"]))


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(opt["step"]) == 150 and opt["step"].dtype == torch.int32


# ------------------------------------------------------------ the specs
def _jax_specs(tree):
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, P))


def test_zero1_specs_adds_data_axis():
    """``tests/test_substrates.py``'s case, against the reference."""
    specs = {"w": (None, "model"), "b": ("model", None)}
    z = zero1_specs(specs)
    assert z["m"]["w"] == ("data", "model")
    assert z["m"]["b"] == ("model", "data")
    assert z["master"]["w"] == ("data", "model")
    want = j_adamw.zero1_specs({"w": P(None, "model"), "b": P("model", None)})
    assert z == _jax_specs(want)


@pytest.mark.parametrize("dp_size", [None, 3, 4, 64])
def test_param_specs_and_zero1_of_sasrec_match_jax(dp_size):
    par = Parallelism(mesh=None, dp_axes=("data",), tp_axis="model")
    jpar = JParallelism(mesh=None, dp_axes=("data",), tp_axis="model")
    specs, jspecs = rec.param_specs(CFG, par), j_rec.param_specs(J_CFG, jpar)
    assert specs == _jax_specs(jspecs)
    shapes = jax.eval_shape(lambda: j_rec.init_sasrec(
        J_CFG, jax.random.PRNGKey(0)))
    params = rec.init_sasrec(CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    got = zero1_specs(specs, "data", params if dp_size else None, dp_size)
    want = j_adamw.zero1_specs(jspecs, "data", shapes if dp_size else None,
                               dp_size)
    assert got == _jax_specs(want)


# ---------------------------------------------------------- compression
@given(st.integers(0, 500))
def test_int8_compression_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=64).astype(np.float32) * rng.uniform(1e-3, 1e3)
    err = rng.normal(size=64).astype(np.float32) * 1e-3
    for e in (None, err):
        q, scale, new_err = compress_int8(
            torch.from_numpy(g), None if e is None else torch.from_numpy(e))
        jq, jscale, jerr = j_comp.compress_int8(
            jnp.asarray(g), None if e is None else jnp.asarray(e))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(scale.numpy(), np.asarray(jscale))
        deq = decompress_int8(q, scale)
        assert np.array_equal(deq.numpy(),
                              np.asarray(j_comp.decompress_int8(jq, jscale)))
        np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr),
                                   rtol=0, atol=float(scale) * 2.0 ** -16)
        # the error feeds back exactly what the int8 grid lost
        gf = g + (0 if e is None else e)
        assert float(np.abs(gf - deq.numpy()).max()) <= float(scale) * 0.51


def test_round_half_to_even_as_jax():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, scale, _ = compress_int8(g)
    jq, _, _ = j_comp.compress_int8(jnp.asarray(g.numpy()))
    assert float(scale) == 1.0
    assert q.tolist() == np.asarray(jq).tolist() == [0, 2, 2, 0, -2, 127]


# ------------------------------------------------------- loss and step
def test_sasrec_train_loss_and_gradients_match_jax(weights):
    jparams, params = weights
    b = _batch(0)
    assert (b["pos"] == 0).any()  # padding is exercised
    want, jgrads = jax.value_and_grad(j_rec.sasrec_train_loss)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}, J_CFG)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = rec.sasrec_train_loss(tree_unflatten(params, leaves), b, CFG)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    _assert_trees_close(tree_unflatten(params, grads), jgrads)


def test_sasrec_train_loss_of_an_all_padding_batch_is_zero(weights):
    _, params = weights
    z = np.zeros((2, CFG.seq_len), np.int32)
    loss = rec.sasrec_train_loss(params, {"seq": z, "pos": z, "neg": z}, CFG)
    assert float(loss) == 0.0


def _run_jax(jparams, steps, start=0, jopt=None, **kw):
    step = jax.jit(j_make_steps(J_CFG, None, **kw)["train"])
    jopt = j_adamw.adamw_init(jparams) if jopt is None else jopt
    metrics = []
    for i in range(start, steps):
        jparams, jopt, m = step(jparams, jopt, {
            k: jnp.asarray(v) for k, v in _batch(i).items()})
        metrics.append(m)
    return jparams, jopt, metrics


def _run_port(params, steps, start=0, opt=None, **kw):
    step = make_recsys_steps(CFG, **kw)["train"]
    opt = adamw_init(params) if opt is None else opt
    metrics = []
    for i in range(start, steps):
        params, opt, m = step(params, opt, _batch(i))
        metrics.append(m)
    return params, opt, metrics


@pytest.mark.parametrize("schedule", [{}, {"warmup": 2, "total_steps": 20}])
def test_train_step_matches_jax_for_five_steps(weights, schedule):
    """Five steps of ``make_recsys_steps(cfg)["train"]`` against
    ``jax.jit`` of the reference's: loss, grad_norm and lr each step; every
    param and optimizer-state leaf after; the step counter equal. The
    default schedule (warmup 100) and a short one whose lr moves the
    params."""
    jparams, params = weights
    jp, jo, jm = _run_jax(jparams, 5, **schedule)
    p, o, m = _run_port(params, 5, **schedule)
    assert float(m[0]["lr"]) == 0.0  # the step is read before the increment
    for got, want in zip(m, jm):
        _scalars_close(got, want)
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 5
    _assert_training_close(p, o, jp, jo, sum(float(x["lr"]) for x in jm))
    if schedule:
        moved = float((p["blocks"][0]["wq"] - params["blocks"][0]["wq"])
                      .abs().max())
        assert moved > 1e-3  # the comparison has teeth


def test_checkpoint_restart_crosses_packages(weights, tmp_path):
    """JAX saves ``{"params", "opt"}`` at step 3, the port restores it and
    runs to step 6; the port saves at step 3, JAX restores and runs to 6.
    Each equals the other package's uninterrupted run."""
    jparams, params = weights
    kw = {"warmup": 2, "total_steps": 20}
    jp3, jo3, _ = _run_jax(jparams, 3, **kw)
    JaxManager(tmp_path / "jax").save(3, {"params": jp3, "opt": jo3})
    p3, o3, _ = _run_port(params, 3, **kw)
    CheckpointManager(tmp_path / "torch").save(3, {"params": p3, "opt": o3})
    jp6, jo6, jm = _run_jax(jparams, 6, **kw)
    p6, o6, _ = _run_port(params, 6, **kw)
    lr_sum = sum(float(x["lr"]) for x in jm)

    skeleton = jax.tree_util.tree_map(np.asarray, {"params": jp3, "opt": jo3})
    step, tree = CheckpointManager(tmp_path / "jax").restore(skeleton)
    assert step == 3
    rp = interop.sasrec_params_from_numpy(tree["params"], CFG, device="cpu")
    ro = interop.adamw_state_from_numpy(tree["opt"], rp, device="cpu")
    assert ro["step"].dtype == torch.int32 and int(ro["step"]) == 3
    rp, ro, _ = _run_port(rp, 6, start=3, opt=ro, **kw)
    _assert_training_close(rp, ro, jp6, jo6, lr_sum)

    step, tree = JaxManager(tmp_path / "torch").restore(skeleton)
    assert step == 3
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    jrp, jro, _ = _run_jax(tree["params"], 6, start=3, jopt=tree["opt"], **kw)
    _assert_training_close(p6, o6, jrp, jro, lr_sum)


def test_entry_points_raise_without_a_card(weights, monkeypatch):
    """Without a card, and without ``device="cpu"``, nothing quietly runs
    on the CPU."""
    jparams, params = weights
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    opt = jax.tree_util.tree_map(np.asarray, j_adamw.adamw_init(jparams))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: rec.init_sasrec(CFG, torch.Generator().manual_seed(0)),
            lambda: interop.sasrec_params_from_numpy(tree, CFG),
            lambda: interop.adamw_state_from_numpy(opt, params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state = interop.adamw_state_from_numpy(opt, params, device="cpu")
    assert state["m"]["item_emb"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        interop.adamw_state_from_numpy(opt, {**params, "pos_emb": params[
            "pos_emb"][:3]}, device="cpu")


# -------------------------------------------------------- the pipelines
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_tokens_are_copies(step):
    mine = pipeline.SyntheticTokens(vocab=64, batch=3, seq=9, seed=9)
    theirs = j_pipeline.SyntheticTokens(vocab=64, batch=3, seq=9, seed=9)
    a, b = mine.batch_at(step)["tokens"], theirs.batch_at(step)["tokens"]
    assert a.dtype == np.int32 and a.shape == (3, 10)
    assert np.array_equal(a, b)
    it = iter(mine)
    assert np.array_equal(next(it)["tokens"], theirs.batch_at(0)["tokens"])


def test_graph_batches_are_copies():
    mine = pipeline.GraphBatches(50, 200, 4, 3, seed=2).batch_at(5)
    theirs = j_pipeline.GraphBatches(50, 200, 4, 3, seed=2).batch_at(5)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype, key
        assert np.array_equal(mine[key], theirs[key]), key


def test_prefetcher_orders_batches_as_the_reference():
    ds = pipeline.SyntheticTokens(vocab=32, batch=2, seq=4, seed=1)
    mine = pipeline.Prefetcher(ds.batch_at, start_step=5)
    theirs = j_pipeline.Prefetcher(ds.batch_at, start_step=5)
    try:
        for (s1, b1), (s2, b2) in zip(
                [next(iter(mine)) for _ in range(4)],
                [next(iter(theirs)) for _ in range(4)]):
            assert s1 == s2
            assert np.array_equal(b1["tokens"], b2["tokens"])
    finally:
        mine.close()
        theirs.close()
    mine.t.join(timeout=5)
    assert not mine.t.is_alive()
