"""Port parity of the graph networks' training on the CPU:
``training/steps.py::make_gnn_train_step`` against ``jax.jit`` of the JAX
package's, for every arch and mode the reference has (``full`` for the
four archs, egnn's in its squared-error form; ``sampled`` for GraphSAGE;
``batched`` for the four, egnn through ``egnn_batch_loss`` and the others
through the mean-pooled logits), on the smoke configs and the padded
buffers of ``test_torch_gnn.py``; and the config registry.

One step runs from the same weights (JAX's ``init_gnn`` at key 0) and the
same AdamW state, its moments drawn at random and its counter past the
warmup, so that the step moves every element by a full, smoothly
normalised update. Tolerances: loss, grad_norm and lr within 1e-5
relative, each leaf of the params, the master weights and both moments
within 1e-5 of the leaf's largest magnitude (measured at most 7.5e-7);
PNA's within 5e-4 (measured 7.0e-5: its forward's conditioning,
``test_torch_gnn.py``'s docstring).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as j_configs
import repro_torch.configs as t_configs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import make_gnn_train_step as j_make_step
from repro_torch.interop import adamw_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import tree_leaves
from repro_torch.training import make_gnn_train_step

from test_torch_gnn import (
    batched_inputs,
    graph_inputs,
    jnp_tree,
    sampled_inputs,
    weights,
)

CASES = [("graphsage_reddit", "full"), ("pna", "full"), ("egnn", "full"),
         ("gatedgcn", "full"), ("graphsage_reddit", "sampled"),
         ("graphsage_reddit", "batched"), ("pna", "batched"),
         ("egnn", "batched"), ("gatedgcn", "batched")]
TOL = {"graphsage": 1e-5, "pna": 5e-4, "egnn": 1e-5, "gatedgcn": 1e-5}
#: the schedule of the one-step comparison: step 5 of 50 past a warmup of 2
SCHEDULE = {"total_steps": 50, "warmup": 2}
START_STEP = 5


def _inputs(cfg, mode: str) -> dict:
    if mode == "full":
        return graph_inputs(cfg)
    if mode == "sampled":
        return sampled_inputs(cfg)
    return batched_inputs(cfg)


def _state(jp, seed=0) -> dict:
    """An AdamW state of ``jp``'s structure as numpy arrays: float32 master
    weights equal to the params, m normal at 1e-3, v its square plus 1e-6,
    step ``START_STEP``."""
    rng = np.random.default_rng(seed)
    ms = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3)
                      .astype(np.float32), jp)
    return {"step": np.int32(START_STEP),
            "master": jax.tree.map(lambda p: np.asarray(p, np.float32), jp),
            "m": ms,
            "v": jax.tree.map(lambda a: (a * a + 1e-6).astype(np.float32),
                              ms)}


def _leaves_close(got, want, tol) -> None:
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= tol * scale


@pytest.mark.parametrize("arch,mode", CASES)
def test_train_step_matches_reference(arch, mode):
    """One step from the same weights and state: loss, grad_norm, lr,
    every param leaf, the master weights, both moments and the counter."""
    jc, jp, tc, tp = weights(arch)
    tol = TOL[jc.arch]
    state = _state(jp)
    topt = adamw_state_from_numpy(state, tp, device="cpu")
    batch = _inputs(jc, mode)
    jstep = jax.jit(j_make_step(jc, None, mode, JAdamWConfig(lr=1e-3),
                                **SCHEDULE))
    jp1, jo1, jm = jstep(jp, jax.tree.map(jnp.asarray, state),
                         jnp_tree(batch))
    tp1, to1, tm = make_gnn_train_step(tc, None, mode, AdamWConfig(lr=1e-3),
                                       **SCHEDULE)(tp, topt, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert np.isfinite(float(jm[key])), key
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=max(tol, 1e-5), err_msg=key)
    assert float(jm["lr"]) > 0
    assert int(to1["step"]) == int(jo1["step"]) == START_STEP + 1
    _leaves_close(tp1, jp1, tol)
    for key in ("master", "m", "v"):
        _leaves_close(to1[key], jo1[key], tol)
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(tp1), tree_leaves(tp)))
    assert moved > 1e-4  # the comparison has teeth


@pytest.mark.parametrize("arch", ["graphsage_reddit", "pna", "egnn",
                                  "gatedgcn"])
def test_loss_falls_over_five_steps(arch):
    """``tests/test_arch_smoke.py::test_gnn_smoke_full_graph`` through the
    port: its own weights (a seeded generator), one graph five times from
    zero moments; the loss is finite and falls."""
    from repro_torch.models import gnn
    from repro_torch.optim import adamw_init

    cfg = t_configs.get(arch).smoke_config
    params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    opt = adamw_init(params)
    step = make_gnn_train_step(cfg, None, "full", AdamWConfig(lr=1e-2),
                               total_steps=10, warmup=1)
    batch = graph_inputs(cfg, all_masked=False)
    losses = []
    for _ in range(6):
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[1]  # step 0 has an lr of 0
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))


def test_registry_matches_reference():
    """``ARCH_IDS``, ``all_specs()`` (eleven, in order) and ``GNN_SHAPES``
    equal to the reference's; each GNN spec's configs field for field."""
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert len(t_configs.ARCH_IDS) == 11
    specs = t_configs.all_specs()
    assert [s.arch_id for s in specs] == j_configs.ARCH_IDS
    assert t_configs.GNN_SHAPES == j_configs.GNN_SHAPES
    for t_spec in specs:
        j_spec = j_configs.get(t_spec.arch_id)
        assert t_spec.family == j_spec.family
        assert t_spec.shapes == j_spec.shapes
        if t_spec.family == "gnn":
            for attr in ("config", "smoke_config"):
                assert vars(getattr(t_spec, attr)) == \
                    vars(getattr(j_spec, attr)), (t_spec.arch_id, attr)
            assert t_spec.notes == j_spec.notes
    for arch in ("graphsage_reddit", "pna", "egnn", "gatedgcn"):
        jm = __import__(f"repro.configs.{arch}", fromlist=["config_for"])
        tm = __import__(f"repro_torch.configs.{arch}",
                        fromlist=["config_for"])
        assert vars(tm.config_for(32, 5)) == vars(jm.config_for(32, 5))
