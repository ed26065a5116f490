"""Training and serving over a mesh of ``DTensor`` parameters, against the
JAX package's jitted steps.

Eight spawned CPU ranks (``tests/torch_mesh_train_world.py``) on a (data
4, model 2) mesh hold the weights as ``DTensor``s: a language model's
placed by ``param_specs`` (the heads, the FFN and the vocabulary split
over ``model``) with its AdamW state placed by ``zero1_specs``; a graph
network's replicated, with the edge buffers split over both axes. The
same numpy weights, tokens, graphs and AdamW state go through the
reference's functions without a mesh, in this process:

- each dense smoke config: ``lm_loss`` and its gradient, and one
  ``make_lm_train_step`` step (params, master, m, v and the metrics),
  and the donated step from the same inputs against the pure one, bit for
  bit;
- qwen3-0.6B's smoke config: one prefill into a 20-position cache, and
  one decode step on it (the logits and both caches);
- each graph network's smoke config: the full-graph loss, its gradient and
  one ``make_gnn_train_step`` step.

Tolerances (float32; the mesh sums in other orders than XLA: the
vocabulary-parallel cross entropy, the partial gradients' reductions, the
segment sums over eight edge blocks): the losses and the metrics within
1e-5 relative; every gradient leaf and every updated leaf within 1e-4 of
that leaf's largest magnitude (PNA's 1e-3, ``torch_gnn_cases.
GNN_CHECK_TOL``: its std aggregator sqrt(sq - mean^2 + 1e-6) amplifies a
rounding by up to 500, and the port on one device already differs from
the jitted reference by 1.03e-4 there); the logits and caches within 1e-5
of their largest magnitude.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

import torch_mesh_train_world as world_mod
from repro.configs import get
from repro.models import gnn as j_gnn
from repro.models import transformer as j_tfm
from repro.optim import AdamWConfig
from repro.optim.adamw import adamw_init
from repro.training import (
    make_gnn_train_step,
    make_lm_decode_step,
    make_lm_prefill_step,
    make_lm_train_step,
)
from repro_torch.interop import to_numpy
from repro_torch.models import gnn as t_gnn
from repro_torch.models import transformer as t_tfm

from torch_gnn_cases import GNN_CHECK_TOL, gnn_batch

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 240
RTOL, LEAF_TOL, SERVE_TOL = 1e-5, 1e-4, 1e-5
START_STEP = 5


def _flat(tree, prefix):
    return world_mod.flat(jax.tree.map(np.asarray, tree), prefix)


def _lm_inputs(name, i, data):
    """The weights (the port's ``init_params``, drawn by torch from seed
    ``i``), tokens and an AdamW state past the warmup, as numpy."""
    cfg = get(name).smoke_config
    params = to_numpy(t_tfm.init_params(
        world_mod.get(name).smoke_config,
        torch.Generator().manual_seed(i), device="cpu"))
    rng = np.random.default_rng(i)
    tokens = rng.integers(0, cfg.vocab, (world_mod.B, world_mod.S + 1),
                          dtype=np.int32)
    m = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3)
                     .astype(np.float32), params)
    state = {"step": np.int32(START_STEP),
             "master": jax.tree.map(lambda p: p.astype(np.float32), params),
             "m": m, "v": jax.tree.map(lambda x: x * x + 1e-6, m)}
    data.update(_flat(params, f"{name}/params"))
    data[f"{name}/tokens"] = tokens
    data[f"{name}/opt/step"] = state["step"]
    for k in ("master", "m", "v"):
        data.update(_flat(state[k], f"{name}/opt/{k}"))
    return cfg, params, tokens, state


def _lm_reference(name, cfg, params, tokens, state, want):
    par = j_tfm.Parallelism.none()
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_tfm.lm_loss(p, batch, cfg, par)))(params)
    want[f"{name}/loss"] = np.asarray(loss)
    want.update(_flat(grads, f"{name}/grads"))
    step = make_lm_train_step(cfg, par, AdamWConfig(lr=world_mod.LR),
                              **world_mod.SCHEDULE)
    new, new_opt, metrics = jax.jit(step)(params, state, batch)
    want.update(_flat(new, f"{name}/step/params"))
    for k in ("master", "m", "v"):
        want.update(_flat(new_opt[k], f"{name}/step/opt/{k}"))
    for k, v in metrics.items():
        want[f"{name}/step/{k}"] = np.asarray(v)
    if name != world_mod.SERVE_CASE:
        return
    s = world_mod.S
    logits, cache = jax.jit(make_lm_prefill_step(cfg, par, world_mod.S_MAX))(
        params, jnp.asarray(tokens[:, :s]))
    want[f"{name}/prefill/logits"] = np.asarray(logits)
    logits, cache = jax.jit(make_lm_decode_step(cfg, par))(
        params, cache, jnp.asarray(tokens[:, s:s + 1]), jnp.int32(s + 1))
    want[f"{name}/decode/logits"] = np.asarray(logits)
    want[f"{name}/decode/k"] = np.asarray(cache[0])
    want[f"{name}/decode/v"] = np.asarray(cache[1])


def _gnn_inputs(name, i, data):
    """The weights (the port's ``init_gnn``, seed ``10 + i``) and a graph of
    40 nodes and 128 edge slots, as numpy."""
    params = to_numpy(t_gnn.init_gnn(world_mod.get(name).smoke_config,
                                     torch.Generator().manual_seed(10 + i),
                                     device="cpu"))
    g = gnn_batch(get(name).smoke_config, "full", seed=i, n=40, m=120)
    data.update(_flat(params, f"{name}/params"))
    data.update({f"{name}/graph/{k}": v for k, v in g.items()})
    return params, g


def _gnn_reference(name, params, g, want):
    cfg = get(name).smoke_config
    gj = {k: jnp.asarray(v) for k, v in g.items()}

    def loss_fn(p):
        if cfg.arch == "egnn":
            pred, _ = j_gnn.egnn_forward(p, gj, cfg)
            return jnp.mean((pred - gj["target"]) ** 2)
        return j_gnn.node_classification_loss(p, gj, cfg, None)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want[f"{name}/loss"] = np.asarray(loss)
    want.update(_flat(grads, f"{name}/grads"))
    opt = adamw_init(params)
    opt["step"] = jnp.int32(START_STEP)
    step = make_gnn_train_step(cfg, None, mode="full", **world_mod.SCHEDULE)
    new, _, metrics = jax.jit(step)(params, opt, gj)
    want.update(_flat(new, f"{name}/step/params"))
    for k, v in metrics.items():
        want[f"{name}/step/{k}"] = np.asarray(v)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the reference's results, rank 0's file)."""
    out = tmp_path_factory.mktemp("mesh_train_world")
    inputs = out / "inputs.npz"
    data, want, lm, gnn = {}, {}, {}, {}
    for i, name in enumerate(world_mod.LM_CASES):
        lm[name] = _lm_inputs(name, i, data)
    for i, name in enumerate(world_mod.GNN_CASES):
        gnn[name] = _gnn_inputs(name, i, data)
    np.savez(inputs, **data)
    wenv = dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_train_world.py"),
         "--rank", str(r), "--world", "8", "--store", str(out / "store"),
         "--inputs", str(inputs), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=wenv)
        for r in range(8)]
    errors = []
    try:
        for name, args in lm.items():  # while the ranks run
            _lm_reference(name, *args, want)
        for name, args in gnn.items():
            _gnn_reference(name, *args, want)
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return want, dict(np.load(out / "rank0.npz"))


def _close(got, want, tol, key):
    assert got.shape == want.shape, key
    scale = float(np.abs(want).max()) or 1.0
    assert float(np.abs(got - want).max()) <= tol * scale, key


def _check(want, got, prefix, skip=(), leaf_tol=LEAF_TOL):
    def keys_of(d):
        return {k for k in d if k.startswith(prefix + "/")
                and not any(part in k for part in skip)}

    keys = keys_of(want)
    assert keys and keys == keys_of(got)
    for key in keys:
        if key.endswith(("/loss", "/grad_norm", "/lr")):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=RTOL, err_msg=key)
        elif "/prefill/" in key or "/decode/" in key:
            _close(got[key], want[key], SERVE_TOL, key)
        else:
            _close(got[key], want[key], leaf_tol, key)


@pytest.mark.parametrize("name", world_mod.LM_CASES)
def test_lm_train_step_over_mesh_matches_reference(run, name):
    want, got = run
    _check(want, got, name, skip=("/prefill/", "/decode/", "/donated/"))


@pytest.mark.parametrize("name", world_mod.LM_CASES)
def test_donated_step_over_mesh_equals_pure_step(run, name):
    """The donated step (``DTensor`` leaves, ZeRO-1 state, updated in place
    a chunk at a time) writes every param, master, m and v leaf with the
    pure step's bits: the update is elementwise."""
    _, got = run
    keys = [k for k in got if k.startswith(f"{name}/donated/")]
    assert len(keys) == 4 * len([k for k in got if k.startswith(
        f"{name}/grads/")])
    for key in keys:
        want = got[key.replace("/donated/", "/step/")]
        assert np.array_equal(got[key], want), key


def test_prefill_and_decode_over_mesh_match_reference(run):
    want, got = run
    name = world_mod.SERVE_CASE
    for part in ("prefill", "decode"):
        _check(want, got, f"{name}/{part}")


@pytest.mark.parametrize("name", world_mod.GNN_CASES)
def test_gnn_full_step_with_split_edges_matches_reference(run, name):
    want, got = run
    arch = get(name).config.arch
    _check(want, got, name, leaf_tol=max(LEAF_TOL, GNN_CHECK_TOL[arch]))
