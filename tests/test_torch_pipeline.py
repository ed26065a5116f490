"""GPipe pipeline parallelism (``models/pipeline.py``) over gloo, against
the JAX package's 8-device ``shard_map`` program of
``tests/test_pipeline.py``.

Eight spawned CPU ranks (``tests/torch_pipeline_world.py``) on a (pipe
4, data 2) mesh run ``make_pp_loss_fn``'s loss, its gradient and one
``make_pp_train_step`` step, each rank on its stage's block of the layers;
a subprocess with eight forced XLA host devices runs the reference's
``make_pp_loss_fn`` under ``jax.value_and_grad`` and its
``make_pp_train_step`` on the same weights, tokens and AdamW state (the
moments drawn at random, the counter past the warmup, so that the step
moves every element by a smooth, full-lr update).

Tolerances: the loss within 2e-4 absolute of JAX's and of the mean
non-pipelined ``lm_loss`` (``tests/test_pipeline.py``'s bound); every
gradient leaf of every stage within 1e-5 of that block's largest
magnitude; the step's loss, grad_norm and lr within 1e-5 relative, every
param, master, m and v block within 1e-5 of its largest magnitude (the two
libraries sum in other orders). In one process: ``stageify_params``'
shapes, the ``L % S`` assertion, a mixture-of-experts config refused, and
one stage without a mesh against ``lm_loss``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_pipeline_world as world_mod
from repro.models import pipeline as j_pipe
from repro.models import transformer as j_tfm
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import pipeline as t_pipe
from repro_torch.models import transformer as t_tfm
from repro_torch.models.moe import MoEConfig
from repro_torch.optim.tree import tree_leaves, tree_unflatten

from helpers import requires_modern_sharding

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 240
LOSS_TOL, RTOL, LEAF_TOL = 2e-4, 1e-5, 1e-5
N_STAGES = world_mod.SHAPE[0]
START_STEP = 5

_JAX_PROGRAM = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import transformer as tfm
from repro.models.pipeline import (PipelineConfig, make_pp_loss_fn,
                                   make_pp_train_step, stageify_params)
from repro.models.transformer import Parallelism
from repro.optim import AdamWConfig

inputs, out = sys.argv[1:3]
z = dict(np.load(inputs))
cfg = tfm.LMConfig(**{cfg!r})


def tree(prefix):
    t = {{"layers": {{}}}}
    for k, v in z.items():
        if k.startswith(prefix + "/"):
            name = k[len(prefix) + 1:]
            if name.startswith("layers/"):
                t["layers"][name[7:]] = jnp.asarray(v)
            else:
                t[name] = jnp.asarray(v)
    return t


def flat(t, prefix):
    o = {{f"{{prefix}}/{{k}}": np.asarray(v) for k, v in t.items()
          if k != "layers"}}
    o.update({{f"{{prefix}}/layers/{{k}}": np.asarray(v)
               for k, v in t["layers"].items()}})
    return o


mesh = jax.make_mesh((4, 2), ("pipe", "data"),
                     axis_types=(AxisType.Auto,) * 2)
params = tree("params")
tokens = jnp.asarray(z["tokens"])
par0 = Parallelism.none()
ref = np.mean([float(tfm.lm_loss(params, {{"tokens": tokens[i]}}, cfg, par0))
               for i in range(tokens.shape[0])])
par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
pp = PipelineConfig(n_stages=4, n_micro=tokens.shape[0])
loss_fn = make_pp_loss_fn(cfg, par, pp)
staged = stageify_params(params, 4)
state = {{"step": jnp.asarray(z["opt/step"]),
          **{{k: tree(f"opt/{{k}}") for k in ("master", "m", "v")}}}}
step = make_pp_train_step(cfg, par, pp, AdamWConfig(lr={lr!r}),
                          **{schedule!r})
with jax.set_mesh(mesh):
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(staged,
                                                        {{"tokens": tokens}})
    new, new_opt, metrics = jax.jit(step)(staged, state, {{"tokens": tokens}})
res = {{"loss": np.asarray(loss), "ref": np.asarray(ref),
        **flat(grads, "grads"), **flat(new, "step/params"),
        "step/opt/step": np.asarray(new_opt["step"]),
        **{{f"step/{{k}}": np.asarray(v) for k, v in metrics.items()}}}}
for k in ("master", "m", "v"):
    res.update(flat(new_opt[k], f"step/opt/{{k}}"))
np.savez(out, **res)
"""


def _inputs(path: Path) -> None:
    """The weights (JAX's ``init_params`` at key 0), the tokens
    (``tests/test_pipeline.py``'s draw) and an AdamW state of the staged
    tree, saved as numpy arrays."""
    cfg = j_tfm.LMConfig(**world_mod.CFG)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, j_tfm.init_params(cfg, key))
    tokens = np.asarray(jax.random.randint(
        key, (world_mod.N_MICRO, world_mod.MB, world_mod.SEQ + 1), 0,
        cfg.vocab))
    staged = jax.tree.map(np.asarray, j_pipe.stageify_params(params,
                                                             N_STAGES))
    rng = np.random.default_rng(1)
    data = {"tokens": tokens, "opt/step": np.int32(START_STEP),
            **world_mod.flat(params, "params")}
    for key_, leaf in (("master", lambda p: p.astype(np.float32)),
                       ("m", lambda p: (rng.standard_normal(p.shape)
                                        * 1e-3).astype(np.float32))):
        data.update(world_mod.flat(jax.tree.map(leaf, staged),
                                   f"opt/{key_}"))
    data.update({k.replace("opt/m/", "opt/v/"): (v * v + 1e-6).astype(
        np.float32) for k, v in data.items() if k.startswith("opt/m/")})
    np.savez(path, **data)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX's outputs, the eight ranks' files)."""
    out = tmp_path_factory.mktemp("pipeline_world")
    inputs = out / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX_PROGRAM.format(
        cfg=world_mod.CFG, lr=world_mod.LR, schedule=world_mod.SCHEDULE))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", code, str(inputs), str(out / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    wenv = dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_pipeline_world.py"),
         "--rank", str(r), "--world", "8", "--store", str(out / "store"),
         "--inputs", str(inputs), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=wenv)
        for r in range(8)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: {err[-2000:]}")
        _, jerr = jax_proc.communicate(timeout=600)
    finally:
        for p in [*procs, jax_proc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    assert jax_proc.returncode == 0, jerr[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return dict(np.load(out / "jax.npz")), ranks


def _stage_block(key: str, want: np.ndarray, stage: int) -> np.ndarray:
    return want[stage:stage + 1] if "/layers/" in key else want


def _close(got: np.ndarray, want: np.ndarray, tol: float = LEAF_TOL):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


@requires_modern_sharding
def test_loss_matches_shard_map_and_non_pp(run):
    want, ranks = run
    for rank in ranks:
        got = float(rank["loss"])
        assert abs(got - float(want["loss"])) < LOSS_TOL
        assert abs(got - float(want["ref"])) < LOSS_TOL


@requires_modern_sharding
def test_every_stage_gradient_matches_jax_grad(run):
    want, ranks = run
    keys = [k for k in want if k.startswith("grads/")]
    assert len(keys) == 2 + 9  # embed, final_norm and the nine layer leaves
    for rank in ranks:
        stage = int(rank["coord"][0])
        for key in keys:
            block = _stage_block(key, want[key], stage)
            _close(rank[key], block)
        assert np.abs(rank["grads/layers/wq"]).max() > 0, stage


@requires_modern_sharding
def test_train_step_matches_reference(run):
    want, ranks = run
    for rank in ranks:
        stage = int(rank["coord"][0])
        for key in ("step/loss", "step/grad_norm", "step/lr"):
            np.testing.assert_allclose(float(rank[key]), float(want[key]),
                                       rtol=RTOL, err_msg=key)
        assert int(rank["step/opt/step"]) == int(want["step/opt/step"]) \
            == START_STEP + 1
        for key in want:
            if key.startswith(("step/params/", "step/opt/master/",
                               "step/opt/m/", "step/opt/v/")):
                _close(rank[key], _stage_block(key, want[key], stage))


def _port_cfg(**kw):
    return t_tfm.LMConfig(**{**world_mod.CFG, **kw})


def test_stageify_params_shapes():
    """The port's staged shapes are the reference's; a stage's block is
    its slice of them."""
    jcfg = j_tfm.LMConfig(**world_mod.CFG)
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), _port_cfg(),
                              device="cpu")
    for stages in (1, 2, 4):
        want = j_pipe.stageify_params(jp, stages)
        got = t_pipe.stageify_params(tp, stages)
        for k, v in want["layers"].items():
            assert tuple(got["layers"][k].shape) == v.shape
            blk = t_pipe.stageify_params(tp, stages, stages - 1)
            np.testing.assert_array_equal(blk["layers"][k].numpy(),
                                          np.asarray(v[stages - 1:]))
        assert got["embed"] is tp["embed"]


def test_stageify_params_requires_whole_stages():
    jp = j_tfm.init_params(j_tfm.LMConfig(**world_mod.CFG),
                           jax.random.PRNGKey(0))
    tp = t_tfm.init_params(_port_cfg(), torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(AssertionError):
        j_pipe.stageify_params(jp, 3)
    with pytest.raises(AssertionError):
        t_pipe.stageify_params(tp, 3)
    with pytest.raises(AssertionError):
        t_pipe.make_pp_loss_fn(_port_cfg(), t_tfm.Parallelism.none(),
                               t_pipe.PipelineConfig(3, 4))


def test_stage_param_specs_match_reference():
    jcfg, tcfg = j_tfm.LMConfig(**world_mod.CFG), _port_cfg()
    pp = t_pipe.PipelineConfig(4, 4)
    jpar = j_tfm.Parallelism(mesh=None, dp_axes=("data",), tp_axis="model")
    tpar = t_tfm.Parallelism(mesh=None, dp_axes=("data",), tp_axis="model")
    want = j_pipe.stage_param_specs(jcfg, jpar, j_pipe.PipelineConfig(4, 4))
    got = t_pipe.stage_param_specs(tcfg, tpar, pp)
    assert tuple(got["embed"]) == tuple(want["embed"])
    assert tuple(got["final_norm"]) == tuple(want["final_norm"])
    assert {k: tuple(v) for k, v in want["layers"].items()} == \
        got["layers"]


def test_mixture_of_experts_refused():
    cfg = _port_cfg(moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=16))
    with pytest.raises(NotImplementedError, match="11.6"):
        t_pipe.make_pp_loss_fn(cfg, t_tfm.Parallelism.none(),
                               t_pipe.PipelineConfig(1, 2))


def test_one_stage_without_a_mesh_is_lm_loss():
    """S = 1 and no mesh: the loss is the mean of ``lm_loss`` over the
    microbatches, and its gradient that mean's gradient (1e-6 of each
    leaf's scale)."""
    cfg = _port_cfg(remat=True)
    par = t_tfm.Parallelism.none()
    params = t_tfm.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 2, 17),
                           generator=torch.Generator().manual_seed(4))
    loss_fn = t_pipe.make_pp_loss_fn(cfg, par, t_pipe.PipelineConfig(1, 3))
    staged = t_pipe.stageify_params(params, 1, 0)

    def grads(fn, tree):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
        loss = fn(tree_unflatten(tree, leaves))
        return loss.item(), torch.autograd.grad(loss, leaves)

    got, g_pp = grads(lambda p: loss_fn(p, {"tokens": tokens}), staged)
    want, g_ref = grads(lambda p: sum(
        t_tfm.lm_loss(p, {"tokens": tokens[i]}, cfg, par)
        for i in range(3)) / 3, params)
    assert abs(got - want) <= 1e-6 * abs(want)
    for a, b in zip(g_pp, g_ref):
        assert float((a.reshape(b.shape) - b).abs().max()) <= \
            1e-6 * float(b.abs().max())


def test_train_step_one_stage_clips_by_the_whole_norm():
    """``make_pp_train_step`` at S = 1 is ``make_lm_train_step`` over the
    mean loss: the same grad_norm, lr and new params (1e-6)."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training.steps import _train_step

    cfg = _port_cfg()
    par = t_tfm.Parallelism.none()
    params = t_tfm.init_params(cfg, torch.Generator().manual_seed(5),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 2, 17),
                           generator=torch.Generator().manual_seed(6))
    staged = t_pipe.stageify_params(params, 1, 0)
    kw = dict(total_steps=20, warmup=2)
    opt = adamw_init(staged)
    opt["step"] = torch.tensor(START_STEP, dtype=torch.int32)
    step = t_pipe.make_pp_train_step(cfg, par, t_pipe.PipelineConfig(1, 2),
                                     AdamWConfig(lr=1e-3), **kw)
    new, _, got = step(staged, opt, {"tokens": tokens})

    def mean_loss(p, batch):
        flat = {**p, "layers": {k: v[0] for k, v in p["layers"].items()}}
        return sum(t_tfm.lm_loss(flat, {"tokens": batch["tokens"][i]}, cfg,
                                 par) for i in range(2)) / 2

    ref_step = _train_step(mean_loss, AdamWConfig(lr=1e-3), **kw)
    _, _, want = ref_step(staged, opt, {"tokens": tokens})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key].item(), want[key].item(),
                                   rtol=1e-6, err_msg=key)
    assert new["layers"]["wq"].shape == staged["layers"]["wq"].shape
