"""Port parity of language-model training on the CPU:
``training/steps.py::make_lm_train_step`` and ``launch/train.py`` against
the JAX package's (``repro.training.make_lm_train_step``, jitted, and
``repro.launch.train``), at the smoke configs of the three dense archs and
the two mixture-of-experts archs, in float32.

One step runs from the same numpy weights and the same AdamW state, the
state's moments drawn at random and its counter past the warmup, so that
the step moves every parameter by a full, smoothly normalised update
(from zero moments AdamW's first steps move each element by about ±lr,
whatever the size of its gradient). Tolerances: loss, grad_norm and lr
within 1e-5 relative (measured at most 7.5e-7); each leaf of the params,
the master weights and both moments within 1e-5 of the leaf's largest
magnitude (measured at most 2.2e-6, in qwen3-moe; the two libraries sum
in other orders). ``launch/train.py``'s crash drill holds ``final_loss``
equal as printed. The ``[watchdog]`` line depends on the host's timing
(a step over four times the running mean), so the line checks set it
aside.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import train as j_train
from repro.models.transformer import Parallelism as JParallelism
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.training import make_lm_train_step as j_make_lm_train_step
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import adamw_state_from_numpy
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.tree import tree_leaves
from repro_torch.training import make_lm_train_step

from helpers import requires_modern_sharding
from test_torch_lm import _cfgs, _tokens, _weights

ARCHS = ["qwen3_0_6b", "qwen3_14b", "stablelm_12b", "dbrx_132b",
         "qwen3_moe_235b_a22b"]
RTOL, LEAF_TOL = 1e-5, 1e-5
PAR, J_PAR = tt.Parallelism.none(), JParallelism.none()
#: the schedule of the one-step comparison: step 5 of 20 past a warmup of 2
SCHEDULE = {"total_steps": 20, "warmup": 2}
START_STEP = 5


def _state(jp, seed=0):
    """An AdamW state of ``jp``'s structure as numpy arrays: float32 master
    weights equal to the params, m normal at 1e-3, v its square plus 1e-6,
    step ``START_STEP``."""
    rng = np.random.default_rng(seed)

    def m(p):
        return (rng.standard_normal(p.shape) * 1e-3).astype(np.float32)

    ms = jax.tree.map(m, jp)
    return {"step": np.int32(START_STEP),
            "master": jax.tree.map(lambda p: np.asarray(p, np.float32), jp),
            "m": ms,
            "v": jax.tree.map(lambda a: (a * a + 1e-6).astype(np.float32),
                              ms)}


def _leaves_close(got, want, tol=LEAF_TOL):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        scale = float(np.abs(b).max())
        assert float(np.abs(a.float().numpy() - b).max()) <= tol * scale


@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step from the same weights and state: loss, grad_norm, lr, every
    param leaf, the master weights, both moments and the counter."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    state = _state(jp)
    jopt = jax.tree.map(jnp.asarray, state)
    topt = adamw_state_from_numpy(state, tp, device="cpu")
    assert topt["step"].dtype == torch.int32
    batch = {"tokens": _tokens(jcfg.vocab, (2, 17), 21)}
    jstep = jax.jit(j_make_lm_train_step(jcfg, J_PAR, JAdamWConfig(lr=1e-3),
                                         **SCHEDULE))
    jp1, jo1, jm = jstep(jp, jopt, batch)
    tp1, to1, tm = make_lm_train_step(tcfg, PAR, AdamWConfig(lr=1e-3),
                                      **SCHEDULE)(tp, topt, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=RTOL,
                                   err_msg=key)
    assert float(jm["lr"]) > 0
    assert int(to1["step"]) == int(jo1["step"]) == START_STEP + 1
    _leaves_close(tp1, jp1)
    for key in ("master", "m", "v"):
        _leaves_close(to1[key], jo1[key])
    moved = float((tp1["layers"]["wq"] - tp["layers"]["wq"]).abs().max())
    assert moved > 1e-4  # the comparison has teeth


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_falls_over_five_steps(arch):
    """``tests/test_arch_smoke.py::test_lm_smoke_train_step`` through the
    port: the port's own weights (a seeded generator), one batch five
    times; the loss is finite, under 2 ln V, and falls."""
    from repro_torch.configs import get

    cfg = get(arch).smoke_config
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    step = make_lm_train_step(cfg, PAR, AdamWConfig(lr=1e-3))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 17),
                                     generator=torch.Generator().manual_seed(1),
                                     dtype=torch.int32)}
    params, opt, metrics = step(params, opt, batch)
    l0 = metrics["loss"].item()
    assert np.isfinite(l0) and l0 < 2 * np.log(cfg.vocab)
    for _ in range(4):
        params, opt, metrics = step(params, opt, batch)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    assert metrics["loss"].item() < l0


@requires_modern_sharding
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen3_moe_235b_a22b"])
def test_train_on_carried_over_weights(arch, capsys):
    """``launch/train.py::train`` on the JAX package's weights and a fresh
    state against the reference's step loop (the reference ``main``'s
    schedule: 6 steps, warmup 1, lr 1e-3, batches of ``SyntheticTokens``):
    every step's loss and grad_norm, then the params."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    data = SyntheticTokens(tcfg.vocab, 2, 16, seed=3)
    jstep = jax.jit(j_make_lm_train_step(jcfg, J_PAR, JAdamWConfig(lr=1e-3),
                                         total_steps=6, warmup=1))
    jopt = j_adamw_init(jp)
    want = []
    for i in range(6):
        jp, jopt, jm = jstep(jp, jopt, data.batch_at(i))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    tp, topt, recs = t_train.train(tcfg, tp, adamw_init(tp), data, 6,
                                   log_every=1)
    for rec, (loss, gnorm) in zip(recs, want, strict=True):
        np.testing.assert_allclose(rec["loss"], loss, rtol=RTOL)
        np.testing.assert_allclose(rec["grad_norm"], gnorm, rtol=RTOL)
    # AdamW's ±lr first steps amplify rounding where a gradient element
    # nearly cancels; the params after six steps: within 1% of the
    # summed lr besides (test_torch_training.py's allowance)
    lr_sum = sum(r["lr"] for r in recs)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        b = np.asarray(b, np.float32)
        assert float(np.abs(a.numpy() - b).max()) <= \
            LEAF_TOL * float(np.abs(b).max()) + 0.01 * lr_sum
    lines = _timing_free(capsys.readouterr().out)
    assert [ln.split()[1] for ln in lines[:-1]] == [str(i) for i in range(6)]
    assert lines[-1] == f"final_loss {recs[-1]['loss']:.4f}"


def _drill_args(tmp_path, name):
    return ["--arch", "qwen3_0_6b", "--smoke", "--steps", "30", "--batch",
            "2", "--seq", "32", "--ckpt-every", "10", "--ckpt-dir",
            str(tmp_path / name)]


def _final_loss(out: str) -> str:
    return re.search(r"^final_loss (\S+)$", out, re.M).group(1)


def test_crash_drill_reaches_same_final_loss(tmp_path, capsys):
    """``tests/test_fault_tolerance.py::test_crash_restart_reaches_same_state``
    on the port's driver, in process: 30 steps straight; a run killed at
    step 17 (exit 17), then restarted: it resumes at step 10 and prints the
    same ``final_loss``."""
    t_train.main(_drill_args(tmp_path, "a"), device="cpu")
    straight = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        t_train.main(_drill_args(tmp_path, "b") + ["--fail-at", "17"],
                     device="cpu")
    assert exc.value.code == 17
    killed = capsys.readouterr().out
    assert "[failure] simulated host failure at step 17" in killed
    assert "final_loss" not in killed
    losses = t_train.main(_drill_args(tmp_path, "b"), device="cpu")
    resumed = capsys.readouterr().out
    assert "[resume] restored step 10" in resumed
    assert len(losses) == 20
    assert _final_loss(resumed) == _final_loss(straight)
    assert float(_final_loss(resumed)) == pytest.approx(losses[-1], abs=1e-4)


def _timing_free(out: str) -> list:
    """The printed lines without the ``[watchdog]`` line, whose presence
    depends on the host's timing; that line, if printed, in its format."""
    lines = out.splitlines()
    for ln in lines:
        if ln.startswith("[watchdog]"):
            assert re.fullmatch(r"\[watchdog\] \d+ straggler events", ln)
    return [ln for ln in lines if not ln.startswith("[watchdog]")]


def _shape_of(line: str) -> str:
    """A printed line with its numbers replaced by ``#``."""
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


@requires_modern_sharding
def test_printed_lines_in_the_reference_format(capsys):
    """The port's and the reference's drivers print the same lines but for
    their numbers: ``step … loss … gnorm … ms`` every ``--log-every`` steps
    and at the last, ``final_loss`` last."""
    argv = ["--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--log-every", "2"]
    j_train.main(argv)
    theirs = _timing_free(capsys.readouterr().out)
    t_train.main(argv, device="cpu")
    mine = _timing_free(capsys.readouterr().out)
    assert [_shape_of(x) for x in mine] == [_shape_of(x) for x in theirs]
    assert [x.split()[1] for x in mine[:-1]] == ["0", "2", "3"]
    assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} \d+ms",
                        mine[0])
    assert re.fullmatch(r"final_loss \d+\.\d{4}", mine[-1])


def test_driver_raises_without_a_card(monkeypatch):
    """Without a card, and without ``device="cpu"``, the driver does not
    quietly train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        t_train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen3_moe_235b_a22b"])
def test_donated_step_gives_the_pure_bits(arch, monkeypatch):
    """``make_lm_train_step(..., donate=True)`` writes the new params and
    state into the given tensors (in chunks of ``DONATED_CHUNK`` elements,
    here 1,000, so that leaves split unevenly) and gives the pure step's
    bits: params, master, both moments, counter and metrics."""
    from repro_torch.configs import get
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_map

    monkeypatch.setattr(adamw, "DONATED_CHUNK", 1000)
    cfg = get(arch).smoke_config
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    opt["step"] = torch.tensor(START_STEP, dtype=torch.int32)
    batch = {"tokens": _tokens(cfg.vocab, (2, 17), 31)}
    kw = dict(opt_cfg=AdamWConfig(lr=1e-3), **SCHEDULE)
    p1, o1, m1 = make_lm_train_step(cfg, PAR, **kw)(params, opt, batch)
    given = tree_map(lambda t: t.clone(), (params, opt))
    p2, o2, m2 = make_lm_train_step(cfg, PAR, donate=True, **kw)(*given,
                                                                  batch)
    assert p2 is given[0] and o2["m"] is given[1]["m"]
    assert all(a is b for a, b in zip(tree_leaves(p2),
                                      tree_leaves(given[0])))
    for a, b in zip(tree_leaves((p1, o1, m1)), tree_leaves((p2, o2, m2))):
        assert torch.equal(a, b)
    assert not torch.equal(p1["layers"]["wq"], params["layers"]["wq"])
