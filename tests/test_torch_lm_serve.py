"""Port parity of the language-model serving driver on the CPU:
``launch/serve.py``'s ``generate`` (the prefill step, then the decode loop
through ``training/steps.py``'s LM steps) against the JAX package's
``repro.launch.serve.main`` at ``--smoke``, with the JAX package's own
weights and prompts carried across; and against the same loop written
with the reference's jitted steps on numpy weights drawn at twice their
fan-in's scale, whose greedy tokens do not collapse onto the last prompt
token as they do under the reference's 0.02 weights (the tied head then
reads back the token's own embedding).

Greedy tokens must be equal. Where one differs, the reference's two
largest logits at that step must lie within 1e-5 of the logits' largest
magnitude (a near tie, which the two libraries' float32 sums may break
either way) and the port's token must be one of them; that row is not
compared after it. Sampling cannot match JAX's PRNG: it is held to the
vocabulary's range and to determinism under a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get as j_get
from repro.launch import serve as j_serve
from repro.models import transformer as jt
from repro.training import make_lm_decode_step as j_decode_step
from repro.training import make_lm_prefill_step as j_prefill_step
from repro_torch.configs import get
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.training import make_lm_decode_step, make_lm_prefill_step

from helpers import requires_modern_sharding

ARCHS = ["qwen3_0_6b", "qwen3_14b", "stablelm_12b"]
TIE = 1e-5
J_PAR = jt.Parallelism.none()


def _jax_generate(jcfg, jp, prompts, gen):
    """``repro.launch.serve.main``'s greedy loop: (tokens [B, gen], the
    logits each token was taken from [B, gen, V])."""
    p = prompts.shape[1]
    prefill = jax.jit(j_prefill_step(jcfg, J_PAR, s_max=p + gen))
    decode = jax.jit(j_decode_step(jcfg, J_PAR))
    logits, cache = prefill(jp, prompts)
    toks, seen = [], []
    for i in range(gen):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        seen.append(np.asarray(logits))
        logits, cache = decode(jp, cache, tok, jnp.int32(p + i + 1))
    return np.concatenate(toks, axis=1), np.stack(seen, axis=1)


def _same_greedy(got, want, logits):
    """Equal tokens; a row's first difference only at a near tie."""
    assert got.shape == want.shape and got.dtype == np.int32
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size == 0:
            continue
        row = logits[r, diff[0]]
        margin = TIE * float(np.abs(row).max())
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= margin, (r, diff[0], top2)
        assert row[got[r, diff[0]]] >= top2[1] - margin


@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_main(arch, capsys):
    want = j_serve.main(["--smoke", "--arch", arch])
    jcfg, tcfg = j_get(arch).smoke_config, get(arch).smoke_config
    # the weights and prompts the reference's main drew
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                            jcfg.vocab))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    got, secs = serve.generate(tcfg, tp, prompts, 32, 0.0, None)
    assert set(secs) == {"prefill_s", "decode_s"}
    assert capsys.readouterr().out.count("\n") == 2
    if not np.array_equal(got, want):  # the reference's logits, to judge
        ref, logits = _jax_generate(jcfg, jp, prompts, 32)
        assert np.array_equal(ref, want)
        _same_greedy(got, want, logits)


def _fan_in_weights(jcfg, tcfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return np.ones(leaf.shape, np.float32)
        if "embed" in name:
            return rng.standard_normal(leaf.shape).astype(np.float32)
        fan = int(np.prod(leaf.shape[1:-1])) if "wo" in name \
            else leaf.shape[1]
        return (2 * rng.standard_normal(leaf.shape) / np.sqrt(fan)).astype(
            np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_loop_on_spread_weights(arch):
    jcfg, tcfg = j_get(arch).smoke_config, get(arch).smoke_config
    jp, tp = _fan_in_weights(jcfg, tcfg, seed=3)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 10)
                                                ).astype(np.int32)
    want, logits = _jax_generate(jcfg, jp, prompts, 12)
    assert len(np.unique(want)) > 12  # the tokens move: the test has teeth
    got, _ = serve.generate(tcfg, tp, prompts, 12, 0.0, None)
    _same_greedy(got, want, logits)


def test_steps_exported():
    from repro_torch import training

    assert training.make_lm_prefill_step is make_lm_prefill_step
    assert training.make_lm_decode_step is make_lm_decode_step


def test_main_prints_and_repeats_under_a_seed(capsys):
    argv = ["--smoke", "--arch", "qwen3_14b", "--batch", "2",
            "--prompt-len", "5", "--gen", "4"]
    first = serve.main(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert out[0].startswith("prefill 2x5 tok in ") and "decode 4 steps" in out[0]
    assert out[1] == f"sample row 0: {first[0].tolist()}"
    assert first.shape == (2, 4) and first.dtype == np.int32
    assert np.array_equal(serve.main(argv, device="cpu"), first)


def test_sampling_in_range_and_deterministic(capsys):
    base = ["--smoke", "--batch", "3", "--prompt-len", "4", "--gen", "8"]
    hot = base + ["--temperature", "1.0"]
    a = serve.main(hot, device="cpu")
    assert a.shape == (3, 8) and a.dtype == np.int32
    assert ((a >= 0) & (a < get("qwen3_0_6b").smoke_config.vocab)).all()
    assert np.array_equal(serve.main(hot, device="cpu"), a)
    assert not np.array_equal(serve.main(hot + ["--seed", "1"], device="cpu"),
                              a)
    greedy = serve.main(base, device="cpu")
    # the first token is the prefill's greedy one either way, as in JAX
    assert np.array_equal(a[:, 0], greedy[:, 0])
    assert not np.array_equal(a[:, 1:], greedy[:, 1:])


def test_main_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
