"""Port parity of the dense decoder on the CPU: ``models/transformer.py``
(config, parameters, ``forward``, ``forward_with_kv`` with its KV stacks,
``decode_step`` against a cache, ``lm_loss``), ``interop.
lm_params_from_numpy`` and the LM configs, against the JAX package at the
smoke configs of the three dense archs, whose q heads pad 4 to 16
(qwen3_0_6b, stablelm_12b) and 5 to 16 (qwen3_14b). Weights and tokens are
drawn by numpy from a seed, in the reference's parameter layout (its
``init_params`` traced for shapes only); the weights are scaled by their
fan-in, so that attention and the MLP move the residual stream (the
reference's 0.02 leaves it to the embedding), and the norms' gains spread
around 1.

Tolerances, against the largest magnitude of the compared tensor: float32
1e-5 (measured about 4e-7: the two libraries sum products in other
orders); bfloat16 3e-2 (measured up to 1e-2: both round every op's result
to bfloat16, but XLA keeps float32 between the ops it fuses, so after two
layers they differ by a few units of bfloat16's 2^-8).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import LM_FULL_ATTENTION_SKIPS as J_SKIPS
from repro.configs import LM_SHAPES as J_LM_SHAPES
from repro.configs import get as j_get
from repro.models import transformer as jt
from repro.models.moe import MoEConfig
from repro.training import make_lm_prefill_step as j_prefill_step
from repro_torch.configs import LM_FULL_ATTENTION_SKIPS, LM_SHAPES, get
from repro_torch.interop import lm_params_from_numpy, to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.training import make_lm_prefill_step

from helpers import requires_modern_sharding

ARCHS = ["qwen3_0_6b", "qwen3_14b", "stablelm_12b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
J_PAR, PAR = jt.Parallelism.none(), tt.Parallelism.none()


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"error {err} against scale {scale}"


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get(arch).smoke_config, param_dtype=dtype),
            dataclasses.replace(get(arch).smoke_config, param_dtype=dtype))


def _jax_shapes(jcfg):
    return jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))


def _weights(jcfg, tcfg, seed=0):
    """(the reference's params, the port's) from one float32 numpy tree,
    each rounded to the config's dtype once."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            a = 1 + 0.1 * rng.standard_normal(leaf.shape)
        elif "embed" in name:
            a = rng.standard_normal(leaf.shape)
        else:  # fan-in: axis 1 after the stacked layer axis (wo: h x dh;
            # an expert's weight [L, E, in, out]: its input axis)
            fan = int(np.prod(leaf.shape[1:-1])) if "wo" in name \
                else leaf.shape[-2] if "we_" in name else leaf.shape[1]
            a = rng.standard_normal(leaf.shape) / np.sqrt(fan)
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, _jax_shapes(jcfg))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), tree)
    return jp, lm_params_from_numpy(tree, tcfg, device="cpu")


@functools.lru_cache(None)
def _j_prefill(jcfg, s_max):
    return jax.jit(j_prefill_step(jcfg, J_PAR, s_max=s_max))


@functools.lru_cache(None)
def _j_decode(jcfg):
    return jax.jit(lambda p, c, t, n: jt.decode_step(p, c, t, n, jcfg, J_PAR))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp, TOL[dtype]


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    mine, theirs = get(arch), j_get(arch)
    assert (mine.arch_id, mine.family, mine.shapes, mine.skips, mine.notes) \
        == (theirs.arch_id, theirs.family, theirs.shapes, theirs.skips,
            theirs.notes)
    for name in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(mine, name)) == \
            dataclasses.asdict(getattr(theirs, name))
    assert LM_SHAPES == J_LM_SHAPES
    assert LM_FULL_ATTENTION_SKIPS == J_SKIPS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_properties(arch, which):
    mine, theirs = getattr(get(arch), which), getattr(j_get(arch), which)
    for name in ("g_real", "g_padded", "h_padded"):
        assert getattr(mine, name) == getattr(theirs, name), name
    assert mine.n_params() == theirs.n_params()
    assert mine.n_active_params() == theirs.n_active_params()
    assert mine.dtype == getattr(torch, theirs.param_dtype)
    jm, tm = theirs.head_mask(), mine.head_mask()
    assert (jm is None) == (tm is None)
    if tm is not None:
        assert tm.dtype == torch.float32
        assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_head_padding_widths():
    assert get("qwen3_14b").config.h_padded == 48
    assert get("qwen3_0_6b").smoke_config.h_padded == 16
    assert get("stablelm_12b").smoke_config.h_padded == 16
    assert get("qwen3_14b").smoke_config.h_padded == 16


@pytest.mark.parametrize("moe_arch", ["dbrx_132b", "qwen3_moe_235b_a22b"])
def test_moe_counts_and_shapes(moe_arch):
    """The MoE configs' parameter counts through the port's ``LMConfig``;
    the port's ``param_shapes`` and ``init_params`` (a one-layer model of
    the smoke config with the full config's expert count and top-k) give
    the reference's ``init_params`` tree: keys, shapes and dtypes."""
    jc = j_get(moe_arch).config
    tc = tt.LMConfig(**{f.name: getattr(jc, f.name)
                        for f in dataclasses.fields(jc)})
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    jsmall = dataclasses.replace(
        j_get(moe_arch).smoke_config, n_layers=1,
        moe=MoEConfig(n_experts=jc.moe.n_experts, top_k=jc.moe.top_k,
                      d_ff_expert=8))
    small = dataclasses.replace(get(moe_arch).smoke_config, n_layers=1,
                                moe=tmoe.MoEConfig(**dataclasses.asdict(
                                    jsmall.moe)))
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(_jax_shapes(jsmall))}
    shapes = tt.param_shapes(small)
    got = tt.init_params(small, torch.Generator().manual_seed(0),
                         device="cpu")
    for tree, shape_of in ((shapes, tuple), (got, lambda t: tuple(t.shape))):
        flat = {jax.tree_util.keystr(p): shape_of(v) for p, v in
                jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda x: isinstance(x, tuple))}
        assert flat == {k: v.shape for k, v in want.items()}
    assert "['layers']['we_out']" in want and "['layers']['w_in']" not in want
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        assert leaf.dtype == getattr(
            torch, str(want[jax.tree_util.keystr(path)].dtype))


# ------------------------------------------------------------------- params
@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = _jax_shapes(jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = tt.init_params(tcfg, gen, device="cpu")
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    t_flat = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(tp)}
    assert len(j_leaves) == len(t_flat)
    for path, leaf in j_leaves:
        mine = t_flat[jax.tree_util.keystr(path)]
        assert tuple(mine.shape) == leaf.shape
        assert mine.dtype == tcfg.dtype == getattr(torch, str(leaf.dtype))
        assert mine.device.type == "cpu"
    ls = tp["layers"]
    assert torch.equal(ls["attn_norm"], torch.ones_like(ls["attn_norm"]))
    assert abs(float(ls["wq"].float().std()) - 0.02) < 2e-3
    out_sig = 0.02 / np.sqrt(2 * tcfg.n_layers)
    assert abs(float(ls["wo"].float().std()) - out_sig) < 0.1 * out_sig
    again = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


@pytest.mark.parametrize("par", [jt.Parallelism(), jt.Parallelism.none()],
                         ids=["mesh_axes", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs(arch, par):
    jcfg, tcfg = _cfgs(arch)
    tpar = tt.Parallelism(mesh=None, dp_axes=par.dp_axes, tp_axis=par.tp_axis)
    want = jax.tree.map(tuple, jt.param_specs(jcfg, par),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tt.param_specs(tcfg, tpar) == want
    assert tt.cache_specs(tcfg, tpar) == tuple(
        tuple(s) for s in jt.cache_specs(jcfg, par))


def test_lm_params_from_numpy_checks_shapes():
    jcfg, tcfg = _cfgs("qwen3_14b")
    tree = jax.tree.map(np.asarray, _weights(jcfg, tcfg)[0])
    unpadded = dict(tree["layers"], wq=tree["layers"]["wq"][:, :, :5])
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(dict(tree, layers=unpadded), tcfg, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(dict(tree, embed=tree["embed"][:-1]), tcfg,
                             device="cpu")
    missing = {k: v for k, v in tree["layers"].items() if k != "q_norm"}
    with pytest.raises(ValueError, match="layer keys"):
        lm_params_from_numpy(dict(tree, layers=missing), tcfg, device="cpu")
    # bfloat16 arrays (ml_dtypes) come across exactly
    jb, tb = _cfgs("qwen3_14b", "bfloat16")
    jp = _weights(jb, tb)[0]
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tb, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert np.array_equal(to_numpy(tp)["embed"],
                          np.asarray(jp["embed"], np.float32))


# ------------------------------------------------------------------ forward
@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    """Float32; bfloat16's forward is held through ``forward_with_kv``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    tol = TOL["float32"]
    toks = _tokens(jcfg.vocab, (2, 40), 1)  # 40 = 2.5 attention chunks
    jx, jaux = jax.jit(lambda p, t: jt.forward(p, t, jcfg, J_PAR))(jp, toks)
    tx, taux = tt.forward(tp, toks, tcfg, PAR)
    assert tx.dtype == tcfg.dtype and float(taux) == float(jaux) == 0.0
    _close(tx, jx, tol)


@requires_modern_sharding
def test_forward_with_kv(model):
    jcfg, tcfg, jp, tp, tol = model
    toks = _tokens(jcfg.vocab, (2, 40), 2)
    jx, (jk, jv) = jax.jit(
        lambda p, t: jt.forward_with_kv(p, t, jcfg, J_PAR))(jp, toks)
    tx, (tk, tv) = tt.forward_with_kv(tp, toks, tcfg, PAR)
    assert tk.shape == (tcfg.n_layers, 2, 40, tcfg.n_kv_heads, tcfg.d_head)
    assert tk.dtype == tv.dtype == tcfg.dtype
    _close(tx, jx, tol)
    _close(tk, jk, tol)
    _close(tv, jv, tol)


@requires_modern_sharding
def test_prefill_then_decode_steps(model):
    """The prefill step (prompt 16, cache of 24) then three one-token
    steps and one three-token step, each fed the JAX package's greedy
    tokens: logits and the whole cache after every step. The port writes
    into the cache it is given and returns the same tensors."""
    jcfg, tcfg, jp, tp, tol = model
    prompt = _tokens(jcfg.vocab, (2, 16), 3)
    jlog, jcache = _j_prefill(jcfg, 24)(jp, prompt)
    tlog, tcache = make_lm_prefill_step(tcfg, PAR, s_max=24)(tp, prompt)
    _close(tlog, jlog, tol)
    for a, b in zip(tcache, jcache):
        _close(a, b, tol)
    jdec = _j_decode(jcfg)
    valid = 16
    extra = _tokens(jcfg.vocab, (2, 2), 4)
    for step in range(4):
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        if step == 3:
            tok = np.concatenate([tok, extra], axis=1)
        valid += tok.shape[1]
        jlog, jcache = jdec(jp, jcache, tok, jnp.int32(valid))
        given = tcache
        tlog, tcache = tt.decode_step(tp, tcache, tok, valid, tcfg, PAR)
        assert tcache[0] is given[0] and tcache[1] is given[1]
        assert tlog.dtype == torch.float32 and tlog.shape == (2, tcfg.vocab)
        _close(tlog, jlog, tol)
        for a, b in zip(tcache, jcache):
            _close(a, b, tol)


@requires_modern_sharding
@pytest.mark.parametrize("valid_len,written", [(12, 6), (9, 6), (7, 5),
                                               (1, 6), (-4, 2), (-10, 0)])
def test_decode_cache_write_clamps(valid_len, written):
    """``lax.dynamic_update_slice`` places the write: a two-token step on
    an 8-row cache at ``valid_len`` 12 (start 10) and 9 (start 7) writes
    rows 6-7; a negative start wraps by Smax first
    (``allow_negative_indices``, its default), so ``valid_len`` 1 (start
    -1, below the step's length) writes rows 6-7 too, -4 (start -6) rows
    2-3, and -10 (start -12, still negative) clamps to rows 0-1; positions
    and the mask stay as given. Logits and cache against the reference."""
    jcfg, tcfg = _cfgs("qwen3_14b")
    jp, tp = _weights(jcfg, tcfg)
    prompt = _tokens(jcfg.vocab, (2, 6), 5)
    jlog, jcache = _j_prefill(jcfg, 8)(jp, prompt)
    _, tcache = make_lm_prefill_step(tcfg, PAR, s_max=8)(tp, prompt)
    before = [c.clone() for c in tcache]
    tok = _tokens(jcfg.vocab, (2, 2), 6)
    jlog, jcache = _j_decode(jcfg)(jp, jcache, tok, jnp.int32(valid_len))
    tlog, tcache = tt.decode_step(tp, tcache, tok, valid_len, tcfg, PAR)
    _close(tlog, jlog, TOL["float32"])
    for a, b, old in zip(tcache, jcache, before):
        _close(a, b, TOL["float32"])
        changed = (a != old).any(4).any(3).any(1)  # [L, Smax]
        rows = torch.nonzero(changed.any(0)).flatten().tolist()
        assert rows == [written, written + 1]


@requires_modern_sharding
@pytest.mark.parametrize("bad", [512, -513])
def test_out_of_range_token_gives_nan_rows(bad):
    """A token id outside ``[-V, V)`` reads a NaN embedding row
    (``jnp.take``'s fill mode) and its sequence turns NaN, as in JAX; the
    other sequence stays finite and equal. -1 wraps to V - 1."""
    jcfg, tcfg = _cfgs("qwen3_0_6b")
    jp, tp = _weights(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, (2, 12), 7)
    toks[0, 5], toks[1, 3] = bad, -1
    jx, _ = jax.jit(lambda p: jt.forward(p, toks, jcfg, J_PAR))(jp)
    tx, _ = tt.forward(tp, toks, tcfg, PAR)
    jx, tx = np.asarray(jx), tx.numpy()
    assert np.array_equal(np.isnan(jx), np.isnan(tx))
    assert np.isnan(tx[0]).all() and np.isfinite(tx[1]).all()
    _close(tx[1], jx[1], TOL["float32"])
    cache = tt.init_cache(tcfg, 2, 16, device="cpu")
    logits, _ = tt.decode_step(tp, cache, np.array([[bad], [3]], np.int32), 1,
                               tcfg, PAR)
    assert torch.isnan(logits[0]).all() and torch.isfinite(logits[1]).all()


def test_init_cache():
    _, tcfg = _cfgs("stablelm_12b", "bfloat16")
    ck, cv = tt.init_cache(tcfg, 3, 10, device="cpu")
    assert ck.shape == cv.shape == (2, 3, 10, tcfg.n_kv_heads, tcfg.d_head)
    assert ck.dtype == torch.bfloat16 and not ck.any()
    ck, _ = tt.init_cache(tcfg, 1, 4, dtype=torch.float32, device="cpu")
    assert ck.dtype == torch.float32


# ---------------------------------------------------------- loss, padding
@requires_modern_sharding
@pytest.mark.parametrize("remat", [False, True])
def test_head_padding_is_exact(remat):
    """``tests/test_arch_smoke.py::test_head_padding_is_exact``'s
    construction through the port: the real heads of an unpadded model
    (6 heads, g 3) embedded in the kv-grouped padded layout (g 4, 8 heads)
    give the same loss, which equals the reference's; the padded lanes get
    exactly zero gradient (with and without per-layer checkpointing)."""
    base_j = jt.LMConfig(name="t", n_layers=2, d_model=64, n_heads=6,
                         n_kv_heads=2, d_ff=128, vocab=97, d_head=16,
                         qk_norm=True, param_dtype="float32", attn_chunk=8,
                         remat=False, tp_align=1)
    base = tt.LMConfig(**dataclasses.asdict(base_j) | {"remat": remat})
    padded = dataclasses.replace(base, tp_align=4)
    assert padded.h_padded == 8 and padded.g_padded == 4
    key = jax.random.PRNGKey(0)
    p_ref = jax.tree.map(np.asarray,
                         jax.jit(jt.init_params, static_argnums=0)(base_j, key))
    wq = np.zeros((2, 64, 8, 16), np.float32)
    wo = np.zeros((2, 8, 16, 64), np.float32)
    for kv in range(2):
        for g in range(3):
            wq[:, :, kv * 4 + g] = p_ref["layers"]["wq"][:, :, kv * 3 + g]
            wo[:, kv * 4 + g] = p_ref["layers"]["wo"][:, kv * 3 + g]
    p_pad = dict(p_ref, layers=dict(p_ref["layers"], wq=wq, wo=wo))
    toks = {"tokens": np.asarray(jax.random.randint(key, (2, 17), 0, 97))}
    want = float(jax.jit(lambda p: jt.lm_loss(p, toks, base_j, J_PAR))(
        jax.tree.map(jnp.asarray, p_ref)))
    t_ref = lm_params_from_numpy(p_ref, base, device="cpu")
    t_pad = lm_params_from_numpy(p_pad, padded, device="cpu")
    l_ref = tt.lm_loss(t_ref, toks, base, PAR)
    np.testing.assert_allclose(l_ref.item(), want, rtol=1e-6)
    leaves = {k: v.requires_grad_(True) for k, v in t_pad["layers"].items()}
    l_pad = tt.lm_loss(dict(t_pad, layers=leaves), toks, padded, PAR)
    np.testing.assert_allclose(l_pad.item(), l_ref.item(), rtol=2e-5)
    gq, go = torch.autograd.grad(l_pad, (leaves["wq"], leaves["wo"]))
    for kv in range(2):
        assert not gq[:, :, kv * 4 + 3].any()
        assert not go[:, kv * 4 + 3].any()
    assert gq.abs().sum() > 0


@requires_modern_sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient(arch):
    """``lm_loss`` and the gradient of every parameter at the float32
    smoke config (remat on, as the config says), against ``jax.grad``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    batch = {"tokens": _tokens(jcfg.vocab, (2, 17), 8)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(p, batch, jcfg, J_PAR)))(jp)
    flat = {jax.tree_util.keystr(p): v.requires_grad_(True)
            for p, v in jax.tree_util.tree_leaves_with_path(tp)}
    leaves = list(flat.values())
    tp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                      leaves)
    loss = tt.lm_loss(tp, batch, tcfg, PAR)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(jg)}
    for name, g in zip(flat, grads):
        _close(g, want[name], TOL["float32"])
