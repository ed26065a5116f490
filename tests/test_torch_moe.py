"""Port parity of the mixture-of-experts layer on the CPU:
``models/moe.py`` (``MoEConfig``, the routing, ``moe_ffn_local``, the
meshless ``make_moe_layer``) and the MoE decoder of
``models/transformer.py`` on the dbrx and qwen3-moe smoke configs,
against the JAX package (jitted).

The routing is integers and is held bit for bit: top-k ids in
``lax.top_k``'s order, each (token, choice)'s rank in its expert's
queue, the kept mask and C, against the reference's own lines (``_j_route``
repeats them). For that, x and the router are drawn on a grid of 2^-4, so
that every float32 logit is exact on both sides and the softmax cannot
reorder two logits that differ. The outputs then confirm the routing:
a dropped or misrouted pair would move its token by a whole expert's
output.

Tolerances, against the largest magnitude of the compared tensor:
float32 1e-5 (one layer measured at 1.4e-7: sums in other orders), bfloat16 3e-2
(``test_torch_lm.py``'s: every op rounds to bfloat16; XLA keeps float32
between the ops it fuses and adds a token's k contributions in bfloat16,
the port in float32). The aux loss: float32 within 1e-6 relative.

In bfloat16 the two libraries' hidden states differ by a few bfloat16
roundings, so their router logits do too, and a token whose k-th and
(k+1)-th logits lie closer than that routes differently on each side and
moves by a whole expert's output (at the smoke sizes, about one token in
a two-layer run). So the bfloat16 decoder tests hold a zero router: its
uniform softmax routes every token to the k lowest experts by
``lax.top_k``'s tie rule on both sides (C then drops the rest), and
everything else of the layer is held. The router's bfloat16 arithmetic
is held on one layer (``test_layer_on_normal_inputs``), the routing of
trained-like routers in float32.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax

from repro.configs import get as j_get
from repro.models import moe as jm
from repro.models import transformer as jt
from repro_torch.configs import get
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt

from helpers import requires_modern_sharding
from test_torch_lm import TOL, _cfgs, _close, _tokens, _weights

MOE_ARCHS = ["dbrx_132b", "qwen3_moe_235b_a22b"]
J_PAR, PAR = jt.Parallelism.none(), tt.Parallelism.none()
T, D, F = 48, 32, 24


def _grid(rng, shape):
    """float32 values on a grid of 2^-4 (at most 2^-4 · 16 in magnitude)."""
    return (np.clip(np.round(rng.standard_normal(shape) * 4), -16, 16)
            / 16).astype(np.float32)


def _layer(seed, e, t=T):
    """x [t, D] and router [D, e] on the grid; expert weights at fan-in."""
    rng = np.random.default_rng(seed)
    return (_grid(rng, (t, D)), _grid(rng, (D, e)),
            (rng.standard_normal((e, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((e, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((e, F, D)) / np.sqrt(F)).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("cfg", "e_start", "n_local"))
def _j_route(x_flat, router_w, *, cfg, e_start, n_local):
    """The routing lines of ``repro.models.moe.moe_ffn_local``, verbatim:
    (top-k ids, rank, local)."""
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 1)
    logits = x_flat.astype(jnp.float32) @ router_w.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, topk_idx = lax.top_k(probs, k)
    e_flat = topk_idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    rank = jnp.sum(pos_in_e * onehot, axis=-1)
    local = (e_flat >= e_start) & (e_flat < e_start + n_local) & (rank < cap)
    return topk_idx, rank, local


@functools.lru_cache(None)
def _j_moe(cfg, e_start, n_local):
    return jax.jit(functools.partial(jm.moe_ffn_local, cfg=cfg,
                                     e_start=e_start, n_local=n_local))


def _both(cfg_kw):
    return jm.MoEConfig(**cfg_kw), tm.MoEConfig(**cfg_kw)


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


ROUTING_CASES = {
    "plain": ({"n_experts": 8, "top_k": 2, "d_ff_expert": F}, None),
    "cf_half": ({"n_experts": 8, "top_k": 2, "d_ff_expert": F,
                 "capacity_factor": 0.5}, None),
    "top4_of_16": ({"n_experts": 16, "top_k": 4, "d_ff_expert": F}, None),
    # every token's first choice is expert 3, its other choices tie at
    # the lowest ids (lax.top_k's order); expert 3 drops all but C
    "one_expert": ({"n_experts": 8, "top_k": 2, "d_ff_expert": F},
                   "one_expert"),
}


def _case(name, seed=0):
    kw, how = ROUTING_CASES[name]
    jcfg, tcfg = _both(kw)
    x, r, wg, wi, wo = _layer(seed, kw["n_experts"])
    if how == "one_expert":
        x[:, 0] = 1.0
        r[:] = 0.0
        r[0, 3] = 1.0
    return jcfg, tcfg, (x, r, wg, wi, wo)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_are_copies(arch):
    mine, theirs = get(arch), j_get(arch)
    assert (mine.arch_id, mine.family, mine.shapes, mine.skips, mine.notes) \
        == (theirs.arch_id, theirs.family, theirs.shapes, theirs.skips,
            theirs.notes)
    for name in ("config", "smoke_config"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert isinstance(a.moe, tm.MoEConfig)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
        assert a.n_active_params() == b.n_active_params()
        assert a.h_padded == b.h_padded


@pytest.mark.parametrize("t", [1, 7, 48, 8192])
@pytest.mark.parametrize("kw", [{"n_experts": 128, "top_k": 8},
                                {"n_experts": 16, "top_k": 4},
                                {"n_experts": 8, "top_k": 2,
                                 "capacity_factor": 0.5}])
def test_capacity(kw, t):
    """C = max(ceil(T·k / E · cf), 1), in Python floats as the reference."""
    cfg = tm.MoEConfig(d_ff_expert=4, **kw)
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    assert tm.capacity(t, cfg) == max(int(np.ceil(t * k / e * cf)), 1)


# ------------------------------------------------------------------ routing
@requires_modern_sharding
@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_routing_is_bit_identical(case):
    """ids, ranks, the kept mask and C equal the reference's, and drops
    happen where the case says; the outputs and aux then match."""
    jcfg, tcfg, arrays = _case(case)
    x, r, wg, wi, wo = arrays
    e = tcfg.n_experts
    ids, rank, local = (np.asarray(a) for a in _j_route(
        x, r, cfg=jcfg, e_start=0, n_local=e))
    got = tm.route(*_t(x, r), tcfg, 0, e)
    assert got["cap"] == max(int(np.ceil(T * tcfg.top_k / e
                                         * tcfg.capacity_factor)), 1)
    assert got["ids"].dtype == torch.int64
    assert np.array_equal(got["ids"].numpy(), ids)
    assert np.array_equal(got["rank"].numpy(), rank)
    assert np.array_equal(got["kept"].numpy(), local)
    dropped = int((~local).sum())
    if case in ("cf_half", "one_expert"):
        assert dropped > 0
    if case == "one_expert":
        assert (ids[:, 0] == 3).all() and (ids[:, 1] == 0).all()
        assert int(local.reshape(T, 2)[:, 0].sum()) == got["cap"]
    out, aux = tm.moe_ffn_local(*_t(*arrays), cfg=tcfg, e_start=0,
                                n_local=e)
    jout, jaux = _j_moe(jcfg, 0, e)(*arrays)
    _close(out, jout, TOL["float32"])
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@requires_modern_sharding
@pytest.mark.parametrize("case", ["plain", "top4_of_16", "one_expert"])
@pytest.mark.parametrize("tp", [2, 4])
def test_rank_partials_sum_to_the_whole(case, tp):
    """Each model rank's partial (its experts [r·E/tp, (r+1)·E/tp), the
    rest routed to the dump row) against the reference's partial, and the
    partials summed against the whole layer; the kept masks partition the
    whole layer's; aux is the same on every rank."""
    jcfg, tcfg, arrays = _case(case)
    x, r, wg, wi, wo = arrays
    e = tcfg.n_experts
    n_local = e // tp
    whole, aux = tm.moe_ffn_local(*_t(*arrays), cfg=tcfg, e_start=0,
                                  n_local=e)
    total = torch.zeros_like(whole)
    kept = torch.zeros(T * tcfg.top_k, dtype=torch.int32)
    for rank in range(tp):
        sl = slice(rank * n_local, (rank + 1) * n_local)
        part, aux_r = tm.moe_ffn_local(
            *_t(x, r, wg[sl], wi[sl], wo[sl]), cfg=tcfg,
            e_start=rank * n_local, n_local=n_local)
        jpart, _ = _j_moe(jcfg, rank * n_local, n_local)(
            x, r, wg[sl], wi[sl], wo[sl])
        _close(part, jpart, TOL["float32"])
        assert aux_r.item() == aux.item()
        total += part
        kept += tm.route(*_t(x, r), tcfg, rank * n_local, n_local)[
            "kept"].int()
    _close(total, whole, TOL["float32"])
    assert torch.equal(kept.bool(), tm.route(*_t(x, r), tcfg, 0, e)["kept"])
    assert int(kept.max()) <= 1


# ------------------------------------------------------------ values, grads
@requires_modern_sharding
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{"n_experts": 8, "top_k": 2},
                                {"n_experts": 4, "top_k": 2,
                                 "capacity_factor": 0.75}])
def test_layer_on_normal_inputs(kw, dtype):
    """``make_moe_layer(None, ...)`` on [B, S, D] normal inputs (no grid)
    in float32 and bfloat16: output and aux within the tolerances."""
    jcfg, tcfg = _both({**kw, "d_ff_expert": F})
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, 24, D)).astype(np.float32),
              (rng.standard_normal((D, kw["n_experts"]))
               / np.sqrt(D)).astype(np.float32),
              *_layer(6, kw["n_experts"])[2:]]
    jdt = jnp.dtype(dtype)
    jout, jaux = jax.jit(jm.make_moe_layer(None, (), None, jcfg))(
        *(jnp.asarray(a, jdt) for a in arrays))
    out, aux = tm.make_moe_layer(None, (), None, tcfg)(
        *_t(*arrays, dtype=getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 24, D)
    assert aux.dtype == torch.float32
    _close(out, jout, TOL[dtype])
    np.testing.assert_allclose(aux.item(), float(jaux),
                               rtol=1e-6 if dtype == "float32" else 1e-2)


@requires_modern_sharding
@pytest.mark.parametrize("case", ["plain", "cf_half", "one_expert"])
def test_gradients(case):
    """The gradients of sum(out · cotangent) + aux with respect to x, the
    router and the three expert weights, against ``jax.grad``."""
    jcfg, tcfg, arrays = _case(case)
    e = tcfg.n_experts
    cot = np.random.default_rng(9).standard_normal((T, D)).astype(
        np.float32)

    def j_obj(*a):
        out, aux = jm.moe_ffn_local(*a, cfg=jcfg, e_start=0, n_local=e)
        return jnp.sum(out * cot) + aux

    want = jax.jit(jax.grad(j_obj, argnums=tuple(range(5))))(*arrays)
    leaves = [t.requires_grad_(True) for t in _t(*arrays)]
    out, aux = tm.moe_ffn_local(*leaves, cfg=tcfg, e_start=0, n_local=e)
    got = torch.autograd.grad((out * torch.tensor(cot)).sum() + aux, leaves)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


# ------------------------------------------------------------- the decoder
@pytest.fixture(scope="module", params=[(a, d) for a in MOE_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """The smoke weights at fan-in scale; in bfloat16 with a zero router
    (the module's docstring says why)."""
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, tcfg)
    if dtype == "bfloat16":
        jp["layers"]["router"] = jnp.zeros_like(jp["layers"]["router"])
        tp["layers"]["router"].zero_()
    return jcfg, tcfg, jp, tp, TOL[dtype]


@requires_modern_sharding
def test_decoder_forward_and_loss(model):
    """``forward`` (hidden states and the layers' summed aux) and
    ``lm_loss`` (cross entropy plus 0.01 · aux / L)."""
    jcfg, tcfg, jp, tp, tol = model
    toks = _tokens(jcfg.vocab, (2, 24), 11)
    jx, jaux = jax.jit(lambda p, t: jt.forward(p, t, jcfg, J_PAR))(jp, toks)
    tx, taux = tt.forward(tp, toks, tcfg, PAR)
    assert tx.dtype == tcfg.dtype and taux.dtype == torch.float32
    _close(tx, jx, tol)
    rtol = 1e-6 if tol == TOL["float32"] else 1e-2
    assert float(jaux) > 0
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=rtol)
    batch = {"tokens": _tokens(jcfg.vocab, (2, 17), 12)}
    jl = jax.jit(lambda p: jt.lm_loss(p, batch, jcfg, J_PAR))(jp)
    np.testing.assert_allclose(tt.lm_loss(tp, batch, tcfg, PAR).item(),
                               float(jl), rtol=rtol)


@requires_modern_sharding
def test_decoder_prefill_and_decode(model):
    """``forward_with_kv`` (hidden and KV stacks), then two one-token
    ``decode_step``s and a three-token one against the cache."""
    jcfg, tcfg, jp, tp, tol = model
    prompt = _tokens(jcfg.vocab, (2, 16), 13)
    jx, (jk, jv) = jax.jit(
        lambda p, t: jt.forward_with_kv(p, t, jcfg, J_PAR))(jp, prompt)
    tx, (tk, tv) = tt.forward_with_kv(tp, prompt, tcfg, PAR)
    for a, b in ((tx, jx), (tk, jk), (tv, jv)):
        _close(a, b, tol)
    jcache = jt.init_cache(jcfg, 2, 24)
    tcache = tt.init_cache(tcfg, 2, 24, device="cpu")
    jdec = jax.jit(lambda p, c, t, n: jt.decode_step(p, c, t, n, jcfg,
                                                     J_PAR))
    valid = 0
    for step, width in enumerate((16, 1, 1, 3)):
        tok = prompt if step == 0 else _tokens(jcfg.vocab, (2, width),
                                               14 + step)
        valid += tok.shape[1]
        jlog, jcache = jdec(jp, jcache, tok, jnp.int32(valid))
        tlog, tcache = tt.decode_step(tp, tcache, tok, valid, tcfg, PAR)
        _close(tlog, jlog, tol)
        for a, b in zip(tcache, jcache):
            _close(a, b, tol)


@requires_modern_sharding
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decoder_gradient(arch):
    """``lm_loss``'s gradient of every parameter, the router and the
    experts among them, at the float32 smoke config (remat on), against
    ``jax.grad``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    batch = {"tokens": _tokens(jcfg.vocab, (2, 17), 15)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(p, batch, jcfg, J_PAR)))(jp)
    flat = {jax.tree_util.keystr(p): v.requires_grad_(True)
            for p, v in jax.tree_util.tree_leaves_with_path(tp)}
    tp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                      list(flat.values()))
    loss = tt.lm_loss(tp, batch, tcfg, PAR)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(jg)}
    assert "['layers']['router']" in want
    for name, g in zip(flat, grads):
        _close(g, want[name], TOL["float32"])


def test_init_params_draws_the_experts():
    """An MoE config's weights: the router and experts at 0.02, ``we_out``
    at 0.02 / sqrt(2 L), no dense MLP; the same generator seed gives the
    same draws."""
    cfg = get("qwen3_moe_235b_a22b").smoke_config
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ls = p["layers"]
    assert "w_gate" not in ls and ls["we_in"].shape == (2, 8, 64, 48)
    for name in ("router", "we_gate", "we_in"):
        assert abs(float(ls[name].std()) - 0.02) < 2e-3, name
    out_sig = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(float(ls["we_out"].std()) - out_sig) < 0.1 * out_sig
    again = tt.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["layers"]["we_out"], ls["we_out"])
