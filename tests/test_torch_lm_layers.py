"""Port parity of the language model's layers on the CPU: ``rms_norm``,
``rope`` (and its frequency table), ``swiglu``, ``decode_attention`` and
``chunked_cross_entropy`` with its gradient, each against the JAX
package's function (jitted, as the model runs it) on the same numpy
inputs drawn from a seed.

Tolerances. Float32: 1e-6 relative with 1e-6 absolute for values of unit
scale, rope 2e-6 absolute up to position 32,767 (its angles are equal bit
for bit, since the frequency table is; what is left is the two libraries'
sin and cos, measured at 4.8e-7). Bfloat16: one unit in the last place of
bfloat16 (2^-8 relative), since both round a float32 result once; swiglu
2^-6, since its hidden product is rounded to bfloat16 in both before the
output product, so that one unit there becomes a few in the output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import layers as jl
from repro_torch.models import layers as tl

F32 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=2.0 ** -8, atol=2.0 ** -8)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def _np(x):
    return x.detach().float().numpy()


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 16)) * 3
    w = 1 + 0.1 * rng.standard_normal(16)
    want = jax.jit(jl.rms_norm)(_jnp(x, dtype), _jnp(w, dtype))
    got = tl.rms_norm(_t(x, getattr(torch, dtype)), _t(w, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def _jax_freq(dh, theta):
    """The reference's frequency table, its own expression in ``rope``,
    jitted as the model runs it."""
    half = dh // 2
    return np.asarray(jax.jit(
        lambda: theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half))())


@pytest.mark.parametrize("dh", [16, 128, 160])
@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_rope_freq_bit_for_bit(dh, theta):
    got = tl.rope_freq(dh, theta).numpy()
    want = _jax_freq(dh, theta)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_rope_freq_is_not_a_true_division():
    """d_head 160: a true float32 division by 80 gives other exponents than
    the jitted reference's product with the reciprocal, so the bit-for-bit
    test above has teeth."""
    half = 80
    naive = (1e6 ** (-(torch.arange(half, dtype=torch.float32) / half))
             ).numpy()
    assert (naive.view(np.int32) != _jax_freq(160, 1e6).view(np.int32)).sum()


@pytest.mark.parametrize("dh", [16, 128, 160])
def test_rope_up_to_position_32767(dh):
    rng = _rng(dh)
    q = rng.standard_normal((2, 64, 4, dh))
    k = rng.standard_normal((2, 64, 2, dh))
    pos = np.sort(rng.integers(0, 32768, (2, 64)), axis=1).astype(np.int32)
    pos[:, 0], pos[:, -1] = 0, 32767
    jq, jk = jax.jit(jl.rope)(_jnp(q, jnp.float32), _jnp(k, jnp.float32), pos)
    tq, tk = tl.rope(_t(q), _t(k), torch.tensor(pos))
    np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), rtol=0, atol=2e-6)


def test_rope_bfloat16():
    rng = _rng(2)
    q = rng.standard_normal((2, 8, 4, 16))
    k = rng.standard_normal((2, 8, 2, 16))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    jq, jk = jax.jit(jl.rope)(_jnp(q, jnp.bfloat16), _jnp(k, jnp.bfloat16),
                              pos)
    tq, tk = tl.rope(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                     torch.tensor(pos))
    assert tq.dtype == tk.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tq), np.asarray(jq, np.float32), **BF16)
    np.testing.assert_allclose(_np(tk), np.asarray(jk, np.float32), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = _rng(3)
    x = rng.standard_normal((2, 3, 16))
    wg, wi = (0.3 * rng.standard_normal((16, 24)) for _ in range(2))
    wo = 0.3 * rng.standard_normal((24, 16))
    want = jax.jit(jl.swiglu)(*(_jnp(a, dtype) for a in (x, wg, wi, wo)))
    got = tl.swiglu(*(_t(a, getattr(torch, dtype)) for a in (x, wg, wi, wo)))
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("sq,valid_len", [(1, 1), (1, 7), (1, 12), (3, 3),
                                          (3, 9), (3, 15), (2, 1)])
def test_decode_attention(sq, valid_len):
    """GQA (4 q heads on 2 kv heads) against a 12-row cache; ``valid_len``
    past the cache (15) and below the query count (1 with Sq 2: a query
    with no visible row gets the uniform average, as in JAX)."""
    rng = _rng(10 * sq + valid_len)
    q = rng.standard_normal((2, sq, 4, 16))
    kc = rng.standard_normal((2, 12, 2, 16))
    vc = rng.standard_normal((2, 12, 2, 16))
    want = jax.jit(jl.decode_attention)(*(_jnp(a, jnp.float32)
                                          for a in (q, kc, vc)),
                                        jnp.int32(valid_len))
    got = tl.decode_attention(_t(q), _t(kc), _t(vc), valid_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    got_t = tl.decode_attention(_t(q), _t(kc), _t(vc),
                                torch.tensor(valid_len, dtype=torch.int32))
    assert torch.equal(got, got_t)


def test_decode_attention_bfloat16():
    rng = _rng(4)
    q, kc, vc = (rng.standard_normal(s) for s in
                 ((2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    want = jax.jit(jl.decode_attention)(*(_jnp(a, jnp.bfloat16)
                                          for a in (q, kc, vc)),
                                        jnp.int32(9))
    got = tl.decode_attention(*(_t(a, torch.bfloat16) for a in (q, kc, vc)),
                              9)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("s,n_chunks", [(8, 4), (6, 4), (5, 8)])
def test_chunked_cross_entropy_and_gradient(s, n_chunks):
    """The loss and its gradients in x and the tied embedding; S = 6 with 4
    chunks falls to 3 chunks, S = 5 with 8 to 5, as in the reference."""
    rng = _rng(s)
    x = rng.standard_normal((2, s, 8))
    emb = rng.standard_normal((11, 8))
    tgt = rng.integers(-11, 11, (2, s)).astype(np.int32)  # negatives wrap
    jfn = jax.jit(jax.value_and_grad(
        lambda x, e: jl.chunked_cross_entropy(x, e, tgt, n_chunks), (0, 1)))
    jloss, (jgx, jge) = jfn(_jnp(x, jnp.float32), _jnp(emb, jnp.float32))
    tx, te = _t(x).requires_grad_(True), _t(emb).requires_grad_(True)
    loss = tl.chunked_cross_entropy(tx, te, torch.tensor(tgt), n_chunks)
    gx, ge = torch.autograd.grad(loss, (tx, te))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), **F32)
    np.testing.assert_allclose(_np(ge), np.asarray(jge), **F32)
    with torch.no_grad():
        again = tl.chunked_cross_entropy(_t(x), _t(emb), torch.tensor(tgt),
                                         n_chunks)
    np.testing.assert_allclose(again.item(), float(jloss), **F32)


@pytest.mark.parametrize("bad", [11, -12])
def test_chunked_cross_entropy_out_of_range_target_is_nan(bad):
    rng = _rng(5)
    x, emb = rng.standard_normal((2, 4, 8)), rng.standard_normal((11, 8))
    tgt = np.array([[0, 1, 2, bad], [4, 5, 6, 7]], np.int32)
    want = jl.chunked_cross_entropy(_jnp(x, jnp.float32),
                                    _jnp(emb, jnp.float32), tgt, 2)
    got = tl.chunked_cross_entropy(_t(x), _t(emb), torch.tensor(tgt), 2)
    assert np.isnan(float(want)) and np.isnan(got.item())
