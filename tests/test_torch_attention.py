"""Port parity of attention on the CPU: the port's plain flash attention
and its op against the JAX package's oracle and its Pallas kernel
(interpret mode), on the cases of tests/test_kernels.py; the port's
``chunked_causal_attention`` against the JAX layer in each of its three
branches. Inputs are made with numpy from a seed and handed to both.

Tolerances: 2e-5 in float32, 3e-2 in bf16 (the JAX tests' own; bf16
storage with float32 accumulation), 1e-5 for the chunked layer. The two
card kernels' arithmetic is emulated here and held under the card's gate,
``ops.ATTN_GATES``: bf16 (64-key tiles, probabilities split into two bf16
halves) and float32 (32-key tiles, both products in 3xTF32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.layers import chunked_causal_attention as j_chunked
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (
    ATTN_GATES,
    attention_bytes,
    attention_flops,
    attention_gate,
    flash_attention,
    kernel_path,
)
from repro_torch.kernels.flash_attention.ops import visible_pairs
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers
from repro_torch.models.layers import chunked_causal_attention

CASES = [
    # b, sq, skv, hq, hkv, d
    (2, 64, 64, 4, 2, 32),     # GQA group 2
    (1, 128, 128, 8, 1, 64),   # MQA
    (1, 1, 96, 4, 2, 32),      # decode: one query vs cache
    (2, 17, 63, 2, 2, 16),     # ragged, non-block-aligned
    (1, 256, 256, 2, 2, 128),  # d_head = 128
]


def _qkv(b, sq, skv, hq, hkv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(dtype),
            rng.normal(size=(b, skv, hkv, d)).astype(dtype),
            rng.normal(size=(b, skv, hkv, d)).astype(dtype))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(case, causal):
    q, k, v = _qkv(*case, seed=sum(case))
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(j_attention_ref(*jargs, causal=causal))
    pallas = np.asarray(flash_attention_pallas(*jargs, causal=causal,
                                               interpret=True, q_block=32,
                                               kv_block=32))
    np.testing.assert_allclose(pallas, want, atol=2e-5, rtol=2e-5)
    targs = tuple(map(torch.as_tensor, (q, k, v)))
    for fn in (attention_ref, flash_attention):
        got = fn(*targs, causal=causal)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16():
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _qkv(1, 64, 64, 4, 2, 32, seed=7))
    want = np.asarray(j_attention_ref(q, k, v), np.float32)
    pallas = np.asarray(flash_attention_pallas(q, k, v, interpret=True,
                                               q_block=32, kv_block=32),
                        np.float32)
    np.testing.assert_allclose(pallas, want, atol=3e-2, rtol=3e-2)
    targs = [torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
             for x in (q, k, v)]
    got = flash_attention(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


def test_flash_attention_custom_scale():
    q, k, v = _qkv(1, 24, 40, 4, 2, 16, seed=3)
    want = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      scale=0.37))
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), scale=0.37)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_rows_that_see_no_key_are_nan():
    """Causal with Sq > Skv: query rows 0 .. Sq-Skv-1 see no key. The
    oracle's -inf masking makes them NaN; the Pallas kernel's -1e30 gives
    finite values there (ROADMAP §C, noted in the reference). The port
    follows the oracle."""
    q, k, v = _qkv(1, 8, 4, 2, 1, 16, seed=11)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(j_attention_ref(*jargs))
    assert np.isnan(want[:, :4]).all() and np.isfinite(want[:, 4:]).all()
    pallas = np.asarray(flash_attention_pallas(*jargs, interpret=True,
                                               q_block=8, kv_block=8))
    assert np.isfinite(pallas).all()
    got = flash_attention(*map(torch.as_tensor, (q, k, v))).numpy()
    assert np.isnan(got[:, :4]).all()
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=2e-5, rtol=2e-5)


def test_flash_attention_validates_and_counts_no_cpu_launch():
    reset_launch_counts()
    q, k, v = map(torch.as_tensor, _qkv(1, 4, 4, 4, 2, 16, seed=1))
    k3 = k[:, :, :1].expand(1, 4, 3, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k3, k3)  # 4 query heads over 3 kv heads
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), v)
    assert flash_attention(q, k, v).shape == q.shape
    assert kernel_path("cpu") == "ref"
    assert launch_counts()["flash_attention_tf32x3"] == 0
    assert launch_counts()["flash_attention_mma"] == 0


def test_flash_attention_refuses_no_keys():
    """Skv = 0: the JAX oracle's zero-size max raises ValueError, and so
    does the op, before it dispatches."""
    q, k, v = _qkv(1, 3, 0, 2, 2, 16, seed=2)
    with pytest.raises(ValueError):
        j_attention_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    for causal in (False, True):
        with pytest.raises(ValueError, match="no keys"):
            flash_attention(*map(torch.as_tensor, (q, k, v)), causal=causal)


def test_attention_work_models():
    """The operations and bytes that chip_smoke's bounds divide."""
    assert visible_pairs(4, 4, causal=True) == 10
    assert visible_pairs(1, 96, causal=True) == 96
    assert visible_pairs(8, 4, causal=True) == 10  # rows 0-3 see nothing
    assert visible_pairs(3, 5, causal=False) == 15
    s = 8192
    assert attention_flops(1, s, s, 16, 128, True) == (
        4 * 128 * 16 * s * (s + 1) // 2)
    assert attention_bytes(32, 1, 32768, 16, 8, 128, 2) == (
        2 * 128 * 32 * (2 * 16 + 2 * 32768 * 8))


def _tiled_attention(q, k, v, scale, tile, scores, output):
    """A kernel's arithmetic in plain torch, causal: float32 scores
    ``scores(q, k_tile)`` and an online softmax over ``tile``-key tiles,
    each tile's probabilities multiplied into the rescaled output
    accumulator by ``output(alpha * o, p, v_tile)``; the running sum adds
    the unrounded p. Returns float32 [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              for x in (k, v))
    m = torch.full((b, hq, sq, 1), float("-inf"))
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    rows = torch.arange(sq)[:, None] + (skv - sq)
    for kv0 in range(0, skv, tile):
        kt, vt = kf[:, :, kv0:kv0 + tile], vf[:, :, kv0:kv0 + tile]
        s = scores(qf, kt) * scale
        keys = torch.arange(kv0, kv0 + kt.shape[2])[None, :]
        s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        seen = m_new > float("-inf")
        alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = output(o * alpha, p, vt)
        m = m_new
    return (o / l).transpose(1, 2)


def _split_p_attention(q, k, v, scale, tile=64):
    """The bf16 kernel's arithmetic (csrc/flash_attention_mma.cu): float32
    scores of bf16 inputs, the probabilities split into bf16 hi = bf16(p)
    and lo = bf16(p - hi), both multiplied by V; the output rounded once to
    bf16."""
    def output(o, p, vt):
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        return o + (hi @ vt + lo @ vt)

    return _tiled_attention(q, k, v, scale, tile,
                            lambda qf, kt: qf @ kt.transpose(-1, -2),
                            output).bfloat16()


def test_split_probabilities_meet_the_bf16_gate():
    """Why the kernel splits P: its tile-by-tile arithmetic with P carried
    as two bf16 halves meets the card's bf16 gate against the JAX oracle,
    and sits near the floor set by rounding the output to bf16."""
    b, s, hq, hkv, d = 1, 1024, 4, 2, 64
    q, k, v = (torch.as_tensor(x).bfloat16()
               for x in _qkv(b, s, s, hq, hkv, d, seed=15))
    want = j_attention_ref(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                             for x in (q, k, v)))
    want = torch.as_tensor(np.asarray(want, np.float32)).bfloat16()
    got = _split_p_attention(q, k, v, d ** -0.5)
    verdict = attention_gate(got, want)
    assert verdict["pass"], verdict
    assert verdict["rel_l2"] < 2e-4 < ATTN_GATES[torch.bfloat16]["rel_l2"]


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits): to nearest on the 13
    low bits, ties away from zero, as cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, split):
    """a @ b with TF32 operands: hi @ hi alone, or 3xTF32, hi = tf32(x)
    and lo = tf32(x - hi), lo @ hi + hi @ lo + hi @ hi (products of TF32
    values are exact in float32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


#: the float32 kernel's key order inside an m16n8k8 step of P V: k index t
#: is key 2t and k index t + 4 key 2t + 1 of each 8-key group
_K8_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _tf32x3_attention(q, k, v, scale, split=True, tile=32):
    """The float32 kernel's arithmetic (csrc/flash_attention_tf32x3.cu):
    both products in TF32, each operand split (or not, ``split=False``,
    one TF32 product as SDPA or cuBLAS with TF32 on), P and V paired in
    the kernel's key order."""
    def output(o, p, vt):
        order = torch.tensor([8 * (i // 8) + _K8_ORDER[i % 8]
                              for i in range(vt.shape[2])])
        return o + _tf32_product(p[..., order], vt[:, :, order], split)

    return _tiled_attention(
        q, k, v, scale, tile,
        lambda qf, kt: _tf32_product(qf, kt.transpose(-1, -2), split),
        output)


def test_tf32x3_meets_the_f32_gate():
    """Why the float32 kernel issues three TF32 products for each: its
    tile-by-tile arithmetic meets the card's float32 gate against the JAX
    oracle, far inside it, on a 1,024-long causal case with GQA at D 128;
    one TF32 product per product fails the same gate."""
    b, s, hq, hkv, d = 1, 1024, 4, 2, 128
    q, k, v = map(torch.as_tensor, _qkv(b, s, s, hq, hkv, d, seed=16))
    want = torch.as_tensor(np.array(j_attention_ref(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))))
    verdict = attention_gate(_tf32x3_attention(q, k, v, d ** -0.5), want)
    assert verdict["pass"], verdict
    assert verdict["worst_over_limit"] < 0.1, verdict
    assert verdict["rel_l2"] < 1e-6 < ATTN_GATES[torch.float32]["rel_l2"]
    single = attention_gate(_tf32x3_attention(q, k, v, d ** -0.5,
                                              split=False), want)
    assert not single["pass"] and single["worst_over_limit"] > 10, single


def _rz(x):
    """float64 ``x`` rounded toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_chain(acc, a, b, steps):
    """acc + a @ b as the tensor cores sum it in a model: k8 steps of three
    TF32 mma's each (lo·hi, hi·lo, hi·hi), every mma's float32 result
    rounded toward zero. ``steps`` k8 steps run into one accumulator,
    which is then added to ``acc`` in float32, to nearest; ``steps=None``:
    one chain that starts from ``acc``."""
    chain = acc if steps is None else torch.zeros_like(acc)
    for i, k0 in enumerate(range(0, a.shape[-1], 8)):
        a8, b8 = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        a_hi, b_hi = _tf32(a8), _tf32(b8)
        a_lo, b_lo = _tf32(a8 - a_hi), _tf32(b8 - b_hi)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            chain = _rz(chain.double() + x.double() @ y.double())
        if steps is not None and (i + 1) % steps == 0:
            acc, chain = acc + chain, torch.zeros_like(acc)
    return chain if steps is None else acc


@pytest.mark.parametrize("short", [True, False])
def test_tf32x3_short_mma_chains_absorb_truncation(short):
    """Why the float32 kernel keeps its mma chains short. In a model where
    the tensor cores round every float32 sum toward zero, an output summed
    through one accumulator over ~2,000 keys (and a score over all 16 k8
    steps of D 128) drifts past the float32 gate; the kernel's chains, one
    16-dim block of a score and one 32-key tile of an output, each added
    in float32 to nearest, stay far inside it."""
    b, sq, skv, hq, hkv, d = 1, 256, 2048, 2, 1, 128
    q, k, v = map(torch.as_tensor, _qkv(b, sq, skv, hq, hkv, d, seed=17))
    want = torch.as_tensor(np.array(j_attention_ref(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))))
    s_steps, o_steps = (2, 4) if short else (None, None)

    def output(o, p, vt):
        order = torch.tensor([8 * (i // 8) + _K8_ORDER[i % 8]
                              for i in range(vt.shape[2])])
        return _mma_chain(o, p[..., order], vt[:, :, order], o_steps)

    got = _tiled_attention(
        q, k, v, d ** -0.5, 32,
        lambda qf, kt: _mma_chain(torch.zeros(qf.shape[:-1] + kt.shape[2:3]),
                                  qf, kt.transpose(-1, -2), s_steps),
        output)
    verdict = attention_gate(got, want)
    if short:
        assert verdict["pass"] and verdict["worst_over_limit"] < 0.5, verdict
    else:
        assert not verdict["pass"], verdict


# --------------------------------------------------- chunked causal attention
@pytest.mark.parametrize("s,chunk,nch", [(12, 12, 1), (40, 8, 5),
                                         (40, 4, 10)])
@pytest.mark.parametrize("differentiable", [True, False])
def test_chunked_causal_attention_matches_jax(s, chunk, nch, differentiable):
    """nch = 1 (SASRec's call), 1 < nch <= 8 (the static triangle) and
    nch > 8 (the triangle under absolute masks when not differentiable,
    the full masked key scan when differentiable), with GQA group 2."""
    assert s // chunk == nch
    assert (nch > layers._MAX_STATIC_CHUNKS) == (nch == 10)
    q, k, v = _qkv(2, s, s, 4, 2, 16, seed=s + chunk)
    want = np.asarray(j_chunked(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                                differentiable=differentiable))
    got = chunked_causal_attention(*map(torch.as_tensor, (q, k, v)),
                                   chunk=chunk, differentiable=differentiable)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # causal attention: the flash oracle computes the same function
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)))),
        atol=1e-5, rtol=1e-5)


def test_chunked_causal_attention_unrolled_triangle():
    q, k, v = _qkv(1, 40, 40, 2, 2, 16, seed=4)
    want = np.asarray(j_chunked(*map(jnp.asarray, (q, k, v)), chunk=4,
                                unroll=True))
    got = chunked_causal_attention(*map(torch.as_tensor, (q, k, v)), chunk=4,
                                   unroll=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
