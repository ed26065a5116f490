"""Port parity of attention on the CPU: the port's plain flash attention
and its op against the JAX package's oracle and its Pallas kernel
(interpret mode), on the cases of tests/test_kernels.py; the port's
``chunked_causal_attention`` against the JAX layer in each of its three
branches. Inputs are made with numpy from a seed and handed to both.

Tolerances: 2e-5 in float32, 3e-2 in bf16 (the JAX tests' own; bf16
storage with float32 accumulation), 1e-5 for the chunked layer. The bf16
kernel's arithmetic (64-key tiles, probabilities split into two bf16
halves) is emulated here and held under the card's gate,
``ops.ATTN_GATES``.
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
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["flash_attention_mma"] == 0


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


def _split_p_attention(q, k, v, scale, tile=64):
    """The bf16 kernel's arithmetic (csrc/flash_attention_mma.cu) in plain
    torch, causal: float32 scores of bf16 inputs, an online softmax over
    ``tile``-key tiles, the probabilities split into bf16 hi = bf16(p) and
    lo = bf16(p - hi), both multiplied by V into a float32 sum; the running
    sum adds the unrounded p; the output rounded once to bf16."""
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
        s = (qf @ kt.transpose(-1, -2)) * scale
        keys = torch.arange(kv0, kv0 + kt.shape[2])[None, :]
        s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        seen = m_new > float("-inf")
        alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        o = o * alpha + hi @ vt + lo @ vt
        m = m_new
    return (o / l).transpose(1, 2).bfloat16()


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
