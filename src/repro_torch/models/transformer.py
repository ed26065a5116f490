"""The decoder-only language models (``src/repro/models/transformer.py``):
the decoder of the qwen3, stablelm, dbrx and qwen3-moe configs, its
prefill with the KV stacks, its loss, and the decode step against a KV
cache.

The parameters are a dict of tensors under the reference's keys, the layer
weights stacked over layers (``params["layers"]["wq"]``: [L, d, h_padded,
dh]) and head-major (``wq`` [d, h, dh], ``wo`` [h, dh, d]), as the
reference lays them out for its tensor parallelism. Where the reference
scans over the stacked layers, the port loops over them. Every function
runs on the device its parameters lie on; ``init_params`` and
``init_cache`` put them on the card unless given ``device="cpu"``.

The reference's ``shard`` calls (``with_sharding_constraint``) are the
identity in the port (``models/layers.py::shard``) and are left out. A
config with ``moe`` replaces each layer's MLP by ``models/moe.py``'s layer
(its experts ``we_gate``, ``we_in``, ``we_out`` and its ``router`` in the
layer stack); the layers' aux load-balance losses, summed in float32, come
out of ``forward`` and into ``lm_loss``.

Float32 products go to ``torch.matmul``, which runs them in full float32
unless the caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``,
off by default).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.graph.datastructs import resolve_device, take_fill
from repro_torch.models.layers import (
    chunked_causal_attention,
    chunked_cross_entropy,
    decode_attention,
    rms_norm,
    rope,
)
from repro_torch.models.moe import MoEConfig, make_moe_layer


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """A ``torch.distributed.device_mesh.DeviceMesh`` and its logical axis
    mapping: the data-parallel axes and the tensor-parallel (model) axis.
    CPU tests without a mesh: ``Parallelism.none()``."""

    mesh: Any = None
    dp_axes: tuple = ("pod", "data")
    tp_axis: str = "model"

    @staticmethod
    def none():
        return Parallelism(mesh=None, dp_axes=(), tp_axis=None)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's config, field for field. ``remat`` checkpoints each
    layer when a gradient is taken; ``scan_unroll`` (the reference's
    dry-run analysis mode) takes the static triangle in
    ``chunked_causal_attention``, as there."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: MoEConfig | None = None
    param_dtype: str = "bfloat16"
    attn_chunk: int = 1024
    loss_chunks: int = 8
    remat: bool = True
    # q heads padded per kv group so that the padded head count divides
    # the model axis (qwen3-14b: 40 heads -> 48); the padded lanes are
    # masked to exact zeros in the forward pass
    tp_align: int = 16
    scan_unroll: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def g_real(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def g_padded(self) -> int:
        """Padded q-heads per kv group: the least g' >= g with
        (n_kv_heads * g') % tp_align == 0."""
        g = self.g_real
        if self.tp_align <= 1:
            return g
        while (self.n_kv_heads * g) % self.tp_align:
            g += 1
        return g

    @property
    def h_padded(self) -> int:
        return self.n_kv_heads * self.g_padded

    def head_mask(self, device=None):
        """float32[h_padded] on ``device`` (the CPU unless named): 1 for
        real q heads, 0 for padded lanes; None when nothing is padded.
        Heads are kv-grouped: head index = kv * g_padded + j."""
        if self.h_padded == self.n_heads:
            return None
        j = torch.arange(self.h_padded, device=device) % self.g_padded
        return (j < self.g_real).float()

    def n_params(self) -> int:
        """Total parameter count (unpadded heads; for 6ND model FLOPs)."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        if self.moe:
            ffn = (d * self.moe.n_experts * self.moe.d_ff_expert * 3
                   + d * self.moe.n_experts)
        else:
            ffn = d * self.d_ff * 3
        norms = 2 * d + (2 * dh if self.qk_norm else 0)
        return self.n_layers * (attn + ffn + norms) + self.vocab * d + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (
            d * self.moe.n_experts * self.moe.d_ff_expert * 3)
        return dense + self.n_layers * d * self.moe.top_k * (
            self.moe.d_ff_expert * 3)


# --------------------------------------------------------------------- params
def param_shapes(cfg: LMConfig) -> dict:
    """Each parameter's shape, keyed as ``init_params``' tree."""
    d, dh, L = cfg.d_model, cfg.d_head, cfg.n_layers
    h, kv, f = cfg.h_padded, cfg.n_kv_heads, cfg.d_ff
    layers = {"attn_norm": (L, d), "wq": (L, d, h, dh),
              "wk": (L, d, kv, dh), "wv": (L, d, kv, dh),
              "wo": (L, h, dh, d), "mlp_norm": (L, d)}
    if cfg.qk_norm:
        layers["q_norm"] = (L, dh)
        layers["k_norm"] = (L, dh)
    if cfg.moe:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layers.update(router=(L, d, e), we_gate=(L, e, d, fe),
                      we_in=(L, e, d, fe), we_out=(L, e, fe, d))
    else:
        layers.update(w_gate=(L, d, f), w_in=(L, d, f), w_out=(L, f, d))
    return {"embed": (cfg.vocab, d), "final_norm": (d,), "layers": layers}


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights as the reference draws them (normal: 0.02, the
    output projections 0.02 / sqrt(2 L); norms at one), in ``cfg``'s dtype,
    from ``generator`` on its own device, then moved to ``device`` (the card
    unless named). The draws come in the reference's order (``wq``, ``wk``,
    ``wv``, ``wo``, then ``w_gate``, ``w_in``, ``w_out`` or, for a
    mixture of experts, ``router``, ``we_gate``, ``we_in``, ``we_out``; then
    ``embed``)."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    dt = cfg.dtype
    sig = 0.02
    out_sig = sig / math.sqrt(2 * cfg.n_layers)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=generator.device).mul_(scale).to(dev)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    ls = shapes["layers"]
    layers = {"attn_norm": ones(ls["attn_norm"]),
              "wq": normal(ls["wq"], sig), "wk": normal(ls["wk"], sig),
              "wv": normal(ls["wv"], sig), "wo": normal(ls["wo"], out_sig),
              "mlp_norm": ones(ls["mlp_norm"])}
    if cfg.qk_norm:
        layers["q_norm"] = ones(ls["q_norm"])
        layers["k_norm"] = ones(ls["k_norm"])
    ffn = (("router", sig), ("we_gate", sig), ("we_in", sig),
           ("we_out", out_sig)) if cfg.moe else (
        ("w_gate", sig), ("w_in", sig), ("w_out", out_sig))
    for name, scale in ffn:
        layers[name] = normal(ls[name], scale)
    return {"embed": normal(shapes["embed"], sig),
            "final_norm": ones(shapes["final_norm"]), "layers": layers}


def param_specs(cfg: LMConfig, par: Parallelism) -> dict:
    """Each parameter's partition spec in the port's tuple form (one entry
    per dimension: ``None`` or a mesh axis): q and o head-sharded over
    ``par.tp_axis``, k and v replicated, the FFN column/row-sharded, the
    embedding vocab-sharded."""
    tp = par.tp_axis
    layers = {"attn_norm": (None, None), "wq": (None, None, tp, None),
              "wk": (None, None, None, None), "wv": (None, None, None, None),
              "wo": (None, tp, None, None), "mlp_norm": (None, None)}
    if cfg.qk_norm:
        layers["q_norm"] = (None, None)
        layers["k_norm"] = (None, None)
    if cfg.moe:
        layers["router"] = (None, None, None)
        layers["we_gate"] = (None, tp, None, None)
        layers["we_in"] = (None, tp, None, None)
        layers["we_out"] = (None, tp, None, None)
    else:
        layers["w_gate"] = (None, None, tp)
        layers["w_in"] = (None, None, tp)
        layers["w_out"] = (None, tp, None)
    return {"embed": (tp, None), "final_norm": (None,), "layers": layers}


# -------------------------------------------------------------------- forward
def _attention_block(x, lp, cfg: LMConfig, par: Parallelism, positions,
                     cache=None, valid_len=None, return_kv=False,
                     differentiable=True):
    """One layer's attention. Without ``cache``: chunked causal attention
    over x's positions, and (``return_kv``) this layer's (k, v). With
    ``cache`` (this layer's [B, Smax, KV, dh] pair): k and v written into
    it in place at ``valid_len - S`` as ``lax.dynamic_update_slice`` places
    them (a negative start wraps by Smax, then the start is clamped into
    ``[0, Smax - S]``), then dense attention against it (positions and
    mask unwrapped and unclamped, as in the reference)."""
    s = x.shape[1]
    hmask = cfg.head_mask(x.device)

    hn = rms_norm(x, lp["attn_norm"])
    q = torch.einsum("bsd,dhk->bshk", hn, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, lp["wv"])
    if hmask is not None:
        # zero the padded q lanes so they are dead in forward and backward
        q = q * hmask[None, None, :, None].to(q.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    q, k = rope(q, k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None:
        o = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                     unroll=cfg.scan_unroll,
                                     differentiable=differentiable)
        if return_kv:
            new_cache = (k, v)
    else:
        ck, cv = cache
        smax = ck.shape[1]
        pos0 = valid_len - s
        pos0 = min(max(pos0 + smax if pos0 < 0 else pos0, 0), smax - s)
        ck[:, pos0:pos0 + s] = k
        cv[:, pos0:pos0 + s] = v
        o = decode_attention(q, ck, cv, valid_len)
        new_cache = (ck, cv)
    if hmask is not None:
        # padded lanes see a uniform softmax; mask them before wo
        o = o * hmask[None, None, :, None].to(o.dtype)
    return torch.einsum("bshk,hkd->bsd", o, lp["wo"]), new_cache


def _make_layer_fn(cfg: LMConfig, par: Parallelism, decode: bool,
                   return_kv: bool = False, differentiable: bool = True):
    """``layer(x, positions, lp, cache=None, valid_len=None)`` -> (x,
    this layer's (k, v) or its cache pair, or None; the layer's float32 aux
    loss, or None for a dense MLP)."""
    moe_layer = (make_moe_layer(par.mesh, par.dp_axes, par.tp_axis, cfg.moe)
                 if cfg.moe else None)

    def layer(x, positions, lp, cache=None, valid_len=None):
        if decode:
            attn_out, kv = _attention_block(x, lp, cfg, par, positions,
                                            cache=cache, valid_len=valid_len)
        else:
            attn_out, kv = _attention_block(x, lp, cfg, par, positions,
                                            return_kv=return_kv,
                                            differentiable=differentiable)
        x = x + attn_out
        hn = rms_norm(x, lp["mlp_norm"])
        if moe_layer is not None:
            ffn_out, aux = moe_layer(hn, lp["router"], lp["we_gate"],
                                     lp["we_in"], lp["we_out"])
        else:
            hmid = F.silu(hn @ lp["w_gate"]) * (hn @ lp["w_in"])
            ffn_out, aux = hmid @ lp["w_out"], None
        return x + ffn_out, kv, aux

    return layer


def _layer_params(params, i: int) -> dict:
    """Layer ``i``'s weights: views into the stacked tensors."""
    return {key: val[i] for key, val in params["layers"].items()}


def token_ids(tokens, device) -> torch.Tensor:
    """Token ids (a tensor, or an array a test hands across) as an int32
    tensor on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, np.int32))
    return tokens.to(device=device, dtype=torch.int32)


def _embed(params, tokens) -> torch.Tensor:
    """Token rows of the embedding, ``jnp.take``'s fill mode: an id outside
    ``[-V, V)`` gives a NaN row."""
    table = params["embed"]
    return take_fill(table, token_ids(tokens, table.device))


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    """int32[B, S]: ``start + arange(S)`` on every row."""
    return (start + torch.arange(s, dtype=torch.int32, device=device)
            ).expand(b, s)


def _run_layers(params, x, positions, layer, cfg: LMConfig, kv_out=None):
    """(x through every layer in order, the layers' aux losses summed in
    float32 from zero, in layer order); with ``kv_out`` (a pair of [L, B,
    S, KV, dh] tensors) each layer's (k, v) written into it. Under autograd
    with ``cfg.remat`` each layer is checkpointed (``jax.checkpoint``)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if remat:
            x, kv, aux_l = checkpoint(layer, x, positions, lp,
                                      use_reentrant=False)
        else:
            x, kv, aux_l = layer(x, positions, lp)
        if aux_l is not None:
            aux = aux + aux_l
        if kv_out is not None:
            kv_out[0][i] = kv[0]
            kv_out[1][i] = kv[1]
    return x, aux


def forward(params, tokens, cfg: LMConfig, par: Parallelism):
    """tokens: int[B, S] -> (final hidden [B, S, D], the layers' summed
    float32 aux loss: zero for a dense config)."""
    x = _embed(params, tokens)
    positions = _positions(*x.shape[:2], 0, x.device)
    x, aux = _run_layers(params, x, positions,
                         _make_layer_fn(cfg, par, decode=False), cfg)
    return rms_norm(x, params["final_norm"]), aux


def forward_with_kv(params, tokens, cfg: LMConfig, par: Parallelism):
    """Prefill forward: final hidden [B, S, D] and the per-layer KV stacks
    ([L, B, S, KV, dh] x2, in the parameters' dtype). Inference only: the
    block triangle of the attention takes its non-differentiable branch.
    The aux loss is dropped, as in the reference."""
    x = _embed(params, tokens)
    b, s = x.shape[:2]
    positions = _positions(b, s, 0, x.device)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    kv = (torch.empty(shape, dtype=x.dtype, device=x.device),
          torch.empty(shape, dtype=x.dtype, device=x.device))
    layer = _make_layer_fn(cfg, par, decode=False, return_kv=True,
                           differentiable=False)
    x, _ = _run_layers(params, x, positions, layer, cfg, kv_out=kv)
    return rms_norm(x, params["final_norm"]), kv


def lm_loss(params, batch, cfg: LMConfig, par: Parallelism,
            aux_weight: float = 0.01):
    """batch: {'tokens': int[B, S+1]} -> scalar loss (float32)."""
    tokens = token_ids(batch["tokens"], params["embed"].device)
    x, aux = forward(params, tokens[:, :-1], cfg, par)
    targets = tokens[:, 1:]
    ce = chunked_cross_entropy(x, params["embed"], targets, cfg.loss_chunks)
    return ce + aux_weight * aux / max(cfg.n_layers, 1)


def last_logits(params, x) -> torch.Tensor:
    """float32[B, V]: the last position's hidden state against the tied
    embedding, both in float32."""
    return x[:, -1, :].float() @ params["embed"].float().T


# --------------------------------------------------------------------- decode
def init_cache(cfg: LMConfig, batch: int, s_max: int, dtype=None,
               device=None) -> tuple:
    """Zero K and V caches, [L, B, Smax, KV, dh] each, in ``dtype`` (the
    config's unless named) on ``device`` (the card unless named)."""
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    dt, dev = dtype or cfg.dtype, resolve_device(device)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def cache_specs(cfg: LMConfig, par: Parallelism) -> tuple:
    """The caches' partition specs: batch over the data axes, sequence
    over the model axis (the reference's FlashDecoding layout); no data
    axes read ``None``, as ``PartitionSpec`` normalises them."""
    spec = (None, par.dp_axes or None, par.tp_axis, None, None)
    return spec, spec


def decode_step(params, cache, tokens, valid_len, cfg: LMConfig,
                par: Parallelism):
    """One serving step. tokens: int[B, S_new] (S_new = 1 for pure
    decode); ``valid_len`` (an int or a 0-d tensor): the valid positions
    after this step. Returns (float32 logits [B, V] of the last position,
    the cache).

    The cache (a pair of [L, B, Smax, KV, dh] tensors) is consumed, as if
    donated: the new rows are written into it in place, at ``valid_len -
    S_new`` placed as ``lax.dynamic_update_slice`` places it (a negative
    start wraps by Smax, then clamps into ``[0, Smax - S_new]``), and the
    same tensors are returned. A functional copy would double a cache of
    tens of GB. A mixture of experts' aux loss is dropped, as in the
    reference.
    """
    valid_len = int(valid_len)
    x = _embed(params, tokens)
    b, s = x.shape[:2]
    positions = _positions(b, s, valid_len - s, x.device)
    layer = _make_layer_fn(cfg, par, decode=True)
    ck, cv = cache
    for i in range(cfg.n_layers):
        x, _, _ = layer(x, positions, _layer_params(params, i),
                        cache=(ck[i], cv[i]), valid_len=valid_len)
    x = rms_norm(x, params["final_norm"])
    return last_logits(params, x), (ck, cv)
