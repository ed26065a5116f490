"""The graph networks of ``src/repro/models/gnn.py`` on the gather and
segment-sum substrate: gather by edge source, transform, scatter by edge
destination (``index_add_`` and ``scatter_reduce_`` where the reference
calls ``jax.ops.segment_sum/max/min``). Edges are fixed-capacity masked
buffers, as there.

Archs: graphsage (mean aggregation, and the sampled fan-out mode), pna
(four aggregators by three degree scalers), egnn (E(n)-equivariant
coordinate updates), gatedgcn (edge-gated aggregation, 16 layers). The
parameters are a dict holding a list of layer dicts under the reference's
keys; every function runs on the device its parameters lie on, and a
numpy input is moved there.

Index semantics are the reference's, so a padded buffer whose masked slots
hold -1 or ``n`` gives JAX's answer:

- a gather (``h[src]``) wraps an index in ``[-n, -1]`` to ``n + i`` and
  clamps the rest into ``[0, n)``;
- a segment sum, max or min drops an id outside ``[0, n)``, negative ones
  included (the port adds into a dump row ``n``);
- an empty segment's max is -inf and its min +inf, which ``gather_scatter``
  turns into 0, while a node whose incoming edges are all masked keeps
  ``finfo.min`` or ``finfo.max``, which are finite.

The batched mode (``jax.vmap`` over G graphs in the reference) runs the G
graphs as one disjoint union: each graph's gather and drop rules are
applied to its own ids before they are offset, so an out-of-range id never
lands in the next graph. ``gatedgcn_forward``'s ``lax.scan`` over the
stacked layers is a loop over the list, in order. GraphSAGE's full-graph
aggregation gathers and adds ``EDGE_CHUNK`` edges at a time: the sums are
the same, and the gathered messages of an edge set of tens of millions
(E x d floats) never exist at once, in the forward or the backward pass.

``par``: the reference's ``node_classification_loss`` places the edge
buffers on the mesh's machine axes (``shard``), which changes no value; the
port takes ``par`` and computes on one device. The edge-sharded form over
ranks comes with training over a mesh (ROADMAP queue A 11.6).

Float32 products go to ``torch.matmul``, which runs them in full float32
unless the caller enables TF32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.graph.datastructs import resolve_device

#: edges GraphSAGE's full-graph aggregation gathers at once (2 GB of
#: float32 messages at its width of 128)
EDGE_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """The reference's config, field for field; ``dtype`` is a
    ``torch.dtype``. ``scan_unroll`` is the reference's dry-run analysis
    mode and changes nothing here."""

    name: str
    arch: str  # graphsage | pna | egnn | gatedgcn
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int = 16
    sample_sizes: tuple = ()  # graphsage minibatch fanouts, outer->inner
    pna_delta: float = 2.5  # E[log(deg+1)] normalizer
    param_dtype: str = "float32"
    scan_unroll: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _dense(gen: torch.Generator, din: int, dout: int, dt, sig=None):
    sig = sig or (1.0 / math.sqrt(din))
    return torch.randn((din, dout), generator=gen, dtype=dt,
                       device=gen.device) * sig


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor or an array a caller hands across) on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------- indices
def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 rows a JAX gather of ``idx`` from ``n`` rows reads: ``[-n,
    -1]`` wraps, then everything clamps into ``[0, n)``."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _scatter_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 rows a JAX segment op over ``n`` segments adds ``idx`` into:
    an id outside ``[0, n)`` goes to the dump row ``n``."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _segsum(vals: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """``vals`` summed into ``n`` segments by ``rows`` (``_scatter_index``'s,
    so ``n`` is the dump row)."""
    out = vals.new_zeros((n + 1, *vals.shape[1:]))
    return out.index_add_(0, rows, vals)[:n]


def _segext(vals: torch.Tensor, rows: torch.Tensor, n: int,
            reduce: str) -> torch.Tensor:
    """Segment max (``amax``) or min (``amin``) into ``n`` segments, an
    empty one -inf or +inf, as ``jax.ops.segment_max/min`` give it."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = vals.new_full((n + 1, *vals.shape[1:]), fill)
    index = rows.reshape(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    return out.scatter_reduce(0, index, vals, reduce)[:n]


@dataclasses.dataclass(frozen=True)
class _Edges:
    """A graph's (or a disjoint union's) edges with their indices
    resolved: ``src``/``dst`` the rows a gather reads, ``seg`` the rows a
    segment op adds into (``n`` for a dropped id), ``mask`` bool."""

    src: torch.Tensor
    dst: torch.Tensor
    seg: torch.Tensor
    mask: torch.Tensor
    n: int


def _edges(g: dict, n: int, device) -> _Edges:
    """The edges of ``g`` (``src``, ``dst``, ``mask``: [E], or [G, E] for G
    graphs of ``n`` nodes each, taken as one disjoint union)."""
    src = _tensor(g["src"], device)
    dst = _tensor(g["dst"], device)
    mask = _tensor(g["mask"], device, torch.bool)
    gsrc, gdst, seg = (_gather_index(src, n), _gather_index(dst, n),
                       _scatter_index(dst, n))
    if src.dim() == 1:
        return _Edges(gsrc, gdst, seg, mask, n)
    graphs = src.shape[0]
    total = graphs * n
    offs = (torch.arange(graphs, device=device) * n)[:, None]
    seg = torch.where(seg < n, seg + offs, total)
    return _Edges((gsrc + offs).reshape(-1), (gdst + offs).reshape(-1),
                  seg.reshape(-1), mask.reshape(-1), total)


def _nodes(x, device, dtype) -> torch.Tensor:
    """Node rows [n, F], or [G, n, F] flattened to the union's rows."""
    x = _tensor(x, device, dtype)
    return x.reshape(-1, x.shape[-1]) if x.dim() == 3 else x


def _graph(g: dict, key: str, device, dtype):
    """``g[key]``'s node rows (``_nodes``) and ``g``'s edges, of one graph
    or of the disjoint union of G stacked graphs."""
    x = _tensor(g[key], device, dtype)
    return _nodes(x, device, dtype), _edges(g, x.shape[-2], device)


# ---------------------------------------------------------------- aggregation
def _ext(h, e: _Edges, reduce: str):
    """``gather_scatter``'s max or min on resolved edges."""
    info = torch.finfo(h.dtype)
    fill = info.min if reduce == "amax" else info.max
    msg = torch.where(e.mask[:, None], torch.index_select(h, 0, e.src), fill)
    out = _segext(msg, e.seg, e.n, reduce)
    return torch.where(torch.isfinite(out), out, 0)


def segment_mean(vals, ids, n, mask):
    """(per-segment mean of the masked ``vals``, each segment's count of
    unmasked entries): ``ids`` outside ``[0, n)`` dropped."""
    rows = _scatter_index(ids, n)
    w = mask.to(vals.dtype)
    s = _segsum(vals * w[:, None], rows, n)
    c = _segsum(w, rows, n)
    return s / torch.clamp(c[:, None], min=1.0), c


def gather_scatter(h, src, dst, mask, n, reduce="sum"):
    """``h[src]`` of the unmasked edges reduced into ``dst``'s segments:
    ``sum`` (masked edges add 0), ``max`` or ``min`` (masked edges read
    ``finfo.min`` or ``finfo.max``; an empty or non-finite segment reads
    0)."""
    e = _Edges(_gather_index(src, h.shape[0]), _gather_index(dst, n),
               _scatter_index(dst, n), mask, n)
    if reduce == "sum":
        msg = torch.index_select(h, 0, e.src)
        return _segsum(torch.where(mask[:, None], msg, 0), e.seg, n)
    if reduce in ("max", "min"):
        return _ext(h, e, "amax" if reduce == "max" else "amin")
    raise ValueError(reduce)


def _gather_add(out, rows_in, rows_out, vals, w):
    """``out[rows_out[e]] += vals[rows_in[e]] * w[e]`` over every edge e,
    ``EDGE_CHUNK`` edges at a time, in edge order."""
    for at in range(0, rows_in.shape[0], EDGE_CHUNK):
        part = slice(at, at + EDGE_CHUNK)
        msg = torch.index_select(vals, 0, rows_in[part]) * w[part, None]
        out.index_add_(0, rows_out[part], msg)
    return out


class _WeightedGatherSum(torch.autograd.Function):
    """[n + 1, d]: the sum over edges of ``h[src] * w`` into row ``seg``
    (row n the dump). Autograd's ``index_add_`` would keep every chunk's
    messages for its backward (E x d floats, 32 GB at ogb_products); this
    keeps the indices and the weights only, and its backward gathers the
    output's gradient by ``seg`` and adds it into ``src``'s rows, a chunk at
    a time."""

    @staticmethod
    def forward(ctx, h, src, seg, w, n):
        ctx.save_for_backward(src, seg, w)
        ctx.rows = h.shape[0]
        return _gather_add(h.new_zeros((n + 1, h.shape[1])), src, seg, h, w)

    @staticmethod
    def backward(ctx, g):
        src, seg, w = ctx.saved_tensors
        gh = _gather_add(g.new_zeros((ctx.rows, g.shape[1])), seg, src, g, w)
        return gh, None, None, None, None


def _mean_aggregate(h, e: _Edges):
    """``segment_mean(h[src], dst, n, mask)[0]``, the masked messages
    gathered and added ``EDGE_CHUNK`` edges at a time in both passes."""
    w = e.mask.to(h.dtype)
    s = _WeightedGatherSum.apply(h, e.src, e.seg, w, e.n)
    c = _segsum(w, e.seg, e.n)
    return s[:e.n] / torch.clamp(c[:, None], min=1.0)


def _l2_normalize(h):
    """h over max(|h|, 1e-6) per row (``jnp.linalg.norm``'s sum of
    squares; an all-zero row's gradient is 0, as in the reference)."""
    norm = torch.sqrt((h * h).sum(-1, keepdim=True))
    return h / torch.clamp(norm, min=1e-6)


# ------------------------------------------------------------------ GraphSAGE
def init_graphsage(cfg: GNNConfig, generator: torch.Generator,
                   device=None) -> dict:
    dt, dev = cfg.dtype, resolve_device(device)
    lay = []
    din = cfg.d_feat
    for _ in range(cfg.n_layers):
        dout = cfg.d_hidden
        lay.append({"w_self": _dense(generator, din, dout, dt).to(dev),
                    "w_nb": _dense(generator, din, dout, dt).to(dev)})
        din = dout
    return {"layers": lay,
            "w_out": _dense(generator, din, cfg.n_classes, dt).to(dev)}


def _graphsage(params, h, e: _Edges):
    for lp in params["layers"]:
        nb = _mean_aggregate(h, e)
        h = _l2_normalize(F.relu(h @ lp["w_self"] + nb @ lp["w_nb"]))
    return h @ params["w_out"]


def graphsage_forward(params, g, cfg: GNNConfig):
    """Full-graph mode: g = {feats, src, dst, mask}. Here and in the
    other node-classification forwards, [G, n, F] feats with [G, E] edges
    are G graphs taken as one disjoint union: logits [G * n, C]."""
    dev = params["w_out"].device
    h, e = _graph(g, "feats", dev, cfg.dtype)
    return _graphsage(params, h, e)


def graphsage_sampled_forward(params, batch, cfg: GNNConfig):
    """Sampled mode: batch = {x0 [B,F], x1 [B,f1,F], x2 [B,f1,f2,F]} with
    masks m1 [B,f1], m2 [B,f1,f2] — the fan-out tensors of
    ``data/sampler.py::NeighborSampler`` (minibatch_lg)."""
    dev = params["w_out"].device
    x0, x1, x2 = (_tensor(batch[k], dev) for k in ("x0", "x1", "x2"))
    m1, m2 = (_tensor(batch[k], dev, torch.bool) for k in ("m1", "m2"))
    l1, l2 = params["layers"][0], params["layers"][1]

    def sage(lp, h_self, h_nb, m):
        mf = m.to(h_nb.dtype)
        nb = (h_nb * mf[..., None]).sum(-2) / torch.clamp(
            mf.sum(-1, keepdim=True), min=1.0)
        return _l2_normalize(F.relu(h_self @ lp["w_self"]
                                    + nb @ lp["w_nb"]))

    h1_nb = sage(l1, x1, x2, m2)  # [B, f1, H]
    h0_self = sage(l1, x0, x1, m1)  # [B, H]
    h0 = sage(l2, h0_self, h1_nb, m1)  # [B, H]
    return h0 @ params["w_out"]


# ------------------------------------------------------------------------ PNA
PNA_AGGS = ("mean", "max", "min", "std")


def init_pna(cfg: GNNConfig, generator: torch.Generator,
             device=None) -> dict:
    dt, dev = cfg.dtype, resolve_device(device)
    lay = []
    din = cfg.d_feat
    for _ in range(cfg.n_layers):
        lay.append({"w": _dense(generator, din * len(PNA_AGGS) * 3 + din,
                                cfg.d_hidden, dt).to(dev),
                    "ln": torch.ones((cfg.d_hidden,), dtype=dt, device=dev)})
        din = cfg.d_hidden
    return {"layers": lay,
            "w_out": _dense(generator, din, cfg.n_classes, dt).to(dev)}


def _pna(params, h, e: _Edges, cfg: GNNConfig):
    w = e.mask.to(h.dtype)
    deg = _segsum(w, e.seg, e.n)
    for lp in params["layers"]:
        hs = torch.index_select(h, 0, e.src)
        mean = _segsum(hs * w[:, None], e.seg, e.n) / torch.clamp(
            deg[:, None], min=1.0)
        mx, mn = _ext(h, e, "amax"), _ext(h, e, "amin")
        sq = _segsum(hs ** 2 * w[:, None], e.seg, e.n) / torch.clamp(
            deg[:, None], min=1.0)
        std = torch.sqrt(torch.clamp(sq - mean ** 2, min=0) + 1e-6)
        aggs = torch.cat([mean, mx, mn, std], dim=-1)  # [N, 4*D]
        logd = torch.log(deg + 1.0)[:, None]
        scaled = torch.cat([aggs, aggs * (logd / cfg.pna_delta),
                            aggs * (cfg.pna_delta
                                    / torch.clamp(logd, min=1e-6))], dim=-1)
        h = F.relu(_ln(torch.cat([h, scaled], dim=-1) @ lp["w"], lp["ln"]))
    return h @ params["w_out"]


def pna_forward(params, g, cfg: GNNConfig):
    dev = params["w_out"].device
    h, e = _graph(g, "feats", dev, cfg.dtype)
    return _pna(params, h, e, cfg)


# ----------------------------------------------------------------------- EGNN
def init_egnn(cfg: GNNConfig, generator: torch.Generator,
              device=None) -> dict:
    dt, dev = cfg.dtype, resolve_device(device)
    d = cfg.d_hidden
    lay = []
    for _ in range(cfg.n_layers):
        lay.append({"phi_e1": _dense(generator, 2 * d + 1, d, dt).to(dev),
                    "phi_e2": _dense(generator, d, d, dt).to(dev),
                    "phi_x": _dense(generator, d, 1, dt, sig=1e-3).to(dev),
                    "phi_h": _dense(generator, 2 * d, d, dt).to(dev)})
    return {"embed": _dense(generator, cfg.d_feat, d, dt).to(dev),
            "layers": lay, "w_out": _dense(generator, d, 1, dt).to(dev)}


def _egnn(params, h, x, e: _Edges):
    """(per-node readout h @ w_out [N, 1], coordinates [N, 3])."""
    h = h @ params["embed"]
    wmask = e.mask[:, None]
    deg = _segsum(e.mask.to(x.dtype), e.seg, e.n)
    for lp in params["layers"]:
        diff = (torch.index_select(x, 0, e.src)
                - torch.index_select(x, 0, e.dst))  # [E, 3]
        d2 = (diff * diff).sum(-1, keepdim=True)
        m_in = torch.cat([torch.index_select(h, 0, e.src),
                          torch.index_select(h, 0, e.dst), d2], dim=-1)
        m = F.silu(F.silu(m_in @ lp["phi_e1"]) @ lp["phi_e2"])
        m = torch.where(wmask, m, 0)
        # coordinate update (equivariant): x_i += mean_j (x_i-x_j) * phi_x(m_ij)
        cw = m @ lp["phi_x"]  # [E, 1]
        cmsg = torch.where(wmask, -diff * cw, 0)  # direction into dst
        agg_x = _segsum(cmsg, e.seg, e.n)
        x = x + agg_x / torch.clamp(deg[:, None], min=1.0)
        # feature update
        agg_m = _segsum(m, e.seg, e.n)
        h = h + F.silu(torch.cat([h, agg_m], dim=-1) @ lp["phi_h"])
    return h @ params["w_out"], x


def egnn_forward(params, g, cfg: GNNConfig):
    """One graph: g = {h [n,F], x [n,3], src, dst, mask}. Returns (scalar
    prediction [1], coords [n, 3]) — E(n)-equivariant coordinate
    updates."""
    dev = params["w_out"].device
    h, e = _graph(g, "h", dev, cfg.dtype)
    out, x = _egnn(params, h, _nodes(g["x"], dev, cfg.dtype), e)
    return out.sum(0), x  # graph-level readout


# ------------------------------------------------------------------- GatedGCN
def init_gatedgcn(cfg: GNNConfig, generator: torch.Generator,
                  device=None) -> dict:
    dt, dev = cfg.dtype, resolve_device(device)
    d = cfg.d_hidden
    lay = []
    for _ in range(cfg.n_layers):
        lp = {k: _dense(generator, d, d, dt).to(dev)
              for k in ("A", "B", "C", "U", "V")}
        lp["ln_h"] = torch.ones((d,), dtype=dt, device=dev)
        lp["ln_e"] = torch.ones((d,), dtype=dt, device=dev)
        lay.append(lp)
    return {"embed": _dense(generator, cfg.d_feat, d, dt).to(dev),
            "e_embed": torch.zeros((d,), dtype=dt, device=dev),
            "layers": lay,
            "w_out": _dense(generator, d, cfg.n_classes, dt).to(dev)}


def _ln(x, w, eps=1e-5):
    """Layer norm without a bias; the variance is the population's
    (``jnp.var``)."""
    mu = x.mean(-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * w


def _gatedgcn(params, h, e: _Edges, cfg: GNNConfig):
    h = h @ params["embed"]
    edge = params["e_embed"].expand(e.src.shape[0], cfg.d_hidden)
    for lp in params["layers"]:  # the reference's lax.scan, in order
        hs = torch.index_select(h, 0, e.src)
        eh = (hs @ lp["A"] + torch.index_select(h, 0, e.dst) @ lp["B"]
              + edge @ lp["C"])
        gate = torch.where(e.mask[:, None], torch.sigmoid(eh), 0)
        num = _segsum(gate * (hs @ lp["V"]), e.seg, e.n)
        den = _segsum(gate, e.seg, e.n)
        h_new = h @ lp["U"] + num / (den + 1e-6)
        h = h + F.relu(_ln(h_new, lp["ln_h"]))  # residual
        edge = edge + F.relu(_ln(eh, lp["ln_e"]))
    return h @ params["w_out"]


def gatedgcn_forward(params, g, cfg: GNNConfig):
    dev = params["w_out"].device
    h, e = _graph(g, "feats", dev, cfg.dtype)
    return _gatedgcn(params, h, e, cfg)


# ------------------------------------------------------------------ dispatch
INITS = {
    "graphsage": init_graphsage,
    "pna": init_pna,
    "egnn": init_egnn,
    "gatedgcn": init_gatedgcn,
}
FORWARDS = {
    "graphsage": graphsage_forward,
    "pna": pna_forward,
    "gatedgcn": gatedgcn_forward,
}


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device=None):
    """``cfg.arch``'s weights drawn from ``generator`` on its own device, in
    ``cfg``'s dtype, then moved to ``device`` (the card unless named)."""
    return INITS[cfg.arch](cfg, generator, device)


def _gold_logp(logits, labels):
    """log_softmax(logits) in float32 at each row's label, as
    ``take_along_axis``'s fill mode reads it (a label outside ``[0, C)``
    after wrapping ``[-C, -1]`` reads NaN)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    c = logp.shape[-1]
    lab = labels.long()
    lab = torch.where(lab < 0, lab + c, lab)
    gold = logp.gather(-1, lab.clamp(0, c - 1)[:, None])[:, 0]
    return torch.where((lab >= 0) & (lab < c), gold, float("nan"))


def node_classification_loss(params, g, cfg: GNNConfig, par=None):
    """Full-graph training: cross entropy over the labelled nodes. ``par``
    changes no value (the module's docstring)."""
    logits = FORWARDS[cfg.arch](params, g, cfg)
    dev = logits.device
    gold = _gold_logp(logits, _tensor(g["labels"], dev))
    lm = _tensor(g["label_mask"], dev, torch.float32)
    return -(gold * lm).sum() / torch.clamp(lm.sum(), min=1.0)


def egnn_batch_loss(params, batch, cfg: GNNConfig, par=None):
    """Batched small graphs (molecule shape): MSE on the graph-level
    target. ``batch["graphs"]`` holds G graphs of n nodes stacked ([G, n,
    F], [G, n, 3], [G, E] ids and mask)."""
    dev = params["w_out"].device
    gs = batch["graphs"]
    h, e = _graph(gs, "h", dev, cfg.dtype)
    out, _ = _egnn(params, h, _nodes(gs["x"], dev, cfg.dtype), e)
    pred = out.reshape(gs["h"].shape[0], -1, 1).sum(1)
    targets = _tensor(batch["targets"], dev)
    return ((pred[:, 0] - targets) ** 2).mean()


def batched_pooled_logits(params, graphs: dict, cfg: GNNConfig):
    """[G, C]: each of the G stacked graphs' node-classification logits,
    mean-pooled over its nodes (``make_gnn_train_step``'s batched mode for
    the archs other than egnn)."""
    logits = FORWARDS[cfg.arch](params, graphs, cfg)
    return logits.reshape(graphs["feats"].shape[0], -1,
                          logits.shape[-1]).mean(1)


def sage_minibatch_loss(params, batch, cfg: GNNConfig, par=None):
    logits = graphsage_sampled_forward(params, batch, cfg)
    gold = _gold_logp(logits, _tensor(batch["labels"], logits.device))
    return -gold.mean()
