"""SASRec (self-attentive sequential recommendation): the serving path.

The port of ``src/repro/models/recsys.py`` on one device: the model, online
scoring against the whole item table (serve_p99), the chunked running
top-k (serve_bulk) and candidate retrieval through the embedding-bag kernel
(retrieval_cand). The parameters are a dict of tensors under the JAX
package's keys (``item_emb``, ``pos_emb``, ``blocks[i]["wq"]`` ...); every
function runs on the device its parameters lie on. The multi-card
``shard_map`` branches and ``param_specs`` wait for the multi-card slice,
``sasrec_train_loss`` for the training slice.

Float32 products go to ``torch.matmul``, which runs them in full float32
unless the caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``,
off by default).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.datastructs import resolve_device, take_fill
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.layers import chunked_causal_attention

#: the weights of one block, in the order ``init_sasrec`` draws them
BLOCK_MATRICES = ("wq", "wk", "wv", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    """The JAX package's config less ``scan_unroll``, its dry-run analysis
    mode (unrolled scans for HLO cost analysis), which eager PyTorch has no
    use for."""

    name: str = "sasrec"
    n_items: int = 1 << 20  # 2^20 rows: divisible by 16-way model sharding
    d: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def init_sasrec(cfg: SASRecConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights as the JAX package draws them (normal, the item and
    position tables scaled by 0.02, the matrices by d^-0.5; norms at one),
    from ``generator`` on its own device, then moved to ``device`` (the
    card unless named). Row 0 of ``item_emb`` is the padding item."""
    dev = resolve_device(device)
    dt = cfg.dtype
    d = cfg.d

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=generator.device).to(dev)

    params = {"item_emb": normal(cfg.n_items, d) * 0.02,
              "pos_emb": normal(cfg.seq_len, d) * 0.02, "blocks": []}
    for _ in range(cfg.n_blocks):
        blk = {name: normal(d, d) * d ** -0.5 for name in BLOCK_MATRICES}
        blk["ln1"] = torch.ones(d, dtype=dt, device=dev)
        blk["ln2"] = torch.ones(d, dtype=dt, device=dev)
        params["blocks"].append(blk)
    return params


def _ln(x, w, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # jnp.var: population
    return (x - mu) * torch.rsqrt(var + eps) * w


def _ids(params, ids) -> torch.Tensor:
    """Item ids as an int32 tensor on the parameters' device."""
    return torch.as_tensor(ids, dtype=torch.int32,
                           device=params["item_emb"].device)


def sasrec_hidden(params, seq, cfg: SASRecConfig) -> torch.Tensor:
    """seq: int32[B, S] item ids (0 = pad) -> hidden states [B, S, d]."""
    seq = _ids(params, seq)
    x = take_fill(params["item_emb"], seq.long()) * (cfg.d ** 0.5)
    x = x + params["pos_emb"][None, : seq.shape[1]]
    pad = (seq == 0)[..., None]
    x = torch.where(pad, 0, x)
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"])[:, :, None, :]  # single head
        k = (h @ blk["wk"])[:, :, None, :]
        v = (h @ blk["wv"])[:, :, None, :]
        attn = chunked_causal_attention(q, k, v, chunk=seq.shape[1])[:, :, 0]
        x = x + attn
        h2 = _ln(x, blk["ln2"])
        x = x + torch.relu(h2 @ blk["w1"]) @ blk["w2"]
        x = torch.where(pad, 0, x)
    return x


def sasrec_user_state(params, seq, cfg: SASRecConfig) -> torch.Tensor:
    """Last-position hidden state: the user's next-item query vector."""
    return sasrec_hidden(params, seq, cfg)[:, -1]


def serve_scores(params, seq, cfg: SASRecConfig) -> torch.Tensor:
    """Online serving (serve_p99): [B, n_items] scores in one product."""
    u = sasrec_user_state(params, seq, cfg)  # [B, d]
    return u @ params["item_emb"].T


def _order_keys(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One int64 key per value of float32 ``x`` at position ``pos``, unique
    and ordered as ``lax.top_k`` ranks: the value's bits as an
    order-preserving int32 (IEEE total order: negative floats' magnitude
    bits flipped, so -0.0 < +0.0 and NaN above +inf) above
    ``2^31 - 1 - pos``."""
    bits = x.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    keys <<= 32
    keys += (2**31 - 1) - pos
    return keys


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row of float32 ``x`` and their positions,
    in ``lax.top_k``'s order: descending by IEEE total order (NaN first,
    +0.0 before -0.0) and, among equal values, the lower position first.
    ``torch.topk`` promises no order among ties. Its selection is the right
    set unless the (k+1)-th value equals the k-th (ties cross the k-th
    place; +0.0 equals -0.0 there) or the row holds a NaN (``torch.topk``
    puts every NaN first, a negative NaN too): those rows are selected
    again by unique int64 keys (``_order_keys``), and the k are then put
    in order by the same keys."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    vals, pos = torch.topk(rows, min(k + 1, n), dim=-1)
    edge = vals[:, k - 1]
    split = vals[:, 0].isnan()
    if n > k:
        split |= vals[:, k] == edge
    pos = pos[:, :k]
    if bool(split.any()):
        at = split.nonzero()[:, 0]
        every = torch.arange(n, device=x.device)
        pos[at] = torch.topk(_order_keys(rows[at], every), k, dim=-1).indices
    order = torch.topk(_order_keys(torch.gather(rows, -1, pos), pos), k,
                       dim=-1).indices
    pos = torch.gather(pos, -1, order).reshape(*x.shape[:-1], k)
    return torch.gather(x, -1, pos), pos


def _chunked_topk(u, rows_tbl, id_base: int, k: int, n_chunks: int):
    """Running top-k of ``u @ rows_tbl.T`` over row chunks: the JAX
    package's ``local_chunked_topk``, its scan a loop. The state starts at
    -inf scores with ids 0; the chunk count drops until it divides the
    rows. Ties go to the lower position (``top_k``): the state's ids lie
    below the chunk's."""
    rows, d = rows_tbl.shape
    nc = max(min(n_chunks, rows), 1)
    while rows % nc:
        nc -= 1
    chunk = rows // nc
    b = u.shape[0]
    best_s = torch.full((b, k), float("-inf"), device=u.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=u.device)
    for j in range(nc):
        s = (u @ rows_tbl[j * chunk:(j + 1) * chunk].T).float()  # [B, chunk]
        ids = id_base + j * chunk + torch.arange(chunk, dtype=torch.int32,
                                                 device=u.device)
        cat_s = torch.cat([best_s, s], dim=-1)
        cat_i = torch.cat([best_i, ids.expand(b, chunk)], dim=-1)
        best_s, pos = top_k(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def serve_bulk_topk(params, seq, cfg: SASRecConfig, k: int = 100,
                    n_chunks: int = 64, n_shards: int | None = None):
    """Offline scoring (serve_bulk): a running top-k over ``n_chunks`` row
    chunks of each of ``n_shards`` row shards of the table, then one top-k
    over the shards' survivors, so the [B, n_items] scores never exist.
    Returns (scores f32[B, k], item ids int32[B, k]), best first."""
    u = sasrec_user_state(params, seq, cfg)  # [B, d]
    tbl = params["item_emb"]
    nsh = n_shards or 1
    rows = tbl.shape[0] // nsh
    parts = [_chunked_topk(u, tbl[s * rows:(s + 1) * rows], s * rows, k,
                           n_chunks) for s in range(nsh)]
    ms = torch.cat([p[0] for p in parts], dim=-1)
    mi = torch.cat([p[1] for p in parts], dim=-1)
    top_s, pos = top_k(ms, k)
    return top_s, torch.gather(mi, 1, pos)


def retrieval_scores(params, history, hist_mask, candidates,
                     cfg: SASRecConfig) -> torch.Tensor:
    """retrieval_cand: one (or few) users against many candidate ids. The
    user vector is the mean of the history's item rows under ``hist_mask``
    (the embedding-bag kernel on the card), dotted with each candidate's
    row: f32[B, C]."""
    tbl = params["item_emb"]
    mask = torch.as_tensor(hist_mask, dtype=torch.bool, device=tbl.device)
    u = embedding_bag(tbl, _ids(params, history), mask, mode="mean")
    ce = take_fill(tbl, _ids(params, candidates).long())  # [C, d]
    return u.float() @ ce.T.float()
