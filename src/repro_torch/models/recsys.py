"""SASRec (self-attentive sequential recommendation), ported from
``src/repro/models/recsys.py``: the model, its training loss (BCE on one
sampled positive and one negative per position), online scoring against
the whole item table (serve_p99), the chunked running top-k (serve_bulk)
and candidate retrieval through the embedding-bag kernel (retrieval_cand).
The parameters are a dict of tensors under the JAX package's keys
(``item_emb``, ``pos_emb``, ``blocks[i]["wq"]`` ...); every function runs
on the device its parameters lie on, and the loss's gradient comes from
``torch.autograd``.

The multi-card branches take ``par``, a ``Parallelism`` whose mesh (a
``DeviceMesh``) has the model axis ``par.tp_axis``. The item table is
row-sharded over that axis (``param_specs``): a rank holds only its rows,
as a ``DTensor`` placed by ``checkpoint.reshard_checkpoint`` or as its
local ``[n_items / shards, d]`` tensor; every other parameter is whole on
every rank. Where the reference's ``shard_map`` splits an input over the
data axes, a rank is given the whole input and works on its block of it,
and it returns its block of the output. A lookup of item rows becomes the
local hits, zeros elsewhere, summed over the model group (each row lives
on one rank, so the sum is exact); the table is never gathered. These
branches serve; training over a mesh is not ported, and the lookup raises
if asked for a gradient there.

Float32 products go to ``torch.matmul``, which runs them in full float32
unless the caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``,
off by default).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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


def param_specs(cfg: SASRecConfig, par) -> dict:
    """Each parameter's partition spec (a tuple per dimension: ``None`` or
    a mesh axis): the item table row-sharded over ``par.tp_axis``, the
    rest replicated."""
    tp = par.tp_axis
    blk = {k: (None, None) for k in BLOCK_MATRICES}
    blk["ln1"] = (None,)
    blk["ln2"] = (None,)
    return {
        "item_emb": (tp, None),  # the big table: row-sharded
        "pos_emb": (None, None),
        "blocks": [dict(blk) for _ in range(cfg.n_blocks)],
    }


def _model_mesh(par):
    """``par``'s mesh if it has the model axis, else None (the meshless
    path, as the reference's ``tp in mesh.shape`` test)."""
    mesh = par.mesh if par is not None else None
    if mesh is None or par.tp_axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh


def _local(params: dict) -> dict:
    """The rank's local tensors of a parameter dict that may hold
    ``DTensor``s."""
    def one(t):
        return t.to_local() if isinstance(t, DTensor) else t

    out = {k: one(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: one(v) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


def _shard(mesh, par) -> tuple:
    """(this rank's shard index on the model axis, the shard count, the
    model axis's process group)."""
    return (mesh.get_local_rank(par.tp_axis), mesh.size(
        mesh.mesh_dim_names.index(par.tp_axis)), mesh.get_group(par.tp_axis))


def _dp_block(x, mesh, par):
    """This rank's block of ``x`` along its first dimension, split over
    the mesh's data axes in ``par.dp_axes``' order (row-major), as the
    reference's ``P(dp_axes)`` splits it."""
    names = mesh.mesh_dim_names
    index, size = 0, 1
    for a in par.dp_axes:
        if a in names:
            n = mesh.size(names.index(a))
            index, size = index * n + mesh.get_local_rank(a), size * n
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} "
                         f"data-parallel ranks")
    per = x.shape[0] // size
    return x[index * per:(index + 1) * per]


def _lookup(tbl: torch.Tensor, ids: torch.Tensor, par) -> torch.Tensor:
    """Rows ``ids`` (int64) of the item table: ``take_fill`` without a
    mesh. On a mesh ``tbl`` is this rank's rows: the hits it holds, zeros
    elsewhere, all-reduced (SUM) over the model group; an id outside the
    whole table reads NaN, as ``take_fill``'s."""
    mesh = _model_mesh(par)
    if mesh is None:
        return take_fill(tbl, ids)
    if torch.is_grad_enabled() and tbl.requires_grad:
        raise NotImplementedError("training over a mesh is not ported: the "
                                  "row-sharded lookup carries no gradient")
    sh, nsh, group = _shard(mesh, par)
    rows = tbl.shape[0]
    v = rows * nsh
    wrapped = torch.where(ids < 0, ids + v, ids)
    loc = wrapped - sh * rows
    hit = (loc >= 0) & (loc < rows)
    out = torch.where(hit[..., None], tbl[loc.clamp(0, rows - 1)], 0)
    dist.all_reduce(out, group=group)
    inside = (wrapped >= 0) & (wrapped < v)
    return torch.where(inside[..., None], out, float("nan"))


def _ln(x, w, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # jnp.var: population
    return (x - mu) * torch.rsqrt(var + eps) * w


def _ids(params, ids) -> torch.Tensor:
    """Item ids as an int32 tensor on the parameters' device."""
    return torch.as_tensor(ids, dtype=torch.int32,
                           device=params["item_emb"].device)


def sasrec_hidden(params, seq, cfg: SASRecConfig, par=None) -> torch.Tensor:
    """seq: int32[B, S] item ids (0 = pad) -> hidden states [B, S, d]. On a
    mesh: the hidden states of the sequences this rank was given."""
    if _model_mesh(par) is not None:
        params = _local(params)
    seq = _ids(params, seq)
    x = _lookup(params["item_emb"], seq.long(), par) * (cfg.d ** 0.5)
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


def sasrec_train_loss(params, batch, cfg: SASRecConfig,
                      par=None) -> torch.Tensor:
    """batch = {seq, pos, neg} each int32[B, S]; BCE on the sampled logits,
    averaged over the positions whose positive is not padding (at least
    one)."""
    if _model_mesh(par) is not None:
        params = _local(params)
    h = sasrec_hidden(params, batch["seq"], cfg, par)
    pos = _ids(params, batch["pos"]).long()
    pe = _lookup(params["item_emb"], pos, par)
    ne = _lookup(params["item_emb"], _ids(params, batch["neg"]).long(), par)
    lp = (h * pe).sum(-1).float()
    ln_ = (h * ne).sum(-1).float()
    valid = (pos != 0).float()
    loss = -(F.logsigmoid(lp) + F.logsigmoid(-ln_)) * valid
    return loss.sum() / valid.sum().clamp_min(1.0)


def sasrec_user_state(params, seq, cfg: SASRecConfig,
                      par=None) -> torch.Tensor:
    """Last-position hidden state: the user's next-item query vector."""
    return sasrec_hidden(params, seq, cfg, par)[:, -1]


def serve_scores(params, seq, cfg: SASRecConfig, par=None) -> torch.Tensor:
    """Online serving (serve_p99): [B, n_items] scores in one product. On a
    mesh: this rank's block, its data block of the users against its rows
    of the table ([B / dp, n_items / shards], the reference's
    ``P(dp, tp)``)."""
    if _model_mesh(par) is not None:
        params = _local(params)
        seq = _dp_block(seq, par.mesh, par)
    u = sasrec_user_state(params, seq, cfg, par)  # [B, d]
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


def serve_bulk_topk(params, seq, cfg: SASRecConfig, par=None, k: int = 100,
                    n_chunks: int = 64, n_shards: int | None = None):
    """Offline scoring (serve_bulk): a running top-k over ``n_chunks`` row
    chunks of each of ``n_shards`` row shards of the table, then one top-k
    over the shards' survivors, so the [B, n_items] scores never exist.
    Returns (scores f32[B, k], item ids int32[B, k]), best first.

    On a mesh each model shard is one of the row shards (``n_shards`` is
    not read): a rank runs the chunked top-k of its data block of the
    users over its own rows, the shards' [B / dp, k] survivors meet in one
    all-gather over the model group, and one top-k merges them in shard
    order. Returns this rank's data block of the result."""
    mesh = _model_mesh(par)
    if mesh is not None:
        params = _local(params)
        u = sasrec_user_state(params, _dp_block(seq, mesh, par), cfg, par)
        tbl = params["item_emb"]
        sh, nsh, group = _shard(mesh, par)
        rows = tbl.shape[0]
        ls, li = _chunked_topk(u, tbl, sh * rows, k, n_chunks)
        parts_s = [torch.empty_like(ls) for _ in range(nsh)]
        parts_i = [torch.empty_like(li) for _ in range(nsh)]
        dist.all_gather(parts_s, ls, group=group)
        dist.all_gather(parts_i, li, group=group)
        top_s, pos = top_k(torch.cat(parts_s, dim=-1), k)
        return top_s, torch.gather(torch.cat(parts_i, dim=-1), 1, pos)
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


def _bag_mean(tbl, history, mask, mesh, par) -> torch.Tensor:
    """The mean of each history's rows under ``mask`` over the row-sharded
    table: the embedding-bag kernel's ``sum`` of this rank's hits,
    all-reduced over the model group, over the mask's count (at least
    one), as the kernel's ``mean`` divides. An id outside the whole table
    reads the NaN row once (shard 0's local id ``rows``, outside its
    rows), as it reaches the reference's bag."""
    sh, nsh, group = _shard(mesh, par)
    rows = tbl.shape[0]
    v = rows * nsh
    ids = history.long()
    wrapped = torch.where(ids < 0, ids + v, ids)
    loc = wrapped - sh * rows
    hit = (loc >= 0) & (loc < rows)
    nan_here = ((wrapped < 0) | (wrapped >= v)) & (sh == 0)
    idx = torch.where(hit, loc, torch.where(nan_here, rows, 0))
    s = embedding_bag(tbl, idx.to(torch.int32), (mask & hit) | nan_here,
                      mode="sum")
    dist.all_reduce(s, group=group)
    return s / mask.sum(1, keepdim=True).clamp_min(1).to(s.dtype)


def retrieval_scores(params, history, hist_mask, candidates,
                     cfg: SASRecConfig, par=None) -> torch.Tensor:
    """retrieval_cand: one (or few) users against many candidate ids. The
    user vector is the mean of the history's item rows under ``hist_mask``
    (the embedding-bag kernel on the card), dotted with each candidate's
    row: f32[B, C].

    On a mesh: score, then combine. A rank dots the users against the
    candidates of its data block that its rows hold (zeros elsewhere) and
    the [B, C / dp] scores are all-reduced over the model group, not the
    gathered rows; it returns its data block of the columns. As in the
    reference's body, a candidate id outside the table scores 0 there."""
    mesh = _model_mesh(par)
    if mesh is not None:
        params = _local(params)
    tbl = params["item_emb"]
    mask = torch.as_tensor(hist_mask, dtype=torch.bool, device=tbl.device)
    if mesh is None:
        u = embedding_bag(tbl, _ids(params, history), mask, mode="mean")
        ce = take_fill(tbl, _ids(params, candidates).long())  # [C, d]
        return u.float() @ ce.T.float()
    u = _bag_mean(tbl, _ids(params, history), mask, mesh, par)
    sh, _, group = _shard(mesh, par)
    rows = tbl.shape[0]
    cand = _dp_block(_ids(params, candidates).long(), mesh, par)
    loc = cand - sh * rows
    hit = (loc >= 0) & (loc < rows)
    ce = torch.where(hit[:, None], tbl[loc.clamp(0, rows - 1)], 0.0)
    s = u.float() @ ce.T.float()  # [B, C / dp]
    dist.all_reduce(s, group=group)  # combine scores, not embeddings
    return s
