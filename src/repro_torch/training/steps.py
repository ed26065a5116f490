"""Step builders, ported from ``src/repro/training/steps.py``: a model
loss and AdamW as one train step, and the recsys serving steps.

Every builder returns functions of (params, opt_state, batch), pure
unless built with ``donate``, so a checkpoint of ``{"params", "opt"}`` is
the whole training state. The gradient comes from ``torch.autograd.grad``
over the param leaves; the step runs on the device its params lie on.
Params that are ``DTensor``s (placed by their specs on a ``DeviceMesh``)
train over the mesh: the gradient of a replicated leaf arrives partial
over the data axes and the AdamW update reduces it into the state's
placements (ZeRO-1 where the state is placed by ``zero1_specs``), as
GSPMD does.
The language model's train, prefill and decode steps, the graph networks'
train step in its three modes, and SASRec's steps are here.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.optim.tree import tree_leaves, tree_unflatten


def _train_step(loss_fn, opt_cfg: AdamWConfig, total_steps: int,
                warmup: int, donate: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with ``metrics`` = ``loss``, ``grad_norm`` and ``lr``. The schedule
    reads the step count before the update's increment, so step 0 has an
    lr of 0. With ``donate`` the step consumes the params and the state
    (``adamw_update``'s ``donate``)."""

    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with over_mesh(leaves):
            with torch.enable_grad():
                loss = loss_fn(tree_unflatten(params, leaves), batch)
                if isinstance(loss, DTensor):  # seed a whole, not a part
                    loss = loss.redistribute(
                        placements=[Replicate()] * loss.device_mesh.ndim)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            lr_scale = cosine_schedule(opt_state["step"], warmup=warmup,
                                       total=total_steps)
            with torch.no_grad():
                params, opt_state, metrics = adamw_update(
                    tree_unflatten(params, grads), opt_state, params,
                    opt_cfg, lr_scale, donate=donate)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step


def over_mesh(tree):
    """``implicit_replication()`` when ``tree`` holds a ``DTensor`` (a
    plain tensor the step makes, a position grid or a mask, then counts as
    replicated on the mesh, as a constant does under GSPMD), else
    nothing."""
    if any(isinstance(t, DTensor) for t in tree_leaves(tree)):
        return implicit_replication()
    return nullcontext()


# ------------------------------------------------------------------------- LM
def make_lm_train_step(cfg: tfm.LMConfig, par: tfm.Parallelism,
                       opt_cfg: AdamWConfig = AdamWConfig(),
                       total_steps: int = 10_000, warmup: int = 200, *,
                       donate: bool = False):
    """``step(params, opt_state, batch)`` -> (params, opt_state, metrics):
    ``lm_loss`` (cross entropy plus a mixture of experts' aux loss) and
    its gradient through every layer (each checkpointed under
    ``cfg.remat``), then AdamW under the cosine schedule. ``batch`` is
    ``{"tokens": int[B, S + 1]}``; ``adamw_init(params)`` gives the first
    state. With ``donate`` the step writes the new params and state into
    the given tensors (one copy of the state on the card, not two)."""

    def loss_fn(params, batch):
        return tfm.lm_loss(params, batch, cfg, par)

    return _train_step(loss_fn, opt_cfg, total_steps, warmup, donate)


def make_lm_prefill_step(cfg: tfm.LMConfig, par: tfm.Parallelism,
                         s_max: int):
    """``prefill(params, tokens)`` -> (float32 logits [B, V] of the last
    position, the KV cache ([L, B, s_max, KV, dh] x2, zeros past the
    prompt)): the serving prompt phase, chunked attention without a
    gradient."""

    @torch.no_grad()
    def prefill(params, tokens):
        with over_mesh(params):
            s = tokens.shape[1]
            x, (ck, cv) = tfm.forward_with_kv(params, tokens, cfg, par)
            logits = tfm.last_logits(params, x)
            pad = s_max - s
            if pad > 0:
                ck = F.pad(ck, (0, 0, 0, 0, 0, pad))
                cv = F.pad(cv, (0, 0, 0, 0, 0, pad))
            return logits, (ck, cv)

    return prefill


def make_lm_decode_step(cfg: tfm.LMConfig, par: tfm.Parallelism):
    """``decode(params, cache, tokens, valid_len)`` -> (float32 logits
    [B, V], the cache): ``transformer.decode_step``, which writes the new
    rows into the cache it is given."""

    @torch.no_grad()
    def decode(params, cache, tokens, valid_len):
        with over_mesh(params):
            return tfm.decode_step(params, cache, tokens, valid_len, cfg,
                                   par)

    return decode


# ------------------------------------------------------------------------ GNN
def make_gnn_train_step(cfg: gnn_mod.GNNConfig, par=None, mode: str = "full",
                        opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                        total_steps: int = 1000, warmup: int = 20):
    """``step(params, opt_state, batch)`` -> (params, opt_state, metrics)
    over a graph network's loss, in the reference's three modes:

    - ``full``: one graph (``feats``, ``src``, ``dst``, ``mask``,
      ``labels``, ``label_mask``), node-classification cross entropy; for
      egnn (``h``, ``x``, ``src``, ``dst``, ``mask``, ``target`` [1]) the
      squared error of the graph-level prediction;
    - ``sampled``: GraphSAGE on a ``NeighborSampler`` batch;
    - ``batched``: ``{"graphs": G stacked graphs, "targets": [G]}``, egnn's
      ``egnn_batch_loss``, or for the other archs the squared error of
      each graph's mean-pooled logit 0.
    """
    if mode == "full":
        if cfg.arch == "egnn":
            def loss_fn(params, batch):
                pred, _ = gnn_mod.egnn_forward(params, batch, cfg)
                target = torch.as_tensor(batch["target"], device=pred.device)
                return ((pred - target) ** 2).mean()
        else:
            def loss_fn(params, batch):
                return gnn_mod.node_classification_loss(params, batch, cfg,
                                                        par)
    elif mode == "sampled":
        def loss_fn(params, batch):
            return gnn_mod.sage_minibatch_loss(params, batch, cfg, par)
    elif mode == "batched":
        if cfg.arch == "egnn":
            def loss_fn(params, batch):
                return gnn_mod.egnn_batch_loss(params, batch, cfg, par)
        else:
            def loss_fn(params, batch):
                pooled = gnn_mod.batched_pooled_logits(
                    params, batch["graphs"], cfg)  # [G, C]
                targets = torch.as_tensor(batch["targets"],
                                          device=pooled.device)
                return ((pooled[:, 0] - targets) ** 2).mean()
    else:
        raise ValueError(mode)
    return _train_step(loss_fn, opt_cfg, total_steps, warmup)


# --------------------------------------------------------------------- recsys
def make_recsys_steps(cfg: rec_mod.SASRecConfig, par=None,
                      opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                      total_steps: int = 10_000, warmup: int = 100) -> dict:
    """``train(params, opt_state, batch)`` (``adamw_init(params)`` gives
    the first state; ``recsys_batches`` the batches) -> (params,
    opt_state, metrics); ``serve(params, seq)`` -> [B, n_items] scores;
    ``bulk(params, seq)`` -> top-100 (scores, ids) over 64 row chunks;
    ``retrieval(params, history, hist_mask, candidates)`` -> [B, C]
    scores. Each runs on the device of ``params`` (``init_sasrec`` and
    ``interop.sasrec_params_from_numpy`` put them on the card unless given
    ``device="cpu"``); with ``par`` on a mesh the serving steps run its
    multi-card branches."""

    def loss_fn(params, batch):
        return rec_mod.sasrec_train_loss(params, batch, cfg, par)

    train = _train_step(loss_fn, opt_cfg, total_steps, warmup)

    def serve(params, seq):
        return rec_mod.serve_scores(params, seq, cfg, par)

    def bulk(params, seq):
        return rec_mod.serve_bulk_topk(params, seq, cfg, par)

    def retrieval(params, history, hist_mask, candidates):
        return rec_mod.retrieval_scores(params, history, hist_mask,
                                        candidates, cfg, par)

    return {"train": train, "serve": serve, "bulk": bulk,
            "retrieval": retrieval}
