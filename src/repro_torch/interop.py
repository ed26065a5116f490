"""Edge buffers, model parameters and optimizer state across the package
boundary, as numpy arrays.

The JAX package and the port share no tensors; a test hands a JAX buffer,
parameter tree or AdamW state across as numpy arrays so that both
packages compute on identical input, and ``to_numpy`` hands the port's
back for the comparison.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.graph.datastructs import EdgeList, resolve_device
from repro_torch.optim.tree import tree_map

if TYPE_CHECKING:
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.models.recsys import SASRecConfig
    from repro_torch.models.transformer import LMConfig


def edgelist_from_numpy(src, dst, mask, n_nodes: int, device=None) -> EdgeList:
    """An ``EdgeList`` on ``device`` (the card unless named) holding the
    given int32 endpoints and bool mask."""
    dev = resolve_device(device)
    src = torch.tensor(np.asarray(src, np.int32), device=dev)
    dst = torch.tensor(np.asarray(dst, np.int32), device=dev)
    mask = torch.tensor(np.asarray(mask, np.bool_), device=dev)
    if not src.shape == dst.shape == mask.shape:
        raise ValueError(f"src, dst, mask shapes differ: {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(mask.shape)}")
    return EdgeList(src, dst, mask, int(n_nodes))


def edgelist_to_numpy(el: EdgeList):
    """Host copies ``(src, dst, mask)`` of the whole buffer, padding included."""
    return el.src.cpu().numpy(), el.dst.cpu().numpy(), el.mask.cpu().numpy()


def sasrec_params_from_numpy(tree: dict, cfg: SASRecConfig,
                             device=None) -> dict:
    """The port's SASRec parameters, key for key, from the JAX package's
    parameter tree given as numpy arrays (``item_emb``, ``pos_emb``,
    ``blocks``: a list of dicts of ``wq``, ``wk``, ``wv``, ``w1``, ``w2``,
    ``ln1``, ``ln2``), in ``cfg``'s dtype on ``device`` (the card unless
    named). Raises on a missing key or a shape that ``cfg`` does not
    give."""
    # imported here, so that the edge-buffer helpers do not load the model
    from repro_torch.models.recsys import BLOCK_MATRICES

    dev = resolve_device(device)
    d = cfg.d
    shapes = {"item_emb": (cfg.n_items, d), "pos_emb": (cfg.seq_len, d),
              **{name: (d, d) for name in BLOCK_MATRICES},
              "ln1": (d,), "ln2": (d,)}

    def tensor(name, value):
        a = np.asarray(value)
        if a.shape != shapes[name]:
            raise ValueError(f"{name}: shape {a.shape}, config gives "
                             f"{shapes[name]}")
        return torch.tensor(a, dtype=cfg.dtype, device=dev)

    if len(tree["blocks"]) != cfg.n_blocks:
        raise ValueError(f"{len(tree['blocks'])} blocks, config gives "
                         f"{cfg.n_blocks}")
    return {"item_emb": tensor("item_emb", tree["item_emb"]),
            "pos_emb": tensor("pos_emb", tree["pos_emb"]),
            "blocks": [{name: tensor(name, blk[name])
                        for name in (*BLOCK_MATRICES, "ln1", "ln2")}
                       for blk in tree["blocks"]]}


def lm_params_from_numpy(tree: dict, cfg: LMConfig, device=None) -> dict:
    """The port's language-model parameters, key for key, from the JAX
    package's ``init_params`` tree given as numpy arrays (``embed``,
    ``final_norm``, ``layers``: a dict of stacked [L, ...] weights, ``wq``
    [L, d, h_padded, dh] and ``wo`` [L, h_padded, dh, d]), in ``cfg``'s
    dtype on ``device`` (the card unless named). A bfloat16 array (numpy's
    ``ml_dtypes`` type) is widened to float32 first, exactly. Raises on a
    missing or extra key, or a shape that ``cfg`` does not give."""
    from repro_torch.models.transformer import param_shapes

    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def tensor(name, value, want):
        a = np.asarray(value)
        if a.shape != want:
            raise ValueError(f"{name}: shape {a.shape}, config gives {want}")
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.tensor(a, dtype=cfg.dtype, device=dev)

    if set(tree["layers"]) != set(shapes["layers"]):
        raise ValueError(f"layer keys {sorted(tree['layers'])}, config "
                         f"gives {sorted(shapes['layers'])}")
    return {"embed": tensor("embed", tree["embed"], shapes["embed"]),
            "final_norm": tensor("final_norm", tree["final_norm"],
                                 shapes["final_norm"]),
            "layers": {name: tensor(name, tree["layers"][name], want)
                       for name, want in shapes["layers"].items()}}


def gnn_params_from_numpy(tree: dict, cfg: GNNConfig, device=None) -> dict:
    """The port's graph-network parameters, key for key, from the JAX
    package's ``init_gnn`` tree given as numpy arrays (a dict of matrices
    and vectors and ``layers``, a list of dicts), in ``cfg``'s dtype on
    ``device`` (the card unless named). Raises where the tree's structure
    or a shape is not that of ``init_gnn(cfg, ...)``."""
    from repro_torch.models.gnn import init_gnn

    dev = resolve_device(device)
    want = init_gnn(cfg, torch.Generator(), device="meta")

    def tensor(p, value):
        a = np.asarray(value)
        if a.shape != tuple(p.shape):
            raise ValueError(f"a leaf of shape {a.shape}, config gives "
                             f"{tuple(p.shape)}")
        return torch.tensor(a, dtype=cfg.dtype, device=dev)

    if set(tree) != set(want) or len(tree["layers"]) != len(want["layers"]) \
            or any(set(a) != set(b) for a, b in zip(tree["layers"],
                                                   want["layers"])):
        raise ValueError(f"the tree's keys differ from {cfg.arch}'s")
    return tree_map(tensor, want, tree)


def adamw_state_from_numpy(tree: dict, params, device=None) -> dict:
    """The port's AdamW state from the JAX package's (``adamw_init``'s or
    ``adamw_update``'s, given as numpy arrays): ``step`` as a 0-d int32
    tensor, ``master``, ``m`` and ``v`` as float32 trees of ``params``'
    structure, on ``device`` (the card unless named). Raises on a missing
    key or a leaf whose shape is not its param's."""
    dev = resolve_device(device)

    def leaf(p, value):
        a = np.asarray(value)
        if a.shape != tuple(p.shape):
            raise ValueError(f"state leaf of shape {a.shape} for a param "
                             f"of shape {tuple(p.shape)}")
        return torch.tensor(a, dtype=torch.float32, device=dev)

    state = {"step": torch.tensor(np.asarray(tree["step"]),
                                  dtype=torch.int32, device=dev)}
    for key in ("master", "m", "v"):
        state[key] = tree_map(leaf, params, tree[key])
    return state


def to_numpy(tree):
    """Host numpy copies of a tree of tensors (params, AdamW state,
    metrics), structure kept; a bfloat16 leaf comes back as float32 (numpy
    has no bfloat16; the widening is exact)."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(one, tree)
