"""Fixed-shape graph containers on torch tensors.

The port's counterpart of ``repro.graph.datastructs``: every stage runs on
fixed-capacity edge buffers with a validity mask, so buffers of one shape
bucket are interchangeable. Masked slots hold in-range zeros.

Two JAX habits need spelling out here, because torch does not share them:

* a gather index in ``[-n, -1]`` wraps to ``n + idx`` in JAX (numpy-style)
  and any index still out of range is clamped, where torch raises — ``take``
  is that gather (``take_fill`` is ``jnp.take``'s, which fills NaN instead);
* ``.at[idx].set(..., mode="drop")`` drops out-of-range scatter indices —
  the port scatters into a buffer with one dump slot and slices it off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT = torch.int32
INF32 = int(np.iinfo(np.int32).max)
INT32_MIN = int(np.iinfo(np.int32).min)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without a card and without an explicit device, raise — never
    fall back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with JAX's gather semantics: an index in ``[-n, -1]``
    wraps to ``n + idx``, then every index is clamped into ``[0, n)``."""
    n = x.shape[0]
    return x[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def take_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` in its default "fill" mode: an index in
    ``[-n, -1]`` wraps to ``n + idx``; a row whose index is still outside
    ``[0, n)`` is NaN (``x`` floating)."""
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    inside = (wrapped >= 0) & (wrapped < n)
    rows = x[wrapped.clamp(0, n - 1)]
    shape = inside.shape + (1,) * (x.dim() - 1)
    return torch.where(inside.reshape(shape), rows, float("nan"))


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Padded undirected edge list.

    src, dst : int32[capacity]   endpoints (zeros where ~mask)
    mask     : bool[capacity]    which slots hold real edges
    n_nodes  : int               vertex count
    """

    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor
    n_nodes: int

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def num_edges(self) -> int:
        return int(self.mask.sum())

    @staticmethod
    def from_arrays(src, dst, n_nodes: int, capacity: int | None = None,
                    device=None) -> "EdgeList":
        dev = resolve_device(device)
        src = torch.tensor(np.asarray(src, np.int32), device=dev)
        dst = torch.tensor(np.asarray(dst, np.int32), device=dev)
        mask = torch.ones(src.shape, dtype=torch.bool, device=dev)
        el = EdgeList(src, dst, mask, n_nodes)
        if capacity is not None and capacity != el.capacity:
            el = pad_edges(el, capacity)
        return el


def pad_edges(edges: EdgeList, capacity: int) -> EdgeList:
    """Grow (or shrink, raising on real edge loss) to `capacity` slots."""
    cur = edges.capacity
    if capacity == cur:
        return edges
    if capacity > cur:
        z = torch.zeros(capacity - cur, dtype=INT, device=edges.device)
        return EdgeList(
            torch.cat([edges.src, z]),
            torch.cat([edges.dst, z]),
            torch.cat([edges.mask, z.bool()]),
            edges.n_nodes,
        )
    n_real = edges.num_edges()
    if n_real > capacity:
        raise ValueError(
            f"pad_edges: shrinking to {capacity} slots would drop "
            f"{n_real - capacity} of {n_real} real edges"
        )
    return compact_edges(edges, capacity)


def admission_capacity(m: int, minimum: int = 16) -> int:
    """Smallest power of two >= max(m, minimum): the shape-bucket helper."""
    m = max(int(m), minimum, 1)
    return 1 << (m - 1).bit_length()


def compact_edges(edges: EdgeList, capacity: int,
                  keep: torch.Tensor | None = None) -> EdgeList:
    """Scatter the selected edges to the front of a fresh `capacity`-slot
    buffer. O(E) cumsum + scatter; selected edges beyond `capacity` are
    dropped (into the dump slot), so the caller must guarantee the selection
    fits (certificates are bounded by construction)."""
    sel = edges.mask if keep is None else (edges.mask & keep)
    pos = torch.cumsum(sel, 0, dtype=INT) - 1
    # every index >= capacity drops, not only the unselected ones
    idx = torch.where(sel & (pos < capacity), pos, capacity)
    dev = edges.device
    out_src = torch.zeros(capacity + 1, dtype=INT, device=dev)
    out_dst = torch.zeros(capacity + 1, dtype=INT, device=dev)
    out_mask = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    out_src[idx] = edges.src
    out_dst[idx] = edges.dst
    out_mask[idx] = True
    return EdgeList(out_src[:capacity], out_dst[:capacity],
                    out_mask[:capacity], edges.n_nodes)


def tombstone_mask(src, dst, mask, ksrc, kdst, kmask):
    """Mask out every live slot whose unordered endpoint pair matches a key
    (``repro.graph.datastructs.tombstone_mask``).

    A deletion is a (min, max)-key match against the live buffer, never a
    compaction, so the buffer keeps its shape. Matches ALL live copies of a
    key (an endpoint pair names a link; its parallel copies die with it).
    Returns ``(new_mask, removed)`` where ``removed`` is the int32 count of
    the slots masked out. Leading dims broadcast: ``[..., E]`` buffers
    against ``[..., K]`` keys.

    The reference compares every slot with every key (an ``[E, K]``
    matrix, 16 GiB at 2^24 slots and 1,024 keys); here each pair becomes
    one int64 and the slots look theirs up in the sorted keys, in
    O((E + K) log K) time and O(E + K) memory, with the same result.
    """
    key = _pair_key(src, dst)
    kkey = torch.where(kmask, _pair_key(ksrc, kdst), _NO_PAIR)
    lead = torch.broadcast_shapes(key.shape[:-1], kkey.shape[:-1])
    key = key.expand(*lead, key.shape[-1]).contiguous()
    kkey = kkey.expand(*lead, kkey.shape[-1])
    if kkey.shape[-1] == 0:
        found = torch.zeros_like(key, dtype=torch.bool)
    else:
        table = torch.sort(kkey, dim=-1).values
        at = torch.searchsorted(table, key).clamp_(max=table.shape[-1] - 1)
        found = torch.gather(table, -1, at) == key
    hit = mask & found
    return mask & ~hit, hit.sum(dtype=INT)


#: no unordered int32 pair maps to it: it would need min = 2^31 - 1 and
#: max = -1, but max >= min
_NO_PAIR = int(np.iinfo(np.int64).max)


def _pair_key(src, dst) -> torch.Tensor:
    """One int64 per unordered endpoint pair: min * 2^32 + (max mod 2^32),
    one-to-one over int32 pairs."""
    lo = torch.minimum(src, dst).to(torch.int64)
    hi = torch.maximum(src, dst).to(torch.int64)
    return lo * (1 << 32) + (hi & 0xFFFFFFFF)


def concat_edges(a: EdgeList, b: EdgeList) -> EdgeList:
    if a.n_nodes != b.n_nodes:
        raise ValueError(f"n_nodes differ: {a.n_nodes} vs {b.n_nodes}")
    return EdgeList(
        torch.cat([a.src, b.src]),
        torch.cat([a.dst, b.dst]),
        torch.cat([a.mask, b.mask]),
        a.n_nodes,
    )


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Host-side CSR over the *symmetrized* edge list: (indptr, indices,
    edge_id). Used by the host DFS."""
    e = len(src)
    asrc = np.concatenate([src, dst])
    adst = np.concatenate([dst, src])
    eid = np.concatenate([np.arange(e), np.arange(e)])
    order = np.lexsort((adst, asrc))
    asrc, adst, eid = asrc[order], adst[order], eid[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, asrc + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, adst.astype(np.int32), eid.astype(np.int32)
