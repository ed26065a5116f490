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
import torch.nn.functional as F

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
    clamped = wrapped.clamp(0, n - 1)
    # a table's rows through embedding: the same gather, but its backward
    # sums repeated ids as sorted segments split over many threads, where
    # indexing's backward walks each id's repeats in turn (a training
    # batch's padding id repeats hundreds of thousands of times)
    rows = F.embedding(clamped, x) if x.dim() == 2 else x[clamped]
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

    def to_numpy(self):
        """Host copy: (src, dst) of the valid edges only."""
        m = self.mask.cpu().numpy()
        return self.src.cpu().numpy()[m], self.dst.cpu().numpy()[m]


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


#: the reference's older spelling; the same function
bucket_capacity = admission_capacity


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


class ChunkedEdgeStream:
    """Streaming-ingest buffers: power-of-two device chunks and a host
    spill ring (``repro.graph.datastructs.ChunkedEdgeStream``).

    The streaming counterpart of the one-shot full buffer: edges flow
    through fixed-size chunks on the device and fold into the live
    certificates chunk by chunk, so peak device memory is
    O(chunk + certificate) instead of O(E).

    * ``admit(src, dst)`` splits a delta of any size into segments of at
      most ``chunk_bucket`` edges, each padded to exactly ``chunk_bucket``
      slots on ``device`` (``admission_capacity``, the engine's one bucket
      currency), so every chunk of every ingest reuses one cached program
      per certificate. ``admit_each`` yields them one at a time, the
      engine's path: a delta of any size then holds one chunk on the
      device.
    * the **spill ring**: a numpy copy on the host of every admitted
      segment, the replay source whenever a live certificate must be
      rebuilt and there is no full device buffer to rebuild from. No
      device copy of a past chunk is kept.
    * ``tombstone(ksrc, kdst)`` removes every ring copy of the keyed
      unordered endpoint pairs and re-chunks the survivors into full
      segments, so ``replay()`` stays at ceil(count / chunk) chunks.

    Counters (``chunks_in``/``folds``/``spilled_edges``/``replays``) are
    deterministic for a fixed ingest sequence.
    """

    def __init__(self, n_nodes: int, chunk_edges: int = 1024,
                 minimum: int = 16, device=None):
        self.n_nodes = int(n_nodes)
        self.chunk_bucket = admission_capacity(chunk_edges, minimum)
        self.device = resolve_device(device)
        self._ring: list[tuple[np.ndarray, np.ndarray]] = []
        self.count = 0          # live edges (spilled minus tombstoned)
        self.chunks_in = 0      # device chunks admitted
        self.folds = 0          # certificate-state load/fold dispatches
        self.spilled_edges = 0  # edges appended to the host ring
        self.replays = 0        # full ring replays (rebuilds)

    @property
    def device_chunk_bytes(self) -> int:
        """Device bytes of ONE chunk buffer: int32 src + int32 dst + bool
        mask, the streaming path's whole edge-buffer footprint."""
        return self.chunk_bucket * (4 + 4 + 1)

    @property
    def ring_segments(self) -> int:
        return len(self._ring)

    def _chunk(self, s: np.ndarray, d: np.ndarray) -> EdgeList:
        """One segment as a ``chunk_bucket``-slot ``EdgeList`` on the
        device: one host-to-device copy per endpoint array."""
        cb, k, dev = self.chunk_bucket, len(s), self.device
        src = torch.zeros(cb, dtype=INT, device=dev)
        dst = torch.zeros(cb, dtype=INT, device=dev)
        mask = torch.zeros(cb, dtype=torch.bool, device=dev)
        src[:k] = torch.from_numpy(np.ascontiguousarray(s))
        dst[:k] = torch.from_numpy(np.ascontiguousarray(d))
        mask[:k] = True
        return EdgeList(src, dst, mask, self.n_nodes)

    def admit(self, src, dst) -> list[EdgeList]:
        """Split a delta into chunk-bucket-padded device chunks and spill
        host copies into the ring. Returns the chunks in ingest order."""
        return list(self.admit_each(src, dst))

    def admit_each(self, src, dst):
        """``admit`` one chunk at a time: each segment is spilled and
        uploaded when the caller asks for its chunk, so a delta of any size
        holds one chunk on the device while the caller folds it."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if src.shape != dst.shape:
            raise ValueError(
                f"admit: src/dst length mismatch {src.shape} vs {dst.shape}")
        for lo in range(0, len(src), self.chunk_bucket):
            s = src[lo:lo + self.chunk_bucket].copy()
            d = dst[lo:lo + self.chunk_bucket].copy()
            self._ring.append((s, d))
            self.spilled_edges += len(s)
            self.count += len(s)
            self.chunks_in += 1
            yield self._chunk(s, d)

    def tombstone(self, ksrc, kdst) -> int:
        """Remove every ring copy of the keyed unordered pairs; returns the
        number of edges removed. Survivors keep their order and are
        re-chunked into full segments, so replay stays ceil(count/chunk).

        The reference builds a Python set of key pairs and walks every
        ring edge through it; here each pair is one int64 and the ring's
        keys are looked up in the sorted key array, with the same result."""
        ks = np.asarray(ksrc, np.int32)
        kd = np.asarray(kdst, np.int32)
        if not len(ks) or not self._ring:
            return 0
        all_s = np.concatenate([s for s, _ in self._ring])
        all_d = np.concatenate([d for _, d in self._ring])
        table = np.unique(_pair_key_np(ks, kd))
        keys = _pair_key_np(all_s, all_d)
        at = np.searchsorted(table, keys).clip(max=len(table) - 1)
        keep = table[at] != keys
        removed = int((~keep).sum())
        if removed:
            all_s, all_d = all_s[keep], all_d[keep]
            self._ring = [
                (all_s[i:i + self.chunk_bucket], all_d[i:i + self.chunk_bucket])
                for i in range(0, len(all_s), self.chunk_bucket)]
            self.count -= removed
        return removed

    def replay(self):
        """Iterate the surviving ring as chunk-bucket-padded ``EdgeList``s
        on the device: the decremental-rebuild source, in the chunk
        currency of ``admit``, so a replay reuses the ingest programs."""
        self.replays += 1
        for s, d in self._ring:
            yield self._chunk(s, d)

    def to_numpy(self):
        """Host copy of every live edge: (src, dst)."""
        if not self._ring:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return (np.concatenate([s for s, _ in self._ring]),
                np.concatenate([d for _, d in self._ring]))


def _pair_key_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``_pair_key`` on host arrays: one int64 per unordered pair."""
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    return lo * (1 << 32) + (hi & 0xFFFFFFFF)


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Host-side CSR over the *symmetrized* edge list: (indptr, indices,
    edge_id). Used by the host DFS and the neighbour sampler. The
    reference's arrays, arc for arc, for any ids: its ``np.lexsort((adst,
    asrc))`` is one stable sort of the int64 key ``asrc * 2^32 + (adst +
    2^31)`` by torch on the host, the same permutation several times
    faster (229 M arcs: a lexsort takes minutes), and its ``np.add.at(indptr,
    asrc + 1, 1)`` one ``np.bincount``, wrapping a negative slot as
    ``add.at`` does; an id ``add.at`` cannot place (outside ``[-(n + 2),
    n)``) raises its ``IndexError``."""
    if n_nodes > INF32 - 2:
        raise ValueError(f"build_csr: n_nodes {n_nodes} exceeds 2^31 - 3")
    e = len(src)
    asrc = np.concatenate([src, dst])
    adst = np.concatenate([dst, src])
    if e and (asrc.min() < -(n_nodes + 2) or asrc.max() >= n_nodes):
        raise IndexError(f"build_csr: an id lies outside [{-(n_nodes + 2)},"
                         f" {n_nodes})")
    eid = np.concatenate([np.arange(e), np.arange(e)])
    key = asrc.astype(np.int64) * (1 << 32) + (adst.astype(np.int64)
                                               - INT32_MIN)
    order = torch.sort(torch.from_numpy(key), stable=True).indices.numpy()
    asrc, adst, eid = asrc[order], adst[order], eid[order]
    slot = asrc.astype(np.int64) + 1
    indptr = np.cumsum(np.bincount(
        np.where(slot < 0, slot + n_nodes + 1, slot), minlength=n_nodes + 1))
    return indptr, adst.astype(np.int32), eid.astype(np.int32)
