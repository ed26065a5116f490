"""Launch wrappers of the Hopper connectivity-round kernels.

``boruvka_round_cuda`` replaces ``src/repro/kernels/boruvka_round/kernel.py::
boruvka_round_pallas`` (body ``_boruvka_round_kernel``, streaming
``_stream_chunks``). The CUDA kernel
(``csrc/connectivity_rounds.cu::boruvka_round_warp_kernel``) walks the edge
buffer in slot order on a persistent grid, four slots per thread (16-byte
loads of ``src`` and ``dst``): it tests ``mask`` and ``src != dst``, gathers
both endpoint labels (the int32[n] label array stays in L2), and where they
differ the slot index goes to both labels' entries of ``best``. Neighbouring
lanes of a warp that share a label send one update, their lowest slot (the
run's first lane, found by one warp shuffle), into a per-block
shared-memory table of (label, minimum) that is flushed into ``best`` with
``atomicMin`` at the block's end. Its byte bound: the 9 B edge slot read once, plus 4 B per label read
and 4 B per output written (``ops.boruvka_round_bytes``); the gathers and
updates are what hold it above that. ``previous_boruvka_round`` launches
the first kernel of the port (``boruvka_round_kernel``, one thread per
slot), which no op reaches: the yardstick.

``frontier_round_cuda`` replaces ``frontier_round_pallas`` of the same file
(body ``_frontier_round_kernel``). ``frontier_round_warp_kernel`` walks the
buffer on the Borůvka round's layout (a persistent grid in slot order, four
slots per thread, 16-byte loads of ``src`` and ``dst``, none for four
masked slots); for each orientation u -> w of a live slot with
``frontier[u]`` and not ``visited[w]`` it ``atomicMin``-s the packed key
``u * 2^32 + slot`` into an int64[num_segments] buffer, whose minimum is the
lexicographic (parent, slot) pair. ``best_p`` and ``best_e`` are that
buffer's high and low int32 words (``split_packed``), with no launch of
their own. Bound by bytes: the 9 B edge slot once, 1 B each of
``frontier`` and ``visited`` per vertex, 8 B per output pair; the loads of
the slots hold it above that (``tools/profile_frontier_round.py``).
``previous_frontier_round`` launches the first kernel of the port
(``frontier_round_kernel``, one thread per slot, and its split kernel
``unpack_pairs_kernel``), which no op reaches: the yardstick.
"""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INF32, INT
from repro_torch.kernels import cuda_lib

#: the packed (INF32, INF32) pair the frontier round's buffer starts from
PACKED_INF = (INF32 << 32) | INF32


def _round_launch(entry: str, src, dst, mask, labels, num_segments: int,
                  *extra) -> tuple:
    """``best`` of one Borůvka round by C entry ``entry`` (INF32-filled, then
    launched unless there is no slot or no segment) and whether it
    launched."""
    best = torch.full((num_segments,), INF32, dtype=INT, device=src.device)
    e = src.numel()
    launched = bool(e and num_segments)
    if launched:
        cuda_lib.launch(entry, src.device, src.data_ptr(), dst.data_ptr(),
                        mask.data_ptr(), labels.data_ptr(), best.data_ptr(),
                        e, labels.numel(), num_segments, *extra)
    return best, launched


def boruvka_round_cuda(src, dst, mask, labels, num_segments: int):
    """Launch the kernel on CUDA tensors validated by ``ops.boruvka_round``."""
    best, launched = _round_launch("repro_boruvka_round", src, dst, mask,
                                   labels, num_segments, 1)
    boruvka_round_cuda.launches += launched
    return best


boruvka_round_cuda.launches = 0


def boruvka_round_without_table(src, dst, mask, labels, num_segments: int):
    """The kernel without its per-block table, each group's update straight
    into ``best``: a yardstick outside every op, its launches not counted."""
    return _round_launch("repro_boruvka_round", src, dst, mask, labels,
                         num_segments, 0)[0]


def previous_boruvka_round(src, dst, mask, labels, num_segments: int):
    """The first kernel (one thread per slot), on validated CUDA tensors: a
    yardstick outside every op, its launches not counted."""
    return _round_launch("repro_boruvka_round_v1", src, dst, mask, labels,
                         num_segments)[0]


def split_packed(packed: torch.Tensor) -> tuple:
    """``(best_p, best_e)`` of a packed int64 buffer of keys ``p * 2^32 +
    e``: the high and low int32 words of each key, as views of it (the
    little-endian layout of the card and of x86 hosts). ``PACKED_INF``
    splits into ``INF32, INF32``."""
    words = packed.view(INT)
    return words[1::2], words[0::2]


def _packed_launch(entry: str, src, dst, mask, frontier, visited,
                   num_segments: int, *outputs):
    """The packed int64 buffer of one frontier round by C entry ``entry``,
    filled with ``PACKED_INF`` and then launched on validated CUDA tensors
    with at least one slot and one segment; ``outputs`` are more pointers
    the entry takes after it."""
    packed = torch.full((num_segments,), PACKED_INF, dtype=torch.int64,
                        device=src.device)
    cuda_lib.launch(entry, src.device, src.data_ptr(), dst.data_ptr(),
                    mask.data_ptr(), frontier.data_ptr(), visited.data_ptr(),
                    packed.data_ptr(), *outputs, src.numel(),
                    frontier.numel(), num_segments)
    return packed


def _no_round(src, num_segments: int) -> tuple:
    """``(best_p, best_e)`` of a round with no slot or no segment."""
    none = torch.full((num_segments,), INF32, dtype=INT, device=src.device)
    return none, none.clone()


def frontier_round_cuda(src, dst, mask, frontier, visited, num_segments: int):
    """Launch the kernel on CUDA tensors validated by
    ``ops.frontier_round``; returns ``(best_p, best_e)``, the two words of
    the kernel's packed buffer (strided views)."""
    if not (src.numel() and num_segments):
        return _no_round(src, num_segments)
    packed = _packed_launch("repro_frontier_round", src, dst, mask, frontier,
                            visited, num_segments)
    frontier_round_cuda.launches += 1
    return split_packed(packed)


frontier_round_cuda.launches = 0


def previous_frontier_round(src, dst, mask, frontier, visited,
                            num_segments: int):
    """The first kernel (one thread per slot) and its split kernel, on
    validated CUDA tensors: a yardstick outside every op, its launches not
    counted. Returns contiguous ``(best_p, best_e)``."""
    if not (src.numel() and num_segments):
        return _no_round(src, num_segments)
    best_p = torch.empty((num_segments,), dtype=INT, device=src.device)
    best_e = torch.empty_like(best_p)
    _packed_launch("repro_frontier_round_v1", src, dst, mask, frontier,
                   visited, num_segments, best_p.data_ptr(),
                   best_e.data_ptr())
    return best_p, best_e
