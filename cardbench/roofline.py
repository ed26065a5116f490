"""The card's peaks and the bytes each of the port's kernels must move.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W (as the
port's ``launch/hlo_analysis.py::HW`` records them; copied, not imported):
a card set to a lower power limit runs below them, so every reading is
given with the limit ``nvidia-smi`` reports.

A kernel's bytes count each input byte the algorithm needs once and each
output byte once, whatever the kernel reads again, so the count does not
change with the kernel that implements the call:

* ``boruvka_round`` over ``slots`` edge slots of which ``live`` are set,
  on ``n`` vertices: the 1-byte mask of every slot, the int32 ``src`` and
  ``dst`` of the live slots, the int32 label of every vertex read, and
  the int32 best slot of every vertex written.
* ``segment_min`` over ``keys`` int32 keys of which ``live`` are not the
  empty marker, into ``segments`` segments: every key, the int32 segment
  id of each live key, and the int32 minimum of every segment written.
"""
from __future__ import annotations

#: bytes per second of HBM3 (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 operations per second (data sheet)
BF16_FLOPS = 989e12


def boruvka_round_bytes(slots: int, n: int, live: int) -> int:
    """Bytes one Borůvka hooking round must move."""
    return slots + 8 * live + 4 * n + 4 * n


def segment_min_bytes(keys: int, live: int, segments: int) -> int:
    """Bytes one segment minimum must move."""
    return 4 * keys + 4 * live + 4 * segments


def roofline_pct(nbytes: float, device_s: float) -> float | None:
    """The least time ``nbytes`` take at ``HBM_BYTES_PER_S`` as a share
    of ``device_s`` in percent; None without device time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
