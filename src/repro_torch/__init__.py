"""PyTorch/CUDA port of the bridge-finding system.

The JAX package ``repro`` is the reference; this package imports torch and
never JAX, and nothing of ``repro``. Entry points run on the card unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live in
``repro_torch/csrc`` and are built at first use.
"""
from repro_torch.core.api import (
    analyze,
    find_bcc,
    find_bridge_tree,
    find_bridges,
    find_cuts,
    find_two_ecc,
)
from repro_torch.engine.engine import analyze_batch, find_bridges_batch

__all__ = ["analyze", "analyze_batch", "find_bcc", "find_bridge_tree",
           "find_bridges", "find_bridges_batch", "find_cuts", "find_two_ecc"]
