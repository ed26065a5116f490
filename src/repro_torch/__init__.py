"""PyTorch/CUDA port of the bridge-finding system.

The JAX package ``repro`` is the reference; this package imports torch and
never JAX, and nothing of ``repro``. Entry points run on the card unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live in
``repro_torch/csrc`` and are built at first use.
"""
from repro_torch.core.api import find_bridges

__all__ = ["find_bridges"]
