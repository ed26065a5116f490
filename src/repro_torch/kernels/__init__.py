"""Hand-written Hopper kernels of the port, each beside its plain version.

The bridge pipeline runs ``boruvka_round``, ``frontier_round`` and
``segment_min``; SASRec's retrieval step runs ``embedding_bag``; no model
calls ``flash_attention``, as in the JAX package (its op is the only path;
bf16 goes to ``flash_attention_mma``, float32 to ``flash_attention_tf32x3``).
Each kernel package keeps the JAX package's layout: ``ref.py`` holds the
plain PyTorch version, ``kernel.py`` the wrapper that launches the CUDA
kernel (sources in ``repro_torch/csrc``), ``ops.py`` the dispatch: the
kernel for a CUDA tensor, the plain version for a CPU tensor.
"""
from repro_torch.kernels.boruvka_round import kernel as _boruvka_kernel
from repro_torch.kernels.embedding_bag import kernel as _embedding_bag_kernel
from repro_torch.kernels.flash_attention import kernel as _flash_kernel
from repro_torch.kernels.segment_min import kernel as _segment_min_kernel

#: every kernel wrapper that counts its launches, by kernel name
LAUNCHERS = {
    "boruvka_round": _boruvka_kernel.boruvka_round_cuda,
    "frontier_round": _boruvka_kernel.frontier_round_cuda,
    "segment_min": _segment_min_kernel.segment_min_cuda,
    "embedding_bag": _embedding_bag_kernel.embedding_bag_cuda,
    "flash_attention_mma": _flash_kernel.flash_attention_mma_cuda,
    "flash_attention_tf32x3": _flash_kernel.flash_attention_tf32x3_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
