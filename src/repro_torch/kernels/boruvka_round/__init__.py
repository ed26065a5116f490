from repro_torch.kernels.boruvka_round.ops import (
    EDGE_SLOT_BYTES,
    boruvka_round,
    boruvka_round_bytes,
    frontier_round,
    frontier_round_bytes,
    kernel_path,
)

__all__ = ["EDGE_SLOT_BYTES", "boruvka_round", "boruvka_round_bytes",
           "frontier_round", "frontier_round_bytes", "kernel_path"]
