from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag,
    embedding_bag_bytes,
    embedding_bag_bytes_read,
    kernel_path,
)

__all__ = ["embedding_bag", "embedding_bag_bytes", "embedding_bag_bytes_read",
           "kernel_path"]
