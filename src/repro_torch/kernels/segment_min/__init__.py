from repro_torch.kernels.segment_min.ops import kernel_path, segment_min

__all__ = ["kernel_path", "segment_min"]
