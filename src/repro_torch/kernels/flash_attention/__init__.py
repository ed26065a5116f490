from repro_torch.kernels.flash_attention.ops import (
    attention_bytes,
    attention_flops,
    flash_attention,
    kernel_path,
)

__all__ = ["attention_bytes", "attention_flops", "flash_attention",
           "kernel_path"]
