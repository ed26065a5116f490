from repro_torch.kernels.flash_attention.ops import (
    ATTN_GATES,
    attention_bytes,
    attention_flops,
    attention_gate,
    flash_attention,
    kernel_path,
)

__all__ = ["ATTN_GATES", "attention_bytes", "attention_flops",
           "attention_gate", "flash_attention", "kernel_path"]
