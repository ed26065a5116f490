"""Launch wrappers of the Hopper flash-attention kernels.

Both replace ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`` (body ``_flash_kernel``); ``flash_attention_cuda``
picks one by dtype and nothing else:

* bf16 -> ``flash_attention_mma_cuda`` (``csrc/flash_attention_mma.cu``):
  FlashAttention-2's structure on the tensor cores' ``mma.sync.m16n8k16``,
  one block of 4 warps per (batch * query head, 64 query rows), K and V
  tiles double buffered in shared memory with ``cp.async``, the online
  softmax in registers, and the probabilities split into two bf16 halves
  for the second product, so that they keep float32's accuracy.
* float32 -> ``flash_attention_tf32x3_cuda``
  (``csrc/flash_attention_tf32x3.cu``): the same structure on
  ``mma.sync.m16n8k8`` in TF32, every operand of both products split into
  hi = tf32(x) and lo = tf32(x - hi) and three products summed (3xTF32),
  which one TF32 product's 11-bit operands would not.

``float32_core_kernel`` launches the first kernel of the port
(``csrc/flash_attention.cu``, on the float32 cores), which no op reaches: a
yardstick for the two above.

A long prefill is bound by operations at the tensor cores' rate and
decoding by the bytes of K and V (``ops.attention_flops``,
``ops.attention_bytes``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

#: head sizes the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: query rows of one block in the kernels; the grid's second dimension
#: counts these tiles and takes at most ``MAX_Q_TILES``
Q_TILE = 64
MAX_Q_TILES = 65535
#: the kernel that takes each dtype, by its name in ``kernels.LAUNCHERS``
KERNEL_OF = {torch.bfloat16: "flash_attention_mma",
             torch.float32: "flash_attention_tf32x3"}


def _launch(entry: str, q, k, v, causal: bool, scale: float, *extra):
    """Call ``entry`` on contiguous q, k, v (copied where not 16-byte
    aligned, as the kernels' vector loads need); returns out and whether
    the kernel was launched (not when there is nothing to compute)."""
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    out = torch.empty_like(q)
    if not (b and sq and hq):
        return out, False
    cuda_lib.launch(entry, q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, d,
                    float(scale), int(causal), *extra)
    return out, True


def flash_attention_mma_cuda(q, k, v, causal: bool, scale: float):
    """bf16 q, k, v: the bf16 tensor-core kernel."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_mma takes bf16, got {q.dtype}")
    out, launched = _launch("repro_flash_attention_mma", q, k, v, causal,
                            scale)
    flash_attention_mma_cuda.launches += launched
    return out


def flash_attention_tf32x3_cuda(q, k, v, causal: bool, scale: float):
    """float32 q, k, v: the 3xTF32 tensor-core kernel."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_tf32x3 takes float32, got {q.dtype}")
    out, launched = _launch("repro_flash_attention_tf32x3", q, k, v, causal,
                            scale)
    flash_attention_tf32x3_cuda.launches += launched
    return out


flash_attention_mma_cuda.launches = 0
flash_attention_tf32x3_cuda.launches = 0


def flash_attention_cuda(q, k, v, causal: bool, scale: float):
    """Launch the kernel of q's dtype on CUDA tensors validated by
    ``ops.flash_attention``; raise for any other dtype."""
    if q.dtype == torch.bfloat16:
        return flash_attention_mma_cuda(q, k, v, causal, scale)
    if q.dtype == torch.float32:
        return flash_attention_tf32x3_cuda(q, k, v, causal, scale)
    raise TypeError(f"the kernels take {list(KERNEL_OF)}, got {q.dtype}")


def float32_core_kernel(q, k, v, causal: bool, scale: float):
    """The first kernel, on the float32 cores, for float32 or bf16 q, k, v
    on the card, through its entry: a yardstick outside every op, its
    launches not counted."""
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]  # entry's dtype
    return _launch("repro_flash_attention", q.contiguous(), k.contiguous(),
                   v.contiguous(), causal, scale, code)[0]
