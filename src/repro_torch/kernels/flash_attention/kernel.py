"""Launch wrapper of the Hopper flash-attention kernel.

``flash_attention_cuda`` replaces ``src/repro/kernels/flash_attention/
kernel.py::flash_attention_pallas`` (body ``_flash_kernel``). The CUDA
kernel (``csrc/flash_attention.cu::flash_attention_kernel``) runs one block
of 8 warps per (batch * query head, tile of 64 query rows): query, key and
value tiles staged in shared memory as float32, scores with one lane per
key, an online-softmax update per 64-key tile, the output accumulated in
float32 registers with one lane per column and rounded once to q's dtype.
Key tiles above a causal diagonal are skipped. It is bound by operations
at the tensor cores' bf16 rate for a long prefill and by the bytes of K and
V for decoding (``ops.attention_flops``, ``ops.attention_bytes``); being on
the float32 cores, it is far from the first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

#: head sizes the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: dtypes of q, k, v and out the kernel takes, by the code its entry reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query rows of one block (the grid's second dimension counts these)
Q_TILE = 64


def flash_attention_cuda(q, k, v, causal: bool, scale: float):
    """Launch the kernel on CUDA tensors validated by
    ``ops.flash_attention``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    out = torch.empty_like(q)
    if b and sq and hq:
        cuda_lib.launch("repro_flash_attention", q.device, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
                        hq, hkv, d, float(scale), int(causal), DTYPES[q.dtype])
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
