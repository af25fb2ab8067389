"""GQA flash attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_flash_kernel``): every prefill's self-attention on the serving path
(``models/layers._sdpa``, through the ``kernels/ops.attention`` seam). The
TPU kernel's sequential k-block grid axis with VMEM scratch becomes a loop
inside one CTA per (64-row query tile, head, batch), with the online
softmax in registers; bf16 runs on ``mma.sync`` tensor-core products. The
kernel is bound by operations at the serving shape. No atomics: the same
inputs give the same bits on every run. See the source's note.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, KV, hd); H % KV == 0. Returns (B, S, H, hd)
    in q's dtype: ``softmax(q k^T / sqrt(hd)) v``, causal or not, query head
    h reading KV head ``h // (H // KV)``.

    A CPU tensor takes the plain version (:func:`ref.attention_ref`, any
    head dim). A CUDA tensor launches the kernel (counted in
    ``flash_attention.launches``) or raises: it takes bf16 or fp32, head dim
    64 or 128 (``TypeError`` otherwise), contiguous 16-byte-aligned tensors,
    and any S >= 1.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (self-attention, H % KV == 0)")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: unsupported devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise TypeError(f"flash_attention has kernels for head dims "
                        f"{KERNEL_HEAD_DIMS}, got {hd}")
    tensors = (q, k, v)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("flash_attention takes contiguous, 16-byte-aligned "
                         "tensors")
    from repro_torch.kernels._build import check, library, stream_ptr

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    check("flash_attention", library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal),
        int(q.dtype == torch.bfloat16), stream_ptr(q)))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
