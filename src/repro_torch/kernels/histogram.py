"""Bucket histogram: the wrapper of ``csrc/histogram.cu``.

Replaces ``repro/kernels/histogram.py::bucket_histogram`` (the Pallas
``_hist_kernel``): the per-destination row counts every shuffle needs. On
this card it is bound by bytes in principle (4 B per id) and by atomic
contention in practice (P = 8 counters); the kernel keeps a per-block
shared-memory histogram fed by warp-aggregated integer atomics, so the
counts are exact and the same on every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Count each id in [0, num_buckets); other ids (the -1 padding) are
    ignored. ``ids``: (N,) int32. Returns (num_buckets,) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``bucket_histogram.launches``) or raises.
    """
    if ids.ndim != 1 or ids.dtype != torch.int32:
        raise TypeError(f"bucket_histogram takes 1-D int32 ids, got "
                        f"shape={tuple(ids.shape)} dtype={ids.dtype}")
    if ids.device.type == "cpu":
        return ref.histogram_ref(ids, num_buckets)
    if ids.device.type != "cuda":
        raise ValueError(f"bucket_histogram: unsupported device {ids.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    ids = ids.contiguous()
    out = torch.empty(num_buckets, dtype=torch.int32, device=ids.device)
    if num_buckets:
        check("bucket_histogram", library().repro_histogram(
            ids.data_ptr(), out.data_ptr(), ids.numel(), num_buckets,
            stream_ptr(ids)))
        bucket_histogram.launches += 1
    return out


bucket_histogram.launches = 0
