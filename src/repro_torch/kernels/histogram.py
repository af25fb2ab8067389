"""Bucket histogram: the wrapper of ``csrc/histogram.cu``.

Replaces ``repro/kernels/histogram.py::bucket_histogram`` (the Pallas
``_hist_kernel``): the per-destination row counts every shuffle needs,
bound by bytes (4 B per id). For the shuffles' small P (at most 8) the
kernel counts in registers from 16-byte loads and the last block to finish
sums the blocks' rows of a scratch buffer into the output: one launch, no
memset. Larger P keeps a per-block shared-memory histogram fed by
warp-aggregated integer atomics. Integer counts: exact and the same on
every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import meta, ref

# (device index, stream) -> the small-P path's scratch: the blocks' rows and
# the last-block ticket, zeroed once here; each call leaves the ticket at 0
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Count each id in [0, num_buckets); other ids (the -1 padding) are
    ignored. ``ids``: (N,) int32. Returns (num_buckets,) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``bucket_histogram.launches``) or raises; a meta tensor
    returns an empty count and records the kernel's bytes (``kernels/meta``:
    the ids read, the counts written).
    """
    if ids.ndim != 1 or ids.dtype != torch.int32:
        raise TypeError(f"bucket_histogram takes 1-D int32 ids, got "
                        f"shape={tuple(ids.shape)} dtype={ids.dtype}")
    if ids.device.type == "cpu":
        return ref.histogram_ref(ids, num_buckets)
    if ids.device.type == "meta":
        meta.record("bucket_histogram", 0.0, 4.0 * (ids.numel() + num_buckets))
        return ids.new_empty(num_buckets)
    if ids.device.type != "cuda":
        raise ValueError(f"bucket_histogram: unsupported device {ids.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    ids = ids.contiguous()
    out = torch.empty(num_buckets, dtype=torch.int32, device=ids.device)
    if num_buckets:
        lib = library()
        stream = stream_ptr(ids)
        key = (ids.device.index, stream)
        if key not in _SCRATCH:
            _SCRATCH[key] = torch.zeros(lib.repro_histogram_scratch_ints(),
                                        dtype=torch.int32, device=ids.device)
        check("bucket_histogram", lib.repro_histogram(
            ids.data_ptr(), out.data_ptr(), ids.numel(), num_buckets,
            _SCRATCH[key].data_ptr(), stream))
        bucket_histogram.launches += 1
    return out


bucket_histogram.launches = 0
