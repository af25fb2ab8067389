"""The dispatch seam between the operators and the kernels (the port of
``repro/kernels/ops.py``).

The core library calls these, never the kernels directly, so the
kernel-or-plain choice, padding and multi-column combination live in one
place. Each kernel wrapper itself takes its plain version for a CPU tensor
and launches its kernel for a CUDA tensor. :func:`oracle_scope` (the
reference's recovery rung) makes every function here call the plain
versions instead, on whatever device the tensors are: a caller's request,
never a fallback.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.kernels import bitonic, hash64, histogram, ref
from repro_torch.kernels import segment_reduce as seg
from repro_torch.kernels.bitonic import DEFAULT_TILE
from repro_torch.utils import next_pow2

__all__ = [
    "hash32",
    "hash_columns",
    "bucket_histogram",
    "sort_pairs",
    "segment_reduce",
    "key_max",
    "oracle_scope",
    "oracle_only",
]

_oracle = threading.local()


def oracle_only() -> bool:
    """True while the calling thread is inside :func:`oracle_scope`."""
    return getattr(_oracle, "depth", 0) > 0


@contextmanager
def oracle_scope():
    """Run every kernel's plain version on this thread (bit-identical on
    the integer-valued inputs the engine produces)."""
    _oracle.depth = getattr(_oracle, "depth", 0) + 1
    try:
        yield
    finally:
        _oracle.depth -= 1


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    if oracle_only():
        return ref.hash32_ref(x, seed)
    return hash64.hash32(x, seed)


def hash_columns(columns: list[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Row-wise u32 hash (int64 holder) over one or more columns,
    order-sensitive: the paper's multi-column record hash."""
    if not columns:
        raise ValueError("hash_columns needs at least one column")
    h = hash32(columns[0], seed=seed)
    for c in columns[1:]:
        h = ref.hash_combine_ref(h, hash32(c, seed=seed))
    return h


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    if oracle_only():
        return ref.histogram_ref(ids, num_buckets)
    return histogram.bucket_histogram(ids, num_buckets)


def key_max(dtype: torch.dtype):
    """Sentinel that sorts after every real key of ``dtype`` (a Python
    scalar). The int64 holder of u32 keys gets the int64 max, which sorts
    after every u32 value too."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, op: str = "sum", *,
                   use_kernel: bool | None = None,
                   contiguous_runs: bool = False) -> torch.Tensor:
    """Segmented sum/min/max: ``out[g] = op(values[i] where seg_ids[i] == g)``.

    values: (n, ...), reduced along the leading axis; seg_ids: (n,) int32,
    entries outside [0, num_segments) ignored; empty segments hold
    ``ref.seg_init``. 1-D f32/i32 values go to the kernel; N-D or other
    dtypes take the plain scatter (as the reference leaves them to XLA);
    ``use_kernel=False`` and :func:`oracle_scope` force the plain version.
    ``contiguous_runs=True`` is the caller's promise that each in-range id's
    rows form one contiguous run; the kernel wrapper then skips its check.
    """
    if op not in ("sum", "min", "max"):
        raise ValueError(op)
    if seg_ids.ndim != 1 or values.shape[0] != seg_ids.shape[0]:
        raise ValueError(f"shape mismatch {tuple(values.shape)} vs "
                         f"{tuple(seg_ids.shape)}")
    shape_ok = values.ndim == 1 and values.dtype in (torch.float32, torch.int32)
    if use_kernel is None:
        use_kernel = shape_ok
    elif use_kernel and not shape_ok:
        raise ValueError(
            f"segment_reduce kernel needs 1-D f32/i32 values; got "
            f"shape={tuple(values.shape)} dtype={values.dtype}. Use "
            f"use_kernel=None for the plain scatter.")
    if use_kernel and not oracle_only():
        return seg.segment_reduce_tiles(values, seg_ids.to(torch.int32),
                                        num_segments, op,
                                        contiguous_runs=contiguous_runs)
    return ref.segment_reduce_ref(values, seg_ids, num_segments, op)


def sort_pairs(keys: torch.Tensor, payload: torch.Tensor, *,
               tile: int = DEFAULT_TILE, use_kernel: bool | None = None):
    """Full ascending (keys, payload) sort, stable on the key.

    keys: (n,) int64 (the port's holder of u32 keys); payload: (n,) int32.
    Up to one tile the bitonic kernel sorts (keys, payload) padded to a
    power of two (>= 256); beyond it, or with ``use_kernel=False``, a
    stable ``torch.sort`` on the key. The padding is (key max, payload
    int32 max): it sorts after every real pair, so a real row whose key is
    the key max is never cut off (the reference pads with payload 0 and
    loses such a row at non-power-of-two sizes).
    """
    if use_kernel is None:
        use_kernel = True
    (n,) = keys.shape
    if not use_kernel or n > tile:
        return ref.sort_pairs_ref(keys, payload)
    n_pad = max(next_pow2(n), 256)
    kp = torch.full((n_pad,), key_max(keys.dtype), dtype=keys.dtype,
                    device=keys.device)
    kp[:n] = keys
    vp = torch.full((n_pad,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=keys.device)
    vp[:n] = payload
    if oracle_only():
        ko, vo = ref.sort_tiles_ref(kp, vp, n_pad)
    else:
        ko, vo = bitonic.bitonic_sort_tiles(kp, vp, tile=n_pad)
    return ko[:n], vo[:n]
