"""Plain PyTorch versions of every kernel in this package.

These are the semantics contract, the port's counterpart of
``repro/kernels/ref.py``: the CPU path of each kernel wrapper, the oracle the
CUDA kernels are held against on the card, and exactly equal to the JAX
package's oracles on every input the tests use.

32-bit unsigned values (hashes, ``ordered_u32`` sort keys) are held in
**int64 tensors with values in [0, 2**32)**: torch has no ``>>`` or ``%`` for
uint32 on the CPU, and int64 orders them as unsigned 32-bit numbers, so
``torch.sort``/``torch.searchsorted`` work on them unchanged.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

# ---------------------------------------------------------------------------
# murmur3 fmix32 column hash
# ---------------------------------------------------------------------------


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of an int32/uint32/float32 column as int64 in
    [0, 2**32)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & U32
    if x.dtype in (torch.int32, torch.uint32):
        return x.to(torch.int64) & U32
    raise TypeError(f"unsupported hash input dtype {x.dtype}")


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for a in [0, 2**32), without int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on u32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash32_ref(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash a column of int32/uint32/float32 to u32 (int64 holder).
    Floats hash by bit pattern, so -0.0 != 0.0."""
    return fmix32(as_u32(x) ^ (seed & U32))


def hash_combine_ref(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """boost::hash_combine on u32 values held in int64."""
    s = (h2 + _GOLDEN + ((h1 << 6) & U32) + (h1 >> 2)) & U32
    return h1 ^ s


# ---------------------------------------------------------------------------
# bucket histogram
# ---------------------------------------------------------------------------


def histogram_ref(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Count of ids per bucket; ids outside [0, num_buckets) are ignored."""
    valid = (ids >= 0) & (ids < num_buckets)
    slot = torch.where(valid, ids.to(torch.int64), num_buckets)
    out = torch.zeros(num_buckets + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return out[:num_buckets]


# ---------------------------------------------------------------------------
# key + payload sorts
# ---------------------------------------------------------------------------


def sort_pairs_ref(keys: torch.Tensor, payload: torch.Tensor):
    """Ascending stable sort of (keys, payload) by key alone (the
    ``lax.sort(num_keys=1)`` oracle)."""
    k, perm = torch.sort(keys, stable=True)
    return k, payload[perm]


def sort_tiles_ref(keys: torch.Tensor, payload: torch.Tensor, tile: int):
    """Sort each contiguous ``tile`` of (keys, payload) ascending,
    lexicographically on (key, payload): the function the bitonic network
    computes (floats compare as floats, so -0.0 and +0.0 tie on the key)."""
    n = keys.shape[0]
    k = keys.reshape(n // tile, tile)
    v = payload.reshape(n // tile, tile)
    v, p1 = torch.sort(v, dim=1, stable=True)
    k = torch.gather(k, 1, p1)
    k, p2 = torch.sort(k, dim=1, stable=True)
    v = torch.gather(v, 1, p2)
    return k.reshape(n), v.reshape(n)


# ---------------------------------------------------------------------------
# segmented reduction
# ---------------------------------------------------------------------------


def seg_init(op: str, dtype: torch.dtype):
    """Identity element of ``op`` for ``dtype`` (the empty-segment fill)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    if op == "min":
        return hi
    if op == "max":
        return lo
    raise ValueError(op)


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """``out[g] = op(values[i] : seg_ids[i] == g)`` along the leading axis.

    Ids outside [0, num_segments) contribute nothing; empty segments hold
    :func:`seg_init`. Rows fold into an extra dump slot that is cut off, so
    no index is ever out of range.
    """
    rest = tuple(values.shape[1:])
    out = torch.full((num_segments + 1,) + rest, seg_init(op, values.dtype),
                     dtype=values.dtype, device=values.device)
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(ok, seg_ids.to(torch.int64), num_segments)
    if op == "sum":
        out.index_add_(0, idx, values)
    elif op in ("min", "max"):
        out.index_reduce_(0, idx, values, "a" + op, include_self=True)
    else:
        raise ValueError(op)
    return out[:num_segments]
