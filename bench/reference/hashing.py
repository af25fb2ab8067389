"""A frozen copy of the engine's hash partitioning (murmur3's fmix32 on each
column's 32-bit pattern, boost's hash_combine across columns, modulo the
worker count), so the reference can say on which worker each result row
belongs. Plain PyTorch on u32 values held in int64."""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of an int32 or float32 column, int64 in [0, 2**32)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"no 32-bit pattern for {x.dtype}")
    return x.to(torch.int64) & U32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def partition_of(columns: list[torch.Tensor], workers: int, seed: int
                 ) -> torch.Tensor:
    """Destination worker of each row, (n,) int64, hashing ``columns`` in
    the order given."""
    def h32(c):
        return _fmix32(as_u32(c) ^ (seed & U32))

    h = h32(columns[0])
    for c in columns[1:]:
        h2 = h32(c)
        h = h ^ ((h2 + _GOLDEN + ((h << 6) & U32) + (h >> 2)) & U32)
    return h % workers
