"""Bitonic (key, payload) tile sort: the wrapper of ``csrc/bitonic.cu``.

Replaces ``repro/kernels/bitonic.py::bitonic_sort_tiles`` (the Pallas
``_bitonic_kernel``): the leaf sort of single-key local sorts of capacity
<= 2048 (``ops.sort_pairs``). At those sizes the kernel is bound by latency,
not bytes or operations: 66 dependent compare-exchange passes for a
2048-pair tile. It keeps the tile in shared memory, one block per tile and
one thread per pair, so global memory sees one read and one write per pair.

Keys are int64 only: the path sorts ``ordered_u32`` keys, which the port
holds in int64. The plain version (``ref.sort_tiles_ref``) takes any dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.utils import next_pow2

DEFAULT_TILE = 1 << 11
MAX_TILE = 1 << 12  # 4096 int64 keys + int32 payloads = 48 KB of shared memory


def bitonic_sort_tiles(keys: torch.Tensor, payload: torch.Tensor, *,
                       tile: int = DEFAULT_TILE):
    """Sort each contiguous ``tile`` of (keys, payload) ascending,
    lexicographically on (key, payload).

    keys: (N,) int64 (u32 values on the path); payload: (N,) int32; N a
    multiple of ``tile``, a power of two in [256, 4096]. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (counted in
    ``bitonic_sort_tiles.launches``) or raises.
    """
    (n,) = keys.shape
    if payload.shape != keys.shape or payload.dtype != torch.int32:
        raise TypeError("payload must be int32 with the keys' shape")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if tile != next_pow2(tile) or not 256 <= tile <= MAX_TILE or n % tile:
        raise ValueError(f"tile must be a power of two in [256, {MAX_TILE}] "
                         f"dividing N; got tile={tile}, N={n}")
    if keys.device.type == "cpu":
        return ref.sort_tiles_ref(keys, payload, tile)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort_tiles: unsupported device {keys.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    keys, payload = keys.contiguous(), payload.contiguous()
    ko, vo = torch.empty_like(keys), torch.empty_like(payload)
    if n:
        check("bitonic_sort_tiles", library().repro_bitonic(
            keys.data_ptr(), payload.data_ptr(), ko.data_ptr(), vo.data_ptr(),
            n, tile, stream_ptr(keys)))
        bitonic_sort_tiles.launches += 1
    return ko, vo


bitonic_sort_tiles.launches = 0
