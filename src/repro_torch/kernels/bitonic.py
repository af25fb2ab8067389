"""Bitonic sorts: the wrappers of ``csrc/bitonic.cu``.

Replaces ``repro/kernels/bitonic.py::bitonic_sort_tiles`` (the Pallas
``_bitonic_kernel``). Two entries:

* :func:`bitonic_sort_tiles`, the counterpart of the TPU kernel: each
  power-of-two tile of (int64 key, int32 payload) pairs sorted
  lexicographically (``ops.sort_pairs``).
* :func:`bitonic_sort_permutation`, ``sort_permutation``'s bitonic branch in
  one launch: a raw 4-byte key column of C <= 2048 rows and the device row
  count in, the int64 sort permutation out (``ref.sort_permutation_ref``).

At these sizes a sort is bound by one SM, not by bytes: 66 dependent
compare-exchange passes for a 2048-pair tile, and the instructions one SM
issues for them. Both hold 8 pairs a
thread in registers and exchange across lanes with warp shuffles; only the
passes that cross warps go through shared memory, one barrier a re-layout
(6 for a 2048-pair tile, none up to 256). :func:`latency_probe` times one
dependent step of the network on the card, for ``chip_smoke.py``'s bound.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.utils import next_pow2

DEFAULT_TILE = 1 << 11
MAX_TILE = 1 << 12  # 4096 pairs: 128 KB of shared memory for two buffers
MAX_PERMUTATION_ROWS = DEFAULT_TILE
# the C entry's dtype codes
_KEY_DTYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


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


def bitonic_sort_permutation(keys: torch.Tensor,
                             row_count: torch.Tensor) -> torch.Tensor:
    """The (C,) int64 permutation that sorts rows ``< row_count`` ascending
    by ``ordered_u32(keys)`` (ties in row order), then the other rows in
    row order: ``ref.sort_permutation_ref``.

    keys: (C,) int32/uint32/float32, C <= 2048; row_count: the table's 0-d
    int32 count on the keys' device (never read on the host). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted in
    ``bitonic_sort_permutation.launches``) or raises.
    """
    if keys.ndim != 1 or keys.dtype not in _KEY_DTYPES:
        raise TypeError(f"bitonic_sort_permutation takes a 1-D int32/uint32/"
                        f"float32 column, got shape={tuple(keys.shape)} "
                        f"dtype={keys.dtype}")
    (c,) = keys.shape
    if c > MAX_PERMUTATION_ROWS:
        raise ValueError(f"bitonic_sort_permutation sorts at most "
                         f"{MAX_PERMUTATION_ROWS} rows, got {c}")
    if row_count.ndim != 0 or row_count.dtype != torch.int32:
        raise TypeError(f"row_count must be a 0-d int32 tensor, got "
                        f"shape={tuple(row_count.shape)} dtype={row_count.dtype}")
    if row_count.device != keys.device:
        raise ValueError("bitonic_sort_permutation: keys and row_count must "
                         "share one device")
    if keys.device.type == "cpu":
        return ref.sort_permutation_ref(keys, row_count)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort_permutation: unsupported device "
                         f"{keys.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    keys = keys.contiguous()
    perm = torch.empty(c, dtype=torch.int64, device=keys.device)
    if c:
        check("bitonic_sort_permutation", library().repro_bitonic_permutation(
            keys.data_ptr(), _KEY_DTYPES[keys.dtype], c, row_count.data_ptr(),
            perm.data_ptr(), stream_ptr(keys)))
        bitonic_sort_permutation.launches += 1
    return perm


bitonic_sort_permutation.launches = 0


def latency_probe(device: torch.device, steps: int = 1 << 16) -> dict:
    """One warp's chains of ``steps`` dependent steps on the card (see
    ``bitonic_probe`` in the source): a 64-bit compare-exchange in registers
    and a shuffle-compare-select. Returns each chain's SM cycles and ns a
    step, and the SM clock over the first (cycles / ns)."""
    from repro_torch.kernels._build import check, library, stream_ptr

    out = torch.zeros(5, dtype=torch.int64, device=device)
    check("bitonic_probe", library().repro_bitonic_probe(
        0x1234_5678_9ABC_DEF0, steps, out.data_ptr(), stream_ptr(out)))
    cyc_reg, ns_reg, cyc_shfl, ns_shfl, _ = out.tolist()
    return {"steps": steps,
            "register_cycles_per_step": cyc_reg / steps,
            "register_ns_per_step": ns_reg / steps,
            "shuffle_cycles_per_step": cyc_shfl / steps,
            "shuffle_ns_per_step": ns_shfl / steps,
            "sm_ghz": cyc_reg / ns_reg}
