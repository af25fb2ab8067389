"""Segmented running sum/min/max: the wrapper of ``csrc/segment_scan.cu``.

Replaces ``repro/kernels/segment_scan.py::segment_scan_tiles`` (the Pallas
``_scan_kernel``): every ``rank``, ``dense_rank``, ``cumsum``, ``cummax``
and ``running_mean`` of the window functions. The TPU kernel's triangular
same-segment mask and its carry through an in-order grid are not carried
over; the kernel is a single-pass scan with decoupled look-back, one
launch a call, bound by bytes (one read of each value and id, one write of
each output). Its status words carry the call's epoch, so the scratch that
holds them is zeroed only when it is made. Each tile's carry is the left
fold of the tile aggregates before it, in tile order, so the same inputs
give the same bits on every run. See the source's note for the summation
order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

OPS = ("sum", "min", "max")


# (device index, stream) -> [status words, the last call's epoch]: zeroed
# once when made (or grown), each call tags its words with the next epoch
_SCRATCH: dict[tuple[int, int], list] = {}


def _scratch(device: torch.device, stream: int, words: int, epochs: int):
    entry = _SCRATCH.get((device.index, stream))
    if entry is None or entry[0].numel() < words:
        size = max(words, 2 * entry[0].numel() if entry else 0)
        entry = _SCRATCH[(device.index, stream)] = [
            torch.zeros(size, dtype=torch.int64, device=device), 0]
    if entry[1] == epochs:  # every epoch used: start again from clean words
        entry[0].zero_()
        entry[1] = 0
    entry[1] += 1
    return entry[0], entry[1]


def segment_scan_tiles(values: torch.Tensor, seg_ids: torch.Tensor,
                       op: str = "sum", *, inclusive: bool = True
                       ) -> torch.Tensor:
    """Segmented running ``op`` of 1-D f32/i32 ``values`` along the rows.

    ``out[i] = op(values[j] for j <= i with seg_ids[j] == seg_ids[i])``
    (``j < i`` when ``inclusive=False``; rows with no in-segment
    predecessor hold ``ref.seg_init``). seg_ids: (n,) int32 forming
    contiguous runs (sorted, -1 trailing padding allowed). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted in
    ``segment_scan_tiles.launches``) or raises.
    """
    if op not in OPS:
        raise ValueError(op)
    if values.ndim != 1 or values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"segment_scan_tiles takes 1-D f32/i32 values, got "
                        f"shape={tuple(values.shape)} dtype={values.dtype}")
    if seg_ids.shape != values.shape or seg_ids.dtype != torch.int32:
        raise TypeError("seg_ids must be int32 with the values' shape")
    if values.device.type == "cpu":
        return ref.segment_scan_ref(values, seg_ids, op, inclusive)
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(f"segment_scan_tiles: unsupported devices "
                         f"{values.device}, {seg_ids.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_scan_tiles takes contiguous tensors")
    from repro_torch.kernels._build import check, library, stream_ptr

    n = values.numel()
    out = torch.empty_like(values)
    if n == 0:
        return out
    lib = library()
    # the ticket and one status word a tile; the tiles start up to 3 rows
    # before row 0 (at the inputs' first 16-byte boundary)
    words = -(-(n + 3) // lib.repro_segment_scan_rows_per_block()) + 1
    scratch, epoch = _scratch(values.device, stream_ptr(values), words,
                              lib.repro_segment_scan_epochs())
    check("segment_scan_tiles", lib.repro_segment_scan(
        values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), n, OPS.index(op),
        int(values.dtype == torch.float32), int(inclusive),
        scratch.data_ptr(), epoch, stream_ptr(values)))
    segment_scan_tiles.launches += 1
    return out


segment_scan_tiles.launches = 0
