"""Segmented sum/min/max: the wrapper of ``csrc/segment_reduce.cu``.

Replaces ``repro/kernels/segment_reduce.py::segment_reduce_tiles`` (the
Pallas one-hot ``_seg_kernel``): every groupby aggregation, at a segment
count equal to the table's capacity. The one-hot is O(N * G) and is not
carried over; the kernel folds runs of equal ids and is bound by bytes (one
read of each row, one write of each segment). A block reads its 4096-row
tile once with 16-byte loads and reduces it in registers and shuffles to a
fixed-size summary (first run, last run); one more block merges the tiles'
summaries in a tree, so runs that cross tiles are never walked serially.
No float atomics: the same inputs give the same bits on every run. See the
source's note for the summation order. Values are int32, float32 or
float64, each folded in its own type (scratch records included); a
128-row chunk whose ids are all out of range is read for its ids alone.

The kernel needs each in-range id's rows to form one contiguous run (ids
outside the range may lie anywhere: the kernel skips their runs). Groupby,
the only caller on the path, passes its segments sorted with a -1 tail and
says so (``contiguous_runs=True``), so the wrapper launches straight away.
For any other input the wrapper checks, on the host after one sync, that
the ids are non-decreasing once out-of-range ids are read as
``num_segments``, and permutes the rows by a stable sort of (id, row) when
they are not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

OPS = ("sum", "min", "max")
# the values' types the kernel has an instance for, in the C interface's
# order of dtype codes
DTYPES = (torch.int32, torch.float32, torch.float64)


def segment_reduce_tiles(values: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, op: str = "sum", *,
                         contiguous_runs: bool = False) -> torch.Tensor:
    """``out[g] = op(values[i] : seg_ids[i] == g)`` for 1-D f32/i32/f64 values.

    seg_ids: (n,) int32; entries outside [0, num_segments) are ignored.
    Empty segments hold ``ref.seg_init``. Any segment count.
    ``contiguous_runs=True`` promises that each in-range id's rows are one
    contiguous run, and skips the check (and its host sync). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted in
    ``segment_reduce_tiles.launches``) or raises.
    """
    if op not in OPS:
        raise ValueError(op)
    if values.ndim != 1 or values.dtype not in DTYPES:
        raise TypeError(f"segment_reduce_tiles takes 1-D f32/i32/f64 values, got "
                        f"shape={tuple(values.shape)} dtype={values.dtype}")
    if seg_ids.shape != values.shape or seg_ids.dtype != torch.int32:
        raise TypeError("seg_ids must be int32 with the values' shape")
    if values.device.type == "cpu":
        return ref.segment_reduce_ref(values, seg_ids, num_segments, op)
    if values.device.type != "cuda":
        raise ValueError(f"segment_reduce_tiles: unsupported device {values.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    g = int(num_segments)
    n = values.numel()
    ids, vals = seg_ids, values
    if not contiguous_runs and n > 1:
        mapped = torch.where((seg_ids >= 0) & (seg_ids < g), seg_ids, g)
        if not bool((mapped[1:] >= mapped[:-1]).all()):
            ids, perm = torch.sort(mapped, stable=True)
            vals = values[perm]
    ids, vals = ids.contiguous(), vals.contiguous()
    out = torch.empty(g, dtype=values.dtype, device=values.device)
    lib = library()
    nblocks = max(1, -(-n // lib.repro_segment_reduce_rows_per_block()))
    scratch_t = torch.empty(2 * nblocks, dtype=values.dtype, device=values.device)
    scratch_i = torch.empty(3 * nblocks, dtype=torch.int32, device=values.device)
    check("segment_reduce_tiles", lib.repro_segment_reduce(
        vals.data_ptr(), ids.data_ptr(), out.data_ptr(), n, g, OPS.index(op),
        DTYPES.index(values.dtype), scratch_t.data_ptr(),
        scratch_i.data_ptr(), stream_ptr(values)))
    segment_reduce_tiles.launches += 1
    return out


segment_reduce_tiles.launches = 0
