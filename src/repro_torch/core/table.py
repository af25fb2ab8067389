"""Columnar Table: the port of ``repro.core.table``.

A Table is a struct of tensors: every column is a tensor whose leading
dimension is the same static length (the *capacity*), plus an int32 0-d
tensor ``row_count``. Rows ``[0, row_count)`` are valid and compacted to the
front; rows ``[row_count, capacity)`` are garbage. Columns may be N-D (a row
is then a record of vectors); sort keys and hash inputs are 1-D.

``row_count`` stays a device tensor so that operators never wait for the
device; only the host-side edges (``to_numpy``) read it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import resolve_device

KEY_DTYPES = (torch.int32, torch.uint32, torch.float32)


def _rc(n, device) -> torch.Tensor:
    """An int32 0-d row count on ``device`` from an int or a tensor."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(n), dtype=torch.int32, device=device)


def take_rows(cols: dict[str, torch.Tensor],
              idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """``col[clip(idx, 0, cap-1)]`` for every column of one capacity: JAX's
    clamped gather, with the index clamped once. Capacity 0 gives zeros of
    the index's length."""
    if not cols:
        return {}
    cap = next(iter(cols.values())).shape[0]
    if cap == 0:
        return {k: torch.zeros(idx.shape + v.shape[1:], dtype=v.dtype,
                               device=v.device) for k, v in cols.items()}
    ci = idx.clamp(0, cap - 1)
    return {k: v[ci] for k, v in cols.items()}


def where_rows(sel: torch.Tensor, col: torch.Tensor,
               other: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise select: ``sel`` (rows,) broadcast over trailing dims; rows
    not selected take ``other`` (zeros by default)."""
    sel = sel.reshape(sel.shape + (1,) * (col.ndim - 1))
    if other is None:
        other = torch.zeros((), dtype=col.dtype, device=col.device)
    return torch.where(sel, col, other)


@dataclasses.dataclass(frozen=True)
class Table:
    """Fixed-capacity columnar table. Columns share length == capacity."""

    columns: dict[str, torch.Tensor]
    row_count: torch.Tensor  # int32 0-d

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_numpy(cls, columns: dict[str, np.ndarray], row_count=None,
                   capacity: int | None = None,
                   device: str | torch.device = "cuda") -> "Table":
        """Build from host arrays sharing their leading length.

        ``capacity`` pads every column with zero rows past that length;
        ``row_count`` defaults to the arrays' length. The inverse of
        :meth:`to_numpy` (which trims to ``row_count``).
        """
        dev = resolve_device(device)
        arrs = {k: np.asarray(v) for k, v in columns.items()}
        lens = {v.shape[0] for v in arrs.values()}
        if len(lens) != 1:
            raise ValueError(f"ragged columns: { {k: v.shape for k, v in arrs.items()} }")
        n = lens.pop()
        cols = {}
        for k, v in arrs.items():
            t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            if capacity is not None and capacity != n:
                if capacity < n:
                    raise ValueError(f"capacity {capacity} < rows {n}")
                pad = torch.zeros((capacity - n,) + t.shape[1:], dtype=t.dtype,
                                  device=dev)
                t = torch.cat([t, pad])
            cols[k] = t
        return cls(cols, _rc(n if row_count is None else row_count, dev))

    @classmethod
    def empty(cls, schema: dict, capacity: int,
              device: str | torch.device = "cuda") -> "Table":
        """Pre-allocate an all-invalid table. ``schema`` values are a torch
        dtype (1-D column) or a ``(dtype, trailing_shape)`` tuple."""
        dev = resolve_device(device)
        cols = {}
        for k, spec in schema.items():
            if isinstance(spec, tuple):
                dt, tail = spec[0], tuple(spec[1])
            else:
                dt, tail = spec, ()
            cols[k] = torch.zeros((capacity,) + tail, dtype=dt, device=dev)
        return cls(cols, _rc(0, dev))

    # -- introspection --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_count.device

    @property
    def column_names(self) -> list[str]:
        return sorted(self.columns)

    @property
    def key_column_names(self) -> list[str]:
        return [k for k, v in sorted(self.columns.items())
                if v.ndim == 1 and v.dtype in KEY_DTYPES]

    @property
    def schema(self) -> dict[str, torch.dtype]:
        return {k: v.dtype for k, v in sorted(self.columns.items())}

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.row_count

    def __repr__(self) -> str:
        return f"Table(cols={self.column_names}, capacity={self.capacity})"

    # -- host-side materialization --------------------------------------------
    def to_numpy(self) -> dict[str, np.ndarray]:
        """Valid rows on the host, names sorted. Waits for the device."""
        n = int(self.row_count)
        return {k: v[:n].cpu().numpy() for k, v in sorted(self.columns.items())}

    def to_rows(self) -> list[tuple]:
        d = self.to_numpy()
        names = sorted(d)
        return list(zip(*(d[n] for n in names))) if names else []

    # -- functional helpers ----------------------------------------------------
    def with_columns(self, columns: dict[str, torch.Tensor]) -> "Table":
        return Table({**self.columns, **columns}, self.row_count)

    def rename(self, mapping: dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()},
                     self.row_count)

    def gather(self, idx: torch.Tensor, row_count,
               fill_invalid: bool = True) -> "Table":
        """Reorder rows by ``idx`` (len == new capacity). idx == -1 -> 0."""
        cols = take_rows(self.columns, idx)
        if fill_invalid:
            sel = idx >= 0
            cols = {k: where_rows(sel, v) for k, v in cols.items()}
        return Table(cols, _rc(row_count, self.device))


def concat_tables(a: Table, b: Table) -> Table:
    """Concatenate (capacity = sum of capacities), valid rows in front:
    b's valid rows follow a's, moved there by a gather."""
    if a.schema != b.schema:
        raise ValueError(f"schema mismatch: {a.schema} vs {b.schema}")
    n = a.capacity + b.capacity
    pos = torch.arange(n, device=a.device)
    from_a = pos < a.row_count
    ib = pos - a.row_count
    valid_b = (ib >= 0) & (ib < b.row_count)
    va = take_rows(a.columns, pos)
    vb = take_rows(b.columns, ib)
    cols = {k: where_rows(from_a, va[k], where_rows(valid_b, vb[k]))
            for k in a.columns}
    return Table(cols, (a.row_count + b.row_count).to(torch.int32))
