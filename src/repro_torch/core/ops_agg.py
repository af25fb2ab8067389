"""Keyed aggregation (GroupBy): the port of the groupby half of
``repro.core.ops_agg``.

The local algorithm is sort-based and keeps the compacted-front invariant:

    sort by key  ->  segment-boundary detection  ->  segment reductions

with exact multi-column keys. The reductions run on the segment_reduce
kernel for 1-D f32/i32 columns and on the plain scatter otherwise.
Aggregators sum/count/min/max/mean/var/first decompose into algebraic
partials (sum, sumsq, count, min, max, first) that combine across shards:
``groupby == finalize . partial_groupby`` locally, and
``finalize . combine . shuffle . partial`` distributed (the two-phase
strategy of arXiv:2010.14596).

Output Table: one row per group (compacted to the front, ordered by key),
columns = key columns + ``{col}_{agg}``. The window half of the reference
module waits for the segment_scan kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import ops_local as L
from repro_torch.core.table import Table, where_rows
from repro_torch.kernels import ops as kops

AGG_OPS = ("sum", "count", "min", "max", "mean", "var", "first")

# aggregator -> algebraic partials it needs
_DECOMP = {
    "sum": ("sum",),
    "count": ("count",),
    "min": ("min",),
    "max": ("max",),
    "mean": ("sum", "count"),
    "var": ("sum", "sumsq", "count"),
    "first": ("first",),
}
_COMBINE = {"sum": "sum", "sumsq": "sum", "count": "sum",
            "min": "min", "max": "max", "first": "first"}


def normalize_aggs(aggs) -> tuple[tuple[str, str], ...]:
    """Accept {col: op | [ops]} or [(col, op), ...] -> ((col, op), ...)."""
    if isinstance(aggs, dict):
        pairs = []
        for col, ops in aggs.items():
            ops = [ops] if isinstance(ops, str) else list(ops)
            pairs += [(col, op) for op in ops]
    else:
        pairs = [(c, o) for c, o in aggs]
    for _, op in pairs:
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregator {op!r}; expected one of {AGG_OPS}")
    return tuple(pairs)


def _prim_name(col: str, prim: str) -> str:
    """Internal partial-column name (count is group size, column-free)."""
    return "__count" if prim == "count" else f"__{prim}__{col}"


def _segments(table: Table, keys: Sequence[str]):
    """Sort by keys -> (sorted table, seg (cap,) int32 [-1 invalid],
    num_groups int32, starts (cap,) int64 first row of each group)."""
    if table.capacity == 0:
        table = Table({k: torch.zeros((1,) + v.shape[1:], dtype=v.dtype,
                                      device=v.device)
                       for k, v in table.columns.items()}, table.row_count)
    st = L.sort_by(table, list(keys))
    cap = st.capacity
    dev = st.device
    valid = st.valid_mask()
    differs = torch.zeros(cap, dtype=torch.bool, device=dev)
    for k in keys:
        col = st.columns[k]
        differs = differs | (col != torch.roll(col, 1, 0))
    boundary = valid & (differs | (torch.arange(cap, device=dev) == 0))
    seg = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(valid, seg, -1)
    num_groups = boundary.sum().to(torch.int32)
    # one boundary row per group: its row index goes to slot seg[i]; other
    # rows go to a dump slot that is cut off (a scatter, so no host sync)
    starts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    slot = torch.where(boundary, seg.to(torch.int64), cap)
    starts.index_put_((slot,), torch.arange(cap, device=dev))
    return st, seg, num_groups, starts[:cap]


def _first(col: torch.Tensor, starts: torch.Tensor,
           group_valid: torch.Tensor) -> torch.Tensor:
    """Per-group value at the segment start (stable sort => first in input
    order). Works for N-D payload columns."""
    return where_rows(group_valid, col[starts])


def _reduce(col: torch.Tensor, seg: torch.Tensor, slots: int, prim: str,
            group_valid: torch.Tensor, use_kernel) -> torch.Tensor:
    """One algebraic partial over a (cap, ...) column -> (slots, ...)."""
    if prim == "sumsq":
        col = col.to(torch.float32)
        col = col * col
        prim = "sum"
    # seg comes from _segments: sorted runs, then -1 on the invalid tail
    out = kops.segment_reduce(col, seg, slots, prim, use_kernel=use_kernel,
                              contiguous_runs=True)
    # empty slots hold the op identity (e.g. +inf for min): zero them so rows
    # past row_count stay benign garbage
    return where_rows(group_valid, out)


def _partial_columns(table: Table, keys: Sequence[str], pairs, *,
                     out_capacity: int | None = None, use_kernel=None) -> Table:
    """Shared phase-1 machinery: per-group key values + algebraic partials,
    into ``out_capacity`` slots when given (groups past it truncate)."""
    st, seg, num_groups, starts = _segments(table, keys)
    cap = st.capacity
    slots = cap if out_capacity is None else min(cap, out_capacity)
    row_count = torch.clamp(num_groups, max=slots)
    group_valid = torch.arange(slots, device=st.device) < row_count
    starts = starts[:slots]

    cols: dict[str, torch.Tensor] = {}
    for k in keys:
        cols[k] = _first(st.columns[k], starts, group_valid)
    prims = {(c, p) for c, op in pairs for p in _DECOMP[op]}
    for col, prim in sorted(prims, key=lambda cp: _prim_name(*cp)):
        name = _prim_name(col, prim)
        if name in cols:
            continue  # shared count slot
        if prim == "count":
            ones = (seg >= 0).to(torch.int32)
            cols[name] = _reduce(ones, seg, slots, "sum", group_valid,
                                 use_kernel)
        elif prim == "first":
            cols[name] = _first(st.columns[col], starts, group_valid)
        else:
            cols[name] = _reduce(st.columns[col], seg, slots, prim,
                                 group_valid, use_kernel)
    return Table(cols, row_count)


def _finalize(partial: Table, keys: Sequence[str], pairs) -> Table:
    """Turn algebraic partials into the user-facing aggregate columns."""
    cols = {k: partial.columns[k] for k in keys}

    def get(c, p):
        return partial.columns[_prim_name(c, p)]

    for col, op in pairs:
        name = f"{col}_{op}"
        if op in ("sum", "min", "max", "first"):
            cols[name] = get(col, op)
        elif op == "count":
            cols[name] = get(col, "count")
        elif op in ("mean", "var"):
            s = get(col, "sum").to(torch.float32)
            n = torch.clamp(get(col, "count"), min=1).to(torch.float32)
            n = n.reshape((-1,) + (1,) * (s.ndim - 1))
            mean = s / n
            if op == "mean":
                cols[name] = mean
            else:  # population variance: E[x^2] - E[x]^2, clamped at 0
                cols[name] = torch.clamp(get(col, "sumsq") / n - mean * mean,
                                         min=0.0)
    return Table(cols, partial.row_count)


def groupby(table: Table, keys: Sequence[str] | str, aggs, *,
            out_capacity: int | None = None, use_kernel=None) -> Table:
    """Local GroupBy: one output row per distinct key tuple, ordered by key.

    aggs: {col: op | [ops]} or [(col, op), ...]; ops in AGG_OPS. Output
    columns: keys + ``{col}_{op}``; row_count = number of groups.
    """
    keys = [keys] if isinstance(keys, str) else list(keys)
    pairs = normalize_aggs(aggs)
    partial = _partial_columns(table, keys, pairs, out_capacity=out_capacity,
                               use_kernel=use_kernel)
    return _finalize(partial, keys, pairs)


def partial_groupby(table: Table, keys: Sequence[str] | str, aggs, *,
                    out_capacity: int | None = None, use_kernel=None) -> Table:
    """Phase 1 of the two-phase strategy: per-shard algebraic partials."""
    keys = [keys] if isinstance(keys, str) else list(keys)
    pairs = normalize_aggs(aggs)
    return _partial_columns(table, keys, pairs, out_capacity=out_capacity,
                            use_kernel=use_kernel)


def combine_groupby(partials: Table, keys: Sequence[str] | str, aggs, *,
                    out_capacity: int | None = None, use_kernel=None) -> Table:
    """Phase 2: merge partial rows that share a key, then finalize. Sums
    add, min/max re-reduce, first takes the earliest partial in row order."""
    keys = [keys] if isinstance(keys, str) else list(keys)
    pairs = normalize_aggs(aggs)
    st, seg, num_groups, starts = _segments(partials, keys)
    cap = st.capacity
    slots = cap if out_capacity is None else min(cap, out_capacity)
    row_count = torch.clamp(num_groups, max=slots)
    group_valid = torch.arange(slots, device=st.device) < row_count
    starts = starts[:slots]

    cols = {k: _first(st.columns[k], starts, group_valid) for k in keys}
    for name in st.column_names:
        if not name.startswith("__"):
            continue
        prim = "count" if name == "__count" else name[2:].split("__", 1)[0]
        comb = _COMBINE[prim]
        if comb == "first":
            cols[name] = _first(st.columns[name], starts, group_valid)
        else:
            cols[name] = _reduce(st.columns[name], seg, slots, comb,
                                 group_valid, use_kernel)
    return _finalize(Table(cols, row_count), keys, pairs)
