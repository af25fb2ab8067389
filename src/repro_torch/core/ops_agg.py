"""Keyed aggregation (GroupBy): the port of the groupby half of
``repro.core.ops_agg``.

The local algorithm is sort-based and keeps the compacted-front invariant:

    sort by key  ->  segment-boundary detection  ->  segment reductions

with exact multi-column keys. The reductions run on the segment_reduce
kernel for 1-D f32/i32/f64 columns and on the plain scatter otherwise
(N-D payloads, int64).
Aggregators sum/count/min/max/mean/var/first decompose into algebraic
partials (sum, sumsq, count, min, max, first) that combine across shards:
``groupby == finalize . partial_groupby`` locally, and
``finalize . combine . shuffle . partial`` distributed (the two-phase
strategy of arXiv:2010.14596).

Output Table: one row per group (compacted to the front, ordered by key),
columns = key columns + ``{col}_{agg}``.

Window functions (:func:`window`) ride the same sorted-segment machinery
but keep every row: sort by (keys, order), detect group segments and value
runs, then express every function as a segmented prefix scan (the
segment_scan kernel) or an in-segment gather. The building blocks
(:func:`window_state`, :func:`window_sorted`, :func:`window_summary`,
:func:`window_lead_summary`) are shared with ``ops_dist.dist_window``,
which stitches groups that span shards.
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
    st = L.sort_by(L.pad_empty(table), list(keys))
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


# ---------------------------------------------------------------------------
# window functions (row-preserving analytics over sorted segments)
# ---------------------------------------------------------------------------

WINDOW_FUNCS = ("rank", "dense_rank", "row_number", "lag", "lead",
                "cumsum", "cummax", "running_mean")
_NO_COL_FUNCS = ("rank", "dense_rank", "row_number")
_SCAN_COL_FUNCS = ("cumsum", "cummax", "running_mean")


def normalize_funcs(funcs) -> tuple[tuple[str, str | None, int], ...]:
    """Canonicalize a window-function spec to ``((fn, col, offset), ...)``.

    Accepts a single string, or a sequence of: ``"rank"`` (column-free
    funcs), ``("cumsum", "d0")``, ``("lag", "d0")`` (offset defaults to 1),
    ``("lag", "d0", 3)``. Raises ValueError on a bad spec.
    """
    if isinstance(funcs, str):
        funcs = [funcs]
    out = []
    for f in funcs:
        if isinstance(f, str):
            fn, col, off = f, None, 0
        else:
            f = tuple(f)
            fn, col = f[0], f[1]
            off = int(f[2]) if len(f) > 2 else 0
        if fn not in WINDOW_FUNCS:
            raise ValueError(f"unknown window function {fn!r}; expected one "
                             f"of {WINDOW_FUNCS}")
        if fn in _NO_COL_FUNCS and col is not None:
            raise ValueError(f"{fn} takes no column (got {col!r})")
        if fn not in _NO_COL_FUNCS and col is None:
            raise ValueError(f"{fn} needs a column")
        if fn in ("lag", "lead"):
            off = 1 if off == 0 else off
            if off < 1:
                raise ValueError(f"{fn} offset must be >= 1 (got {off})")
        elif off != 0:
            raise ValueError(f"{fn} takes no offset")
        out.append((fn, col, off))
    return tuple(out)


def window_output_name(fn: str, col: str | None, offset: int = 0) -> str:
    """Output column name: ``rank`` / ``{col}_cumsum`` / ``{col}_lag`` /
    ``{col}_lag{k}`` for offsets beyond the default 1."""
    if col is None:
        return fn
    if fn in ("lag", "lead") and offset > 1:
        return f"{col}_{fn}{offset}"
    return f"{col}_{fn}"


def carry_requirements(pairs):
    """Static description of the cross-shard carry a funcs set needs:
    ``(sums, maxs, lag, lead)`` where sums maps internal slot name ->
    (col, 'native'|'f32'), maxs is a column set, lag/lead map col -> the
    largest requested offset (the boundary-buffer depth)."""
    sums: dict[str, tuple[str, str]] = {}
    maxs: set[str] = set()
    lag: dict[str, int] = {}
    lead: dict[str, int] = {}
    for fn, col, off in pairs:
        if fn == "cumsum":
            sums[f"cumsum:{col}"] = (col, "native")
        elif fn == "running_mean":
            sums[f"rmean:{col}"] = (col, "f32")
        elif fn == "cummax":
            maxs.add(col)
        elif fn == "lag":
            lag[col] = max(lag.get(col, 0), off)
        elif fn == "lead":
            lead[col] = max(lead.get(col, 0), off)
    return sums, maxs, lag, lead


def _dtype_min(dtype: torch.dtype):
    """The smallest value of ``dtype`` (-inf for floats), a Python scalar."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _tuple_eq(cols_a, cols_b, device) -> torch.Tensor:
    """0-d bool on ``device``: equality of two same-keyed dicts of 0-d
    tensors (True if empty)."""
    eq = torch.ones((), dtype=torch.bool, device=device)
    for k in cols_a:
        eq = eq & (cols_a[k] == cols_b[k])
    return eq


def _at(col: torch.Tensor, idx) -> torch.Tensor:
    """``col[clip(idx, 0, cap-1)]`` for an int or an integer tensor of any
    shape (a 0-d one included: it is gathered as a 1-element index, never
    read on the host)."""
    cap = col.shape[0]
    if isinstance(idx, int):
        return col[min(max(idx, 0), cap - 1)]
    ci = idx.clamp(0, cap - 1).to(torch.int64)
    return col[ci.reshape(-1)].reshape(idx.shape + col.shape[1:])


def window_state(st: Table, by: Sequence[str], order_by: Sequence[str]):
    """Segment/run geometry of an ALREADY (by + order_by)-sorted table.

    Returns a dict: per-row ``seg`` (group id, -1 invalid), ``starts``
    (group start row, indexed by group id), ``pos`` (0-based position
    within group), ``vb`` (True at the first row of each (by + order_by)
    value run) and ``end_excl`` (one past the row's group's last row),
    and the 0-d ``num_groups``. int32 throughout, as in the reference.
    """
    cap = st.capacity
    dev = st.device
    valid = st.valid_mask()
    ar = torch.arange(cap, dtype=torch.int32, device=dev)
    pos0 = ar == 0
    differs_by = torch.zeros(cap, dtype=torch.bool, device=dev)
    for k in by:
        col = st.columns[k]
        differs_by = differs_by | (col != torch.roll(col, 1, 0))
    boundary = valid & (differs_by | pos0)
    seg = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(valid, seg, -1)
    num_groups = boundary.sum().to(torch.int32)
    # the boundary rows' indices go to slot seg[i]; other rows to a dump
    # slot that is cut off (a scatter: no host sync)
    starts = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    slot = torch.where(boundary, seg, cap).to(torch.int64)
    starts.index_put_((slot,), ar)
    starts = starts[:cap]
    differs_run = differs_by
    for k in order_by:
        col = st.columns[k]
        differs_run = differs_run | (col != torch.roll(col, 1, 0))
    vb = valid & (differs_run | pos0)
    pos = torch.where(valid, ar - _at(starts, seg), 0)
    next_start = _at(starts, seg + 1)
    end_excl = torch.where(seg + 1 < num_groups, next_start, st.row_count)
    end_excl = torch.where(valid, end_excl, 0)
    return {"seg": seg, "starts": starts, "pos": pos, "vb": vb,
            "num_groups": num_groups, "end_excl": end_excl}


def window_sorted(st: Table, state, by: Sequence[str],
                  order_by: Sequence[str], pairs, *, carry=None,
                  lead_carry=None, use_kernel=None) -> dict[str, torch.Tensor]:
    """Window output columns over a (by + order_by)-sorted table.

    ``carry`` / ``lead_carry`` are the cross-shard boundary states built by
    ``ops_dist`` (None for a purely local frame): ``carry`` folds the
    preceding shards' trailing-group partials into this shard's LEADING
    group, ``lead_carry`` folds the following shards' heading-group values
    into this shard's TRAILING group (lead only). Every function is exact
    under both: the distributed result equals the single-host one bit for
    bit on integer-valued columns. No host sync.
    """
    cap = st.capacity
    dev = st.device
    valid = st.valid_mask()
    seg, pos, vb = state["seg"], state["pos"], state["vb"]
    end_excl, num_groups = state["end_excl"], state["num_groups"]
    ar = torch.arange(cap, dtype=torch.int32, device=dev)
    sums_req, maxs_req, _, _ = carry_requirements(pairs)
    fns = {fn for fn, _, _ in pairs}

    def scan(v, op):
        return kops.segment_scan(v, seg, op, use_kernel=use_kernel)

    rn = pos + 1  # 1-based row number within group
    dr_local = rk = dr = None
    if "dense_rank" in fns or "rank" in fns:
        dr_local = scan(vb.to(torch.int32), "sum")
        dr = dr_local
    if "rank" in fns:
        rk = scan(torch.where(vb, rn, 0).to(torch.int32), "max")
    cs = {}
    for name, (col, kind) in sums_req.items():
        v = st.columns[col]
        cs[name] = scan(v.to(torch.float32) if kind == "f32" else v, "sum")
    cm = {col: scan(st.columns[col], "max") for col in sorted(maxs_req)}
    lg, ld = {}, {}
    for fn, col, off in pairs:
        if fn == "lag":
            v = _at(st.columns[col], ar - off)
            lg[(col, off)] = torch.where(valid & (pos >= off), v,
                                         torch.zeros_like(v))
        elif fn == "lead":
            v = _at(st.columns[col], ar + off)
            ld[(col, off)] = torch.where(valid & (ar + off < end_excl), v,
                                         torch.zeros_like(v))

    if carry is not None:
        first_by = {k: st.columns[k][0] for k in by}
        match = carry["has"] & (st.row_count > 0) \
            & _tuple_eq(first_by, carry["key"], dev)
        m = (seg == 0) & match
        C = carry["count"]
        if "rank" in fns or "dense_rank" in fns:
            first_order = {k: st.columns[k][0] for k in order_by}
            cont = match & _tuple_eq(first_order, carry["last_order"], dev)
        if "rank" in fns:
            # rows continuing the previous shards' trailing VALUE RUN take
            # the run's global rank (C - E + 1); other leading-group rows
            # shift by the carried row count
            run0 = m & (dr_local == 1)
            rk = torch.where(run0 & cont, C - carry["run_eq"] + 1,
                             torch.where(m, rk + C, rk))
        if "dense_rank" in fns:
            dr = torch.where(m, dr + carry["runs"] - cont.to(torch.int32), dr)
        rn = torch.where(m, rn + C, rn)
        for name in cs:
            cs[name] = torch.where(m, cs[name] + carry["sums"][name], cs[name])
        for col in cm:
            cm[col] = torch.where(m, torch.maximum(cm[col], carry["maxs"][col]),
                                  cm[col])
        for (col, off), v in lg.items():
            buf = carry["lag"][col]  # (K,): buf[j] = j+1 rows before the cut
            j = off - 1 - pos
            take = m & (pos < off) & (j < C)
            lg[(col, off)] = torch.where(take, _at(buf, j), v)

    if lead_carry is not None:
        idx_last = torch.clamp(st.row_count - 1, min=0)
        last_by = {k: _at(st.columns[k], idx_last) for k in by}
        match_l = lead_carry["has"] & (st.row_count > 0) \
            & _tuple_eq(last_by, lead_carry["key"], dev)
        in_last = valid & (seg == num_groups - 1)
        e = end_excl - 1 - ar  # rows after this one within its group
        H = lead_carry["head_count"]
        for (col, off), v in ld.items():
            buf = lead_carry["head"][col]  # (K,): buf[j] = j-th row after cut
            j = off - 1 - e
            take = in_last & match_l & (e < off) & (j < H)
            ld[(col, off)] = torch.where(take, _at(buf, j), v)

    out: dict[str, torch.Tensor] = {}
    for fn, col, off in pairs:
        name = window_output_name(fn, col, off)
        if fn == "row_number":
            out[name] = torch.where(valid, rn, 0).to(torch.int32)
        elif fn == "rank":
            out[name] = torch.where(valid, rk, 0).to(torch.int32)
        elif fn == "dense_rank":
            out[name] = torch.where(valid, dr, 0).to(torch.int32)
        elif fn == "cumsum":
            v = cs[f"cumsum:{col}"]
            out[name] = torch.where(valid, v, torch.zeros_like(v))
        elif fn == "cummax":
            v = cm[col]
            out[name] = torch.where(valid, v, torch.zeros_like(v))
        elif fn == "running_mean":
            v = cs[f"rmean:{col}"] / torch.clamp(rn, min=1).to(torch.float32)
            out[name] = torch.where(valid, v, 0.0)
        elif fn == "lag":
            out[name] = lg[(col, off)]
        elif fn == "lead":
            out[name] = ld[(col, off)]
    return out


def window_summary(st: Table, state, by: Sequence[str],
                   order_by: Sequence[str], pairs):
    """This shard's TRAILING-group boundary state (for the next shards).

    0-d tensors and fixed (K,) buffers, the per-shard payload of the
    boundary ``all_gather``: the trailing group's row count, algebraic
    partials (sum/max per carried column), value-run count, trailing-run
    size, the boundary key/order tuples, and the last ``K`` values per lag
    column (K = largest requested offset).
    """
    cap = st.capacity
    dev = st.device
    rc = st.row_count
    valid = st.valid_mask()
    idx_last = torch.clamp(rc - 1, min=0)
    starts, vb = state["starts"], state["vb"]
    num_groups = state["num_groups"]
    gstart = _at(starts, num_groups - 1)
    count = (rc - gstart).to(torch.int32)
    tm = (torch.arange(cap, device=dev) >= gstart) & valid
    sums_req, maxs_req, lag_req, _ = carry_requirements(pairs)

    eq_last = torch.ones(cap, dtype=torch.bool, device=dev)
    for k in order_by:
        col = st.columns[k]
        eq_last = eq_last & (col == _at(col, idx_last))
    summ = {
        "rows": rc,
        "first_by": {k: st.columns[k][0] for k in by},
        "last_by": {k: _at(st.columns[k], idx_last) for k in by},
        "first_order": {k: st.columns[k][0] for k in order_by},
        "last_order": {k: _at(st.columns[k], idx_last) for k in order_by},
        "count": count,
        "runs": (vb & tm).sum().to(torch.int32),
        "run_eq": (tm & eq_last).sum().to(torch.int32),
        "sums": {}, "maxs": {}, "lag": {},
    }
    for name, (col, kind) in sums_req.items():
        v = st.columns[col]
        v = v.to(torch.float32) if kind == "f32" else v
        # an int32 sum wraps, as XLA's does: torch sums in int64, and the
        # cast keeps the low 32 bits
        summ["sums"][name] = torch.where(tm, v, torch.zeros_like(v)).sum() \
            .to(v.dtype)
    for col in sorted(maxs_req):
        v = st.columns[col]
        lo = torch.full((), _dtype_min(v.dtype), dtype=v.dtype, device=dev)
        summ["maxs"][col] = torch.where(tm, v, lo).max()
    for col, k in lag_req.items():
        idxs = rc - 1 - torch.arange(k, dtype=torch.int32, device=dev)
        ok = (idxs >= gstart) & (idxs >= 0)
        v = _at(st.columns[col], idxs)
        summ["lag"][col] = torch.where(ok, v, torch.zeros_like(v))
    return summ


def window_lead_summary(st: Table, state, by: Sequence[str], pairs):
    """This shard's HEADING-group boundary state (for the previous shards):
    the heading group's row count and its first ``K`` values per lead
    column."""
    dev = st.device
    rc = st.row_count
    starts, num_groups = state["starts"], state["num_groups"]
    head = torch.where(num_groups > 1, _at(starts, 1), rc).to(torch.int32)
    _, _, _, lead_req = carry_requirements(pairs)
    idx_last = torch.clamp(rc - 1, min=0)
    summ = {
        "rows": rc,
        "first_by": {k: st.columns[k][0] for k in by},
        "last_by": {k: _at(st.columns[k], idx_last) for k in by},
        "head_count": head,
        "head": {},
    }
    for col, k in lead_req.items():
        idxs = torch.arange(k, dtype=torch.int32, device=dev)
        v = _at(st.columns[col], idxs)
        summ["head"][col] = torch.where(idxs < head, v, torch.zeros_like(v))
    return summ


def _window_validate(table: Table, by, order_by, pairs) -> None:
    for k in list(by) + list(order_by):
        if table.columns[k].ndim != 1:
            raise ValueError(f"window key {k!r} must be 1-D")
    for fn, col, off in pairs:
        name = window_output_name(fn, col, off)
        if name in table.columns:
            raise ValueError(f"window output {name!r} collides with an input "
                             f"column")
        if col is None:
            continue
        v = table.columns[col]
        if v.ndim != 1:
            raise ValueError(f"window input {col!r} must be 1-D")
        if fn in _SCAN_COL_FUNCS and v.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{fn} needs f32/i32 input; {col!r} is {v.dtype}")


def window(table: Table, by: Sequence[str] | str, funcs, *,
           order_by: Sequence[str] | str = (), use_kernel=None) -> Table:
    """Window functions over sorted segments: row-preserving analytics.

    ``by``: partition key column(s); ``order_by``: in-group ordering
    column(s); ``funcs``: see :func:`normalize_funcs`. Returns the input
    rows SORTED by (by, order_by), the canonical frame order, with one
    appended column per requested function (:func:`window_output_name`):

    ``rank``/``dense_rank``/``row_number`` (int32, 1-based; ties on the
    full (by, order_by) tuple share rank), ``lag``/``lead`` (the value
    ``offset`` rows away within the group, 0 outside it), ``cumsum``/
    ``cummax`` (running aggregate in the column dtype), ``running_mean``
    (f32).
    """
    by = [by] if isinstance(by, str) else list(by)
    order = [order_by] if isinstance(order_by, str) else list(order_by)
    pairs = normalize_funcs(funcs)
    _window_validate(table, by, order, pairs)
    st = L.sort_by(L.pad_empty(table), by + order)
    state = window_state(st, by, order)
    cols = window_sorted(st, state, by, order, pairs, use_kernel=use_kernel)
    return Table({**st.columns, **cols}, st.row_count)
