"""Local relational operators: the port of ``repro.core.ops_local``.

Every operator keeps the Table invariant (valid rows compacted to the front,
static capacity) and returns the same rows as the reference, bit for bit.
Cylon's operator set: Select, Project, Join (inner/left/right/full-outer;
hash and sort algorithms), Union, Intersect, Difference, and the local
building blocks Sort, Merge, HashPartition, Distinct.

Translation notes
-----------------
* ``lax.sort`` over several keys is lexicographic and stable; here it is
  successive ``torch.sort(stable=True)`` passes from the least significant
  key up (:func:`lex_sort_perm`).
* Unsigned 32-bit values (hashes, ``ordered_u32`` keys) are int64 tensors
  with values in [0, 2**32), which torch sorts and searches as unsigned.
* JAX clamps out-of-range gathers and drops out-of-range scatters; torch
  raises, so indices are clamped (``take_rows``) or scattered into a dump
  slot that is cut off.
* Counts and row counts come back as int32 where the reference's do.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.table import Table, concat_tables, take_rows, where_rows
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import U32 as U32_MAX

# ---------------------------------------------------------------------------
# compaction / select / project
# ---------------------------------------------------------------------------


def stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """Indices of the ``keep`` rows in order, then the others in order:
    ``argsort(~keep, stable=True)``, computed by two prefix sums."""
    k = keep.to(torch.int64)
    n_keep = k.sum()
    dest = torch.where(keep, torch.cumsum(k, 0) - 1,
                       n_keep + torch.cumsum(1 - k, 0) - 1)
    order = torch.empty_like(dest)
    order[dest] = torch.arange(keep.shape[0], device=keep.device)
    return order


def compact(table: Table, keep: torch.Tensor) -> Table:
    """Keep rows where ``keep & valid``, compacted to the front (stable)."""
    keep = keep & table.valid_mask()
    order = stable_partition(keep)
    return table.gather(order, keep.sum(), fill_invalid=False)


def select(table: Table, predicate: Callable[[dict], torch.Tensor]) -> Table:
    """Cylon Select: filter rows by a predicate over the columns dict."""
    return compact(table, predicate(table.columns))


def project(table: Table, columns: Sequence[str]) -> Table:
    """Cylon Project: keep a subset of columns (row count preserved)."""
    return Table({k: table.columns[k] for k in columns}, table.row_count)


def head(table: Table, n: int) -> Table:
    cols = {k: v[:n] for k, v in table.columns.items()}
    return Table(cols, torch.clamp(table.row_count, max=n))


# ---------------------------------------------------------------------------
# sort / merge
# ---------------------------------------------------------------------------


def lex_sort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation over 1-D ``keys`` (most
    significant first): ``lax.sort(..., num_keys=len(keys))`` with an iota
    operand, as successive stable sorts from the least significant key."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def ordered_u32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map to unsigned 32-bit (int64 holder)."""
    if x.dtype == torch.uint32:
        return x.to(torch.int64)
    if x.dtype == torch.int32:
        return x.to(torch.int64) + 0x80000000
    if x.dtype == torch.float32:
        u = x.view(torch.int32).to(torch.int64) & U32_MAX
        flip = torch.where((u >> 31) == 1, U32_MAX, 0x80000000)
        return u ^ flip
    raise TypeError(f"unsupported sort key dtype {x.dtype}")


def sort_permutation(table: Table, by: Sequence[str], *,
                     algorithm: str = "auto") -> torch.Tensor:
    """Permutation sorting valid rows ascending by ``by``, invalid rows last.

    algorithm: 'auto' | 'xla' | 'bitonic'. The bitonic path (single key,
    capacity <= one 2048-pair tile) runs the bitonic kernel; 'auto' picks
    it when it applies. ('xla' keeps the reference's name for the general
    sort.)
    """
    c = table.capacity
    invalid = ~table.valid_mask()
    keys = [table.columns[k] for k in by]
    use_bitonic = algorithm == "bitonic" or (
        algorithm == "auto" and len(keys) == 1 and c <= 2048
        and keys[0].dtype in (torch.int32, torch.uint32, torch.float32))
    if use_bitonic and len(keys) == 1:
        ku = ordered_u32(keys[0])
        # invalid rows -> the u32 max; the (key, iota) tie-break sorts them
        # after valid max-key rows (front compaction gives them larger
        # indices)
        ku = torch.where(invalid, U32_MAX, ku)
        iota = torch.arange(c, dtype=torch.int32, device=table.device)
        _, perm = kops.sort_pairs(ku, iota)
        return perm.to(torch.int64)
    return lex_sort_perm([invalid.to(torch.int32), *keys])


def sort_by(table: Table, by: Sequence[str] | str, *,
            algorithm: str = "auto") -> Table:
    by = [by] if isinstance(by, str) else list(by)
    perm = sort_permutation(table, by, algorithm=algorithm)
    return table.gather(perm, table.row_count, fill_invalid=False)


def merge(a: Table, b: Table, by: Sequence[str] | str) -> Table:
    """Merge two tables sorted by ``by`` into one sorted table (concat +
    sort, as in the reference)."""
    return sort_by(concat_tables(a, b), by)


# ---------------------------------------------------------------------------
# hash partition
# ---------------------------------------------------------------------------


def hash_partition(table: Table, key_columns: Sequence[str],
                   num_partitions: int, *, seed: int = 0):
    """Cylon HashPartition: per-row destination + per-bucket histogram.

    Returns (part_id (capacity,) int32 with -1 on invalid rows,
             histogram (num_partitions,) int32).
    """
    h = kops.hash_columns([table.columns[k] for k in key_columns], seed=seed)
    pid = (h % num_partitions).to(torch.int32)
    pid = torch.where(table.valid_mask(), pid, -1)
    hist = kops.bucket_histogram(pid, num_partitions)
    return pid, hist


# ---------------------------------------------------------------------------
# distinct & set operators (union / intersect / difference)
# ---------------------------------------------------------------------------


def _lex_sorted_with_tags(table: Table, tag: torch.Tensor):
    """Sort rows lexicographically over (invalid, all columns, tag)."""
    names = table.column_names
    invalid = (~table.valid_mask()).to(torch.int32)
    perm = lex_sort_perm([invalid, *[table.columns[k] for k in names], tag])
    sorted_cols = {k: table.columns[k][perm] for k in names}
    return sorted_cols, tag[perm], perm, invalid[perm]


def _rows_equal(cols: dict, j_shift: int) -> torch.Tensor:
    """Row i equals row i+j_shift (element-wise over all columns; wraps)."""
    eq = None
    for v in cols.values():
        e = v == torch.roll(v, -j_shift, 0)
        eq = e if eq is None else (eq & e)
    return eq


def distinct(table: Table) -> Table:
    """Drop duplicate rows (whole-row equality), keep first occurrence."""
    zero_tag = torch.zeros(table.capacity, dtype=torch.int32, device=table.device)
    cols, _, perm, invalid = _lex_sorted_with_tags(table, zero_tag)
    eq_prev = torch.roll(_rows_equal(cols, 1), 1, 0)
    eq_prev[0] = False
    valid = invalid == 0
    keep_sorted = valid & ~(eq_prev & torch.roll(valid, 1, 0))
    keep = torch.zeros(table.capacity, dtype=torch.bool, device=table.device)
    keep[perm] = keep_sorted
    return compact(table, keep)


def _set_op(a: Table, b: Table, keep_rule: str) -> Table:
    """Shared machinery: distinct each side, tag, lex-sort, neighbour tests."""
    if a.schema != b.schema:
        raise ValueError("set ops need identical schemas")
    da, db = distinct(a), distinct(b)
    t = concat_tables(da, db)
    pos = torch.arange(t.capacity, device=t.device)
    tag = ((pos >= da.row_count) & (pos < da.row_count + db.row_count)).to(torch.int32)
    cols, tags, perm, invalid = _lex_sorted_with_tags(t, tag)
    valid = invalid == 0
    eq_next = _rows_equal(cols, 1) & valid & torch.roll(valid, -1, 0)
    eq_next[-1] = False
    eq_prev = torch.roll(eq_next, 1, 0)
    eq_prev[0] = False
    # after per-side distinct an equal run has length <= 2 (one per side),
    # the tag-0 (a) row first because the tag is a sort key
    if keep_rule == "intersect":
        keep_sorted = valid & (tags == 0) & eq_next
    elif keep_rule == "difference_symmetric":
        keep_sorted = valid & ~eq_next & ~eq_prev
    elif keep_rule == "difference_left":
        keep_sorted = valid & (tags == 0) & ~eq_next
    else:
        raise ValueError(keep_rule)
    keep = torch.zeros(t.capacity, dtype=torch.bool, device=t.device)
    keep[perm] = keep_sorted
    return compact(t, keep)


def union(a: Table, b: Table) -> Table:
    """Cylon Union: all rows from both tables, duplicates removed."""
    if a.schema != b.schema:
        raise ValueError("union needs identical schemas")
    return distinct(concat_tables(a, b))


def intersect(a: Table, b: Table) -> Table:
    """Cylon Intersect: rows present in both tables (set semantics)."""
    return _set_op(a, b, "intersect")


def difference(a: Table, b: Table, *, mode: str = "symmetric") -> Table:
    """Cylon Difference (symmetric); mode='left' for SQL EXCEPT."""
    return _set_op(a, b, f"difference_{mode}")


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------


def _sorted_keys(table: Table, key: torch.Tensor):
    """(sorted key with the max sentinel on invalid rows, permutation)."""
    k = torch.where(table.valid_mask(), key,
                    torch.full((), kops.key_max(key.dtype), dtype=key.dtype,
                               device=key.device))
    ks, perm = torch.sort(k, stable=True)  # invalid rows last
    return ks, perm


def join(left: Table, right: Table, on: Sequence[str] | str, *,
         how: str = "inner", algorithm: str = "sort",
         out_capacity: int | None = None, suffix: str = "_r", seed: int = 0,
         with_overflow: bool = False, _hash_fn=None):
    """Cylon Join: all four semantics, both paper algorithms.

    algorithm='sort': exact sort-merge on the raw key (single key column).
    algorithm='hash': murmur3 hash of the key column(s) (the hash32 kernel),
      sort/search on 32-bit hashes, candidates verified on the real keys.

    Output columns: all left columns + right columns (clashes suffixed);
    the unmatched side fills with 0. ``with_overflow`` also returns an int32
    0-d count of result rows the ``out_capacity`` budget cut.
    """
    on = [on] if isinstance(on, str) else list(on)
    if how not in ("inner", "left", "right", "full"):
        raise ValueError(how)

    def _min_cap1(t: Table) -> Table:
        if t.capacity > 0:
            return t
        return Table({k: torch.zeros((1,) + v.shape[1:], dtype=v.dtype,
                                     device=v.device)
                      for k, v in t.columns.items()}, t.row_count)

    left, right = _min_cap1(left), _min_cap1(right)
    dev = left.device
    c_l, c_r = left.capacity, right.capacity
    if out_capacity is None:
        out_capacity = c_l + c_r

    if algorithm == "sort":
        if len(on) != 1:
            raise ValueError("sort join supports a single key column (use hash)")
        key_l, key_r = left.columns[on[0]], right.columns[on[0]]
        if key_l.dtype != key_r.dtype:
            raise TypeError((key_l.dtype, key_r.dtype))
        verify = False
    elif algorithm == "hash":
        hf = _hash_fn or (lambda cols: kops.hash_columns(cols, seed=seed))
        key_l = hf([left.columns[k] for k in on])
        key_r = hf([right.columns[k] for k in on])
        verify = True
    else:
        raise ValueError(algorithm)

    lk, lperm = _sorted_keys(left, key_l)
    rk, rperm = _sorted_keys(right, key_r)
    n_l, n_r = left.row_count, right.row_count

    start = torch.clamp(torch.searchsorted(rk, lk, right=False), max=n_r)
    end = torch.clamp(torch.searchsorted(rk, lk, right=True), max=n_r)
    l_valid = torch.arange(c_l, device=dev) < n_l
    counts = torch.where(l_valid, end - start, 0)

    # primary segment: candidate pair expansion (slot -> (li, ri))
    off = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    t = torch.arange(out_capacity, device=dev)
    li = torch.clamp(torch.searchsorted(off, t, right=True) - 1, 0, c_l - 1)
    j = t - off[li]
    ri = torch.clamp(start[li] + j, 0, c_r - 1)
    slot_valid = t < total

    l_orig = lperm[li]
    r_orig = rperm[ri]

    if verify:
        for k in on:
            slot_valid &= left.columns[k][l_orig] == right.columns[k][r_orig]

    def out_table(l_idx, r_idx, n):
        cols = {}
        l_sel, r_sel = l_idx >= 0, r_idx >= 0
        for k, v in sorted(take_rows(left.columns, l_idx).items()):
            cols[k] = where_rows(l_sel, v)
        for k, v in sorted(take_rows(right.columns, r_idx).items()):
            cols[k + suffix if k in left.columns else k] = where_rows(r_sel, v)
        return Table(cols, torch.as_tensor(n, dtype=torch.int32, device=dev))

    neg = torch.full((), -1, dtype=torch.int64, device=dev)
    primary = compact(
        out_table(torch.where(slot_valid, l_orig, neg),
                  torch.where(slot_valid, r_orig, neg), out_capacity),
        slot_valid)
    segments = [primary]
    # rows the result would hold with unbounded capacity (under the hash
    # algorithm `total` counts collision candidates too: an over-count)
    want_rows = total.to(torch.int32)

    if how in ("left", "full"):
        true_cnt = torch.zeros(c_l, dtype=torch.int32, device=dev)
        true_cnt.index_add_(0, li, slot_valid.to(torch.int32))
        l_unmatched = l_valid & (true_cnt == 0)
        want_rows = want_rows + l_unmatched.sum().to(torch.int32)
        seg = compact(
            out_table(torch.where(l_unmatched, lperm, neg),
                      torch.full((c_l,), -1, dtype=torch.int64, device=dev), c_l),
            l_unmatched)
        segments.append(seg)

    if how in ("right", "full"):
        matched_r = torch.zeros(c_r + 1, dtype=torch.int32, device=dev)
        matched_r.index_add_(0, torch.where(slot_valid, ri, c_r),
                             torch.ones_like(ri, dtype=torch.int32))
        matched_r = matched_r[:c_r]
        r_valid = torch.arange(c_r, device=dev) < n_r
        r_unmatched = r_valid & (matched_r == 0)
        want_rows = want_rows + r_unmatched.sum().to(torch.int32)
        seg = compact(
            out_table(torch.full((c_r,), -1, dtype=torch.int64, device=dev),
                      torch.where(r_unmatched, rperm, neg), c_r),
            r_unmatched)
        segments.append(seg)

    result = segments[0]
    for seg in segments[1:]:
        result = concat_tables(result, seg)
    if result.capacity > out_capacity:  # valid rows are front-compacted
        result = Table({k: v[:out_capacity] for k, v in result.columns.items()},
                       torch.clamp(result.row_count, max=out_capacity))
    if with_overflow:
        overflow = torch.clamp(want_rows - out_capacity, min=0).to(torch.int32)
        return result, overflow
    return result
