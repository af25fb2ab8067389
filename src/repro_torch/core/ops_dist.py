"""Distributed relational operators (Cylon Fig. 3): local ops . shuffle.
The port of ``repro.core.ops_dist`` without the window operator.

The reference runs each function as one SPMD body inside ``shard_map``; a
body cannot pause for a collective, so here each function is split at its
collectives: per-shard local work in a Python loop over the shards, one
mesh collective over all shards, then per-shard work again. Shards are
lists of per-shard Tables of equal capacity; shuffle stats are
:class:`ShuffleStats` of ``(p,)`` tensors.

Composition (paper section II-B):
  select/project      : pleasingly parallel, no network
  join                : hash_partition(key) -> AllToAll -> local join
  union/intersect/diff: hash_partition(whole row) -> AllToAll -> local op
  sort (global)       : sample splitters -> range partition -> local sort

Every potential shuffle appends one record to ``report``: bucket, bytes per
row and the dense wire bytes ``p^2 * bucket * row_bytes`` (0 when elided).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import ops_local as L
from repro_torch.core import stats as S
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.repartition import (ShuffleStats, _counts_carrier,
                                          repartition, zero_shuffle_stats)
from repro_torch.core.table import Table

Shards = list[Table]


def _row_pid(table: Table, key_columns: Sequence[str], p: int, seed: int):
    pid, _ = L.hash_partition(table, key_columns, p, seed=seed)
    return pid


def _row_bytes(table: Table) -> int:
    """Bytes per row of the dense wire format (all columns, all payload)."""
    total = 0
    for v in table.columns.values():
        n = 1
        for d in v.shape[1:]:
            n *= d
        total += n * v.element_size()
    return total


def _shuffle(tables: Sequence[Table], keys: Sequence[str], *, mesh: VirtualMesh,
             bucket_capacity: int, seed: int, skip: bool = False,
             report: list | None = None, label: str = "shuffle", pids=None,
             stages: int | None = None,
             shuffle_mode: str = "alltoall") -> tuple[Shards, ShuffleStats]:
    """Hash partition + AllToAll, or the elided identity when ``skip``.
    ``stages=None`` sizes the pipeline from the wire bytes
    (:func:`repro_torch.core.stats.pick_stages`)."""
    p = mesh.axis_size
    rb = _row_bytes(tables[0])
    if stages is None and not skip:
        stages = S.pick_stages(p * p * bucket_capacity * rb, bucket_capacity)
    if report is not None:
        report.append({
            "op": label, "elided": bool(skip), "row_bytes": rb,
            "bucket": 0 if skip else bucket_capacity,
            "wire_bytes": 0 if skip else p * p * bucket_capacity * rb,
            "stages": 0 if skip else stages, "mode": shuffle_mode,
            "columns": len(tables[0].columns),
            "carrier": _counts_carrier(tables[0]) is not None,
        })
    if skip:
        return list(tables), zero_shuffle_stats(p, tables[0].device)
    if pids is None:
        pids = [_row_pid(t, list(keys), p, seed) for t in tables]
    return repartition(tables, pids, mesh=mesh, bucket_capacity=bucket_capacity,
                       stages=stages, shuffle_mode=shuffle_mode)


def dist_repartition_by(tables: Sequence[Table], keys: Sequence[str] | str, *,
                        mesh: VirtualMesh, bucket_capacity: int, seed: int = 7,
                        skip_shuffle: bool = False, report: list | None = None,
                        stages: int | None = None,
                        shuffle_mode: str = "alltoall"):
    """Explicit hash repartition (pre-partition once, elide shuffles later)."""
    keys_l = [keys] if isinstance(keys, str) else list(keys)
    out, st = _shuffle(tables, keys_l, mesh=mesh,
                       bucket_capacity=bucket_capacity, seed=seed,
                       skip=skip_shuffle, report=report, label="repartition",
                       stages=stages, shuffle_mode=shuffle_mode)
    return out, (st,)


def _lex_cascade_pid(splitters: Sequence[torch.Tensor],
                     row_keys: Sequence[torch.Tensor], *,
                     strict: bool) -> torch.Tensor:
    """pid[r] = #{splitter tuples lexicographically < row r} (strict) or <=
    (non-strict), by a comparison cascade over the key columns. Shared by
    the sort's splitter assignment and the join's range alignment."""
    m = splitters[0].shape[0]
    c = row_keys[0].shape[0]
    dev = row_keys[0].device
    lt = torch.zeros((m, c), dtype=torch.bool, device=dev)
    eq = torch.ones((m, c), dtype=torch.bool, device=dev)
    for s, r in zip(splitters, row_keys):
        s2, r2 = s[:, None], r[None, :]
        lt = lt | (eq & (s2 < r2))
        eq = eq & (s2 == r2)
    le = lt if strict else lt | eq
    return le.sum(0).to(torch.int32)


def _lex_max_key_tuple(table: Table, keys: Sequence[str]) -> list[torch.Tensor]:
    """This shard's lexicographically largest valid key tuple in the
    ``ordered_u32`` space (zeros on an empty shard)."""
    invalid = (~table.valid_mask()).to(torch.int32)
    cols_u = [L.ordered_u32(table.columns[k]) for k in keys]
    perm = L.lex_sort_perm([invalid, *cols_u])
    idx = torch.clamp(table.row_count - 1, min=0).to(torch.int64)
    nonempty = table.row_count > 0
    return [torch.where(nonempty, c[perm][idx], 0) for c in cols_u]


def _range_align_pid(tables: Sequence[Table], anchors: Sequence[Table],
                     keys: Sequence[str], *, mesh: VirtualMesh
                     ) -> list[torch.Tensor]:
    """Destinations placing ``tables``' rows where the range-partitioned
    ``anchors`` keep equal keys: boundary i is the running lexicographic
    max of shards 0..i's key tuples (one all_gather of p scalars per key
    column), and a row goes to ``#{boundary < row}``."""
    p = mesh.axis_size
    local_max = [_lex_max_key_tuple(a, keys) for a in anchors]
    gathered = [mesh.all_gather(torch.stack([lm[j] for lm in local_max]))
                for j in range(len(keys))]  # each (p,)

    def lex_gt(a, b):  # tuple a > tuple b
        gt = torch.zeros((), dtype=torch.bool, device=a[0].device)
        eq = torch.ones((), dtype=torch.bool, device=a[0].device)
        for x, y in zip(a, b):
            gt = gt | (eq & (x > y))
            eq = eq & (x == y)
        return gt

    # running lex max over shards; empty shards inherit the previous bound
    carry = tuple(col[0] for col in gathered)
    bounds = [carry]
    for i in range(1, p - 1):
        cand = tuple(col[i] for col in gathered)
        take = lex_gt(cand, carry)
        carry = tuple(torch.where(take, x, y) for x, y in zip(cand, carry))
        bounds.append(carry)
    splitters = [torch.stack([b[j] for b in bounds]) for j in range(len(keys))]
    return [torch.where(t.valid_mask(),
                        _lex_cascade_pid(splitters,
                                         [L.ordered_u32(t.columns[k]) for k in keys],
                                         strict=True), -1)
            for t in tables]


def dist_join(left: Sequence[Table], right: Sequence[Table],
              on: Sequence[str] | str, *, mesh: VirtualMesh,
              bucket_capacity: int, how: str = "inner", algorithm: str = "sort",
              out_capacity: int | None = None, seed: int = 7,
              shuffle_seed: int | None = None, skip_left_shuffle: bool = False,
              skip_right_shuffle: bool = False, align: str | None = None,
              align_keys: Sequence[str] | None = None,
              count_truncation: bool = False, report: list | None = None,
              stages: int | None = None, shuffle_mode: str = "alltoall"):
    """Distributed join = shuffle both sides by key hash, then local join.

    ``align`` names a side range-partitioned on ``align_keys`` that keeps
    its placement while the other side is range-aligned to it.
    ``count_truncation`` folds each local join's ``out_capacity`` cut into
    the right side's overflow.
    """
    on_l = [on] if isinstance(on, str) else list(on)
    ps = seed if shuffle_seed is None else shuffle_seed
    lpid = rpid = None
    if align == "left":
        rpid = _range_align_pid(right, left, list(align_keys), mesh=mesh)
    elif align == "right":
        lpid = _range_align_pid(left, right, list(align_keys), mesh=mesh)
    left2, st_l = _shuffle(left, on_l, mesh=mesh,
                           bucket_capacity=bucket_capacity, seed=ps,
                           skip=skip_left_shuffle, report=report,
                           label="join.left", pids=lpid, stages=stages,
                           shuffle_mode=shuffle_mode)
    right2, st_r = _shuffle(right, on_l, mesh=mesh,
                            bucket_capacity=bucket_capacity, seed=ps,
                            skip=skip_right_shuffle, report=report,
                            label="join.right", pids=rpid, stages=stages,
                            shuffle_mode=shuffle_mode)
    outs, truncs = [], []
    for lt, rt in zip(left2, right2):
        res = L.join(lt, rt, on_l, how=how, algorithm=algorithm,
                     out_capacity=out_capacity, seed=seed + 1,
                     with_overflow=count_truncation)
        if count_truncation:
            res, trunc = res
            truncs.append(trunc)
        outs.append(res)
    if count_truncation:
        st_r = st_r._replace(overflow=st_r.overflow + torch.stack(truncs))
    return outs, (st_l, st_r)


def dist_limit(tables: Sequence[Table], n: int, *, mesh: VirtualMesh,
               report: list | None = None):
    """True global head-n: shard i takes ``clip(n - rows_before_i, 0,
    rows_i)`` of its rows, ``rows_before_i`` from an all_gather of the
    per-shard counts."""
    p = mesh.axis_size
    t0 = tables[0]
    if report is not None:
        report.append({"op": "limit", "elided": True,
                       "row_bytes": _row_bytes(t0), "bucket": 0,
                       "wire_bytes": 0})
    zero = zero_shuffle_stats(p, t0.device)
    if p == 1:
        return [L.head(t0, n)], (zero,)
    counts = mesh.all_gather(torch.stack([t.row_count for t in tables]))
    shard = torch.arange(p, device=t0.device)
    outs = []
    cap = min(n, t0.capacity)
    for idx, t in enumerate(tables):
        before = torch.where(shard < idx, counts, 0).sum()
        quota = torch.minimum(torch.clamp(n - before, min=0), t.row_count)
        cols = {k: v[:cap] for k, v in t.columns.items()}
        outs.append(Table(cols, quota.to(torch.int32)))
    return outs, (zero,)


def _dist_set_op(a: Sequence[Table], b: Sequence[Table], op, *,
                 mesh: VirtualMesh, bucket_capacity: int, seed: int = 7,
                 skip_left_shuffle: bool = False,
                 skip_right_shuffle: bool = False, report: list | None = None,
                 label: str = "set_op", stages: int | None = None,
                 shuffle_mode: str = "alltoall", **kw):
    """Shuffle by whole-row hash so duplicates colocate, then the local op."""
    names = a[0].column_names
    a2, st_a = _shuffle(a, names, mesh=mesh, bucket_capacity=bucket_capacity,
                        seed=seed, skip=skip_left_shuffle, report=report,
                        label=f"{label}.left", stages=stages,
                        shuffle_mode=shuffle_mode)
    b2, st_b = _shuffle(b, names, mesh=mesh, bucket_capacity=bucket_capacity,
                        seed=seed, skip=skip_right_shuffle, report=report,
                        label=f"{label}.right", stages=stages,
                        shuffle_mode=shuffle_mode)
    return [op(x, y, **kw) for x, y in zip(a2, b2)], (st_a, st_b)


def dist_union(a, b, **kw):
    return _dist_set_op(a, b, L.union, label="union", **kw)


def dist_intersect(a, b, **kw):
    return _dist_set_op(a, b, L.intersect, label="intersect", **kw)


def dist_difference(a, b, *, mode: str = "symmetric", **kw):
    return _dist_set_op(a, b, lambda x, y: L.difference(x, y, mode=mode),
                        label="difference", **kw)


def dist_distinct(a: Sequence[Table], *, mesh: VirtualMesh,
                  bucket_capacity: int, seed: int = 7,
                  skip_shuffle: bool = False, report: list | None = None,
                  stages: int | None = None, shuffle_mode: str = "alltoall"):
    a2, st = _shuffle(a, a[0].column_names, mesh=mesh,
                      bucket_capacity=bucket_capacity, seed=seed,
                      skip=skip_shuffle, report=report, label="distinct",
                      stages=stages, shuffle_mode=shuffle_mode)
    return [L.distinct(t) for t in a2], (st,)


def dist_groupby(tables: Sequence[Table], keys: Sequence[str] | str, aggs, *,
                 mesh: VirtualMesh, bucket_capacity: int,
                 strategy: str = "two_phase",
                 partial_capacity: int | None = None,
                 out_capacity: int | None = None, seed: int = 7,
                 shuffle_seed: int | None = None, skip_shuffle: bool = False,
                 report: list | None = None, stages: int | None = None,
                 shuffle_mode: str = "alltoall"):
    """Distributed GroupBy, both strategies of arXiv:2010.14596.

    'shuffle': hash-partition raw rows by key -> AllToAll -> local groupby.
    'two_phase': local partial_groupby -> shuffle the partials -> combine
    and finalize. ``skip_shuffle``: the input is already partitioned on
    ``keys``, so a local groupby is the global result.
    """
    keys_l = [keys] if isinstance(keys, str) else list(keys)
    pairs = A.normalize_aggs(aggs)
    ps = seed if shuffle_seed is None else shuffle_seed
    if skip_shuffle:
        _, st = _shuffle(tables, keys_l, mesh=mesh,
                         bucket_capacity=bucket_capacity, seed=ps, skip=True,
                         report=report, label=f"groupby.{strategy}",
                         stages=stages, shuffle_mode=shuffle_mode)
        return [A.groupby(t, keys_l, pairs, out_capacity=out_capacity)
                for t in tables], (st,)
    if strategy == "shuffle":
        t2, st = _shuffle(tables, keys_l, mesh=mesh,
                          bucket_capacity=bucket_capacity, seed=ps,
                          report=report, label="groupby.shuffle",
                          stages=stages, shuffle_mode=shuffle_mode)
        return [A.groupby(t, keys_l, pairs, out_capacity=out_capacity)
                for t in t2], (st,)
    if strategy == "two_phase":
        part = [A.partial_groupby(t, keys_l, pairs, out_capacity=partial_capacity)
                for t in tables]
        part2, st = _shuffle(part, keys_l, mesh=mesh,
                             bucket_capacity=bucket_capacity, seed=ps,
                             report=report, label="groupby.two_phase",
                             stages=stages, shuffle_mode=shuffle_mode)
        return [A.combine_groupby(t, keys_l, pairs, out_capacity=out_capacity)
                for t in part2], (st,)
    raise ValueError(strategy)


def _lex_splitter_pids(tables: Sequence[Table], by: Sequence[str], *,
                       mesh: VirtualMesh,
                       samples_per_shard: int) -> list[torch.Tensor]:
    """Sampled range partition over one or more key columns: stride samples
    of each shard's ``ordered_u32`` keys (the u32 max where invalid), one
    all_gather per key column, a global lexicographic sort, p-1 splitter
    tuples at even quantiles, and ``pid[r] = #{s : splitter_s <= row_r}``."""
    p = mesh.axis_size
    c = tables[0].capacity
    stride = max(1, c // samples_per_shard)

    row_keys = [[L.ordered_u32(t.columns[k]) for k in by] for t in tables]
    gathered = []
    for j in range(len(by)):
        samples = [torch.where(t.valid_mask(), rk[j], L.U32_MAX)
                   [::stride][:samples_per_shard]
                   for t, rk in zip(tables, row_keys)]
        gathered.append(mesh.all_gather(torch.stack(samples)).reshape(-1))
    perm = L.lex_sort_perm(gathered)
    ordered = [g[perm] for g in gathered]
    n_s = ordered[0].shape[0]
    qs = (torch.arange(1, p, device=ordered[0].device) * n_s) // p
    splitters = [col[qs] for col in ordered]  # each (p-1,)
    return [torch.where(t.valid_mask(),
                        _lex_cascade_pid(splitters, rk, strict=False), -1)
            for t, rk in zip(tables, row_keys)]


def dist_sort(tables: Sequence[Table], by: Sequence[str] | str, *,
              mesh: VirtualMesh, bucket_capacity: int,
              samples_per_shard: int = 64, skip_shuffle: bool = False,
              report: list | None = None, stages: int | None = None,
              shuffle_mode: str = "alltoall"):
    """Global sort: sampled range partition, then a local sort per shard.
    Shard i holds keys <= shard i+1's; each shard is locally sorted."""
    by_l = [by] if isinstance(by, str) else list(by)
    if skip_shuffle:
        _, st = _shuffle(tables, by_l, mesh=mesh,
                         bucket_capacity=bucket_capacity, seed=0, skip=True,
                         report=report, label="sort", stages=stages,
                         shuffle_mode=shuffle_mode)
        return [L.sort_by(t, by_l) for t in tables], (st,)
    pids = _lex_splitter_pids(tables, by_l, mesh=mesh,
                              samples_per_shard=samples_per_shard)
    out, st = _shuffle(tables, by_l, mesh=mesh, bucket_capacity=bucket_capacity,
                       seed=0, pids=pids, report=report, label="sort",
                       stages=stages, shuffle_mode=shuffle_mode)
    return [L.sort_by(t, by_l) for t in out], (st,)
