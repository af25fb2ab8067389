"""Distributed relational operators (Cylon Fig. 3): local ops . shuffle.
The port of ``repro.core.ops_dist``.

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
  window              : range partition on (by + order) -> local sort +
                        segment scans -> boundary-carry all_gather + fold

Every potential shuffle appends one record to ``report``: bucket, bytes per
row and the dense wire bytes ``p^2 * bucket * row_bytes`` (0 when elided).
A shuffle that is not elided runs inside the ``repro_torch.exchange`` span,
the local joins and aggregations inside their own (``core/trace.py``).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import ops_local as L
from repro_torch.core import stats as S
from repro_torch.core import trace
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.repartition import (ShuffleStats, _counts_carrier,
                                          repartition, zero_shuffle_stats)
from repro_torch.core.table import Table
from repro_torch.kernels import ops as kops

Shards = list[Table]


def _row_pid(table: Table, key_columns: Sequence[str], p: int, seed: int):
    # the destinations alone: repartition counts them once per shuffle, so a
    # histogram here (hash_partition's) would be launched and thrown away
    return kops.hash_partition_ids([table.columns[k] for k in key_columns],
                                   table.row_count, p, seed=seed)


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
    ``pids``: the destinations, or a function of no arguments that computes
    them (a range partition), in place of the key hash. ``stages=None``
    sizes the pipeline from the wire bytes
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
    with trace.span("repro_torch.exchange"):
        with trace.span("repro_torch.exchange.partition_ids"):
            if pids is None:
                pids = [_row_pid(t, list(keys), p, seed) for t in tables]
            elif callable(pids):
                pids = pids()
        return repartition(tables, pids, mesh=mesh,
                           bucket_capacity=bucket_capacity, stages=stages,
                           shuffle_mode=shuffle_mode)


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
    with trace.span("repro_torch.join.local"):
        for lt, rt in zip(left2, right2):
            res = L.join(lt, rt, on_l, how=how, algorithm=algorithm,
                         out_capacity=out_capacity, seed=seed + 1,
                         with_overflow=count_truncation)
            if count_truncation:
                res, trunc = res
                truncs.append(trunc)
            trace.count("join.rows_out", res.row_count)
            trace.count("join.slots", res.capacity)
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
        with trace.span("repro_torch.groupby.final"):
            return [A.groupby(t, keys_l, pairs, out_capacity=out_capacity)
                    for t in tables], (st,)
    if strategy == "shuffle":
        t2, st = _shuffle(tables, keys_l, mesh=mesh,
                          bucket_capacity=bucket_capacity, seed=ps,
                          report=report, label="groupby.shuffle",
                          stages=stages, shuffle_mode=shuffle_mode)
        with trace.span("repro_torch.groupby.final"):
            return [A.groupby(t, keys_l, pairs, out_capacity=out_capacity)
                    for t in t2], (st,)
    if strategy == "two_phase":
        with trace.span("repro_torch.groupby.partial"):
            part = [A.partial_groupby(t, keys_l, pairs,
                                      out_capacity=partial_capacity)
                    for t in tables]
        part2, st = _shuffle(part, keys_l, mesh=mesh,
                             bucket_capacity=bucket_capacity, seed=ps,
                             report=report, label="groupby.two_phase",
                             stages=stages, shuffle_mode=shuffle_mode)
        with trace.span("repro_torch.groupby.final"):
            return [A.combine_groupby(t, keys_l, pairs,
                                      out_capacity=out_capacity)
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
    pids = functools.partial(_lex_splitter_pids, tables, by_l, mesh=mesh,
                             samples_per_shard=samples_per_shard)
    out, st = _shuffle(tables, by_l, mesh=mesh, bucket_capacity=bucket_capacity,
                       seed=0, pids=pids, report=report, label="sort",
                       stages=stages, shuffle_mode=shuffle_mode)
    return [L.sort_by(t, by_l) for t in out], (st,)


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _gather_summaries(summaries: Sequence[dict], mesh: VirtualMesh) -> dict:
    """Every shard's summary -> one tree of ``(p, ...)`` leaves, by one
    ``all_gather`` per leaf."""
    return _tree_map(lambda *xs: mesh.all_gather(torch.stack(xs)), *summaries)


def _fold_window_carry(gathered, p: int) -> list[dict]:
    """Left-to-right fold of the all-gathered trailing-group summaries.

    ``gathered`` holds every shard's :func:`ops_agg.window_summary` with a
    leading (p,) axis on each leaf. Walking shards in global sort order,
    the running state describes the trailing group of the prefix processed
    so far; shard i's carry is the state BEFORE shard i is folded in.
    Returns the p carries. Pure 0-d/(K,) tensor math on gathered data: no
    host sync, and the only wire traffic was the p-sized all_gather.
    """
    def at(k):
        return _tree_map(lambda x: x[k], gathered)

    dev = gathered["rows"].device
    eq = A._tuple_eq

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    s0 = at(0)
    state = {
        "has": torch.zeros((), dtype=torch.bool, device=dev),
        "key": _tree_map(torch.zeros_like, s0["last_by"]),
        "last_order": _tree_map(torch.zeros_like, s0["last_order"]),
        "count": zero(), "runs": zero(), "run_eq": zero(),
        "sums": _tree_map(torch.zeros_like, s0["sums"]),
        "maxs": _tree_map(torch.zeros_like, s0["maxs"]),
        "lag": _tree_map(torch.zeros_like, s0["lag"]),
    }
    states = [state]
    for k in range(p - 1):
        sk = at(k)
        nonempty = sk["rows"] > 0
        one_group = eq(sk["first_by"], sk["last_by"], dev)
        cont_group = state["has"] & eq(sk["first_by"], state["key"], dev)
        # the prefix's trailing group extends through shard k only when
        # shard k is entirely ONE group continuing the carried key;
        # otherwise shard k's own trailing group replaces the state
        combine = nonempty & one_group & cont_group
        cont_run = combine & eq(sk["first_order"], state["last_order"], dev)
        run_merge = combine & eq(sk["last_order"], state["last_order"], dev)
        new = {
            "has": state["has"] | nonempty,
            "key": dict(sk["last_by"]),
            "last_order": dict(sk["last_order"]),
            "count": torch.where(combine, state["count"] + sk["count"],
                                 sk["count"]),
            "runs": torch.where(combine, state["runs"] + sk["runs"]
                                - cont_run.to(torch.int32), sk["runs"]),
            "run_eq": torch.where(run_merge, state["run_eq"] + sk["run_eq"],
                                  sk["run_eq"]),
            "sums": {n: torch.where(combine, state["sums"][n] + v, v)
                     for n, v in sk["sums"].items()},
            "maxs": {n: torch.where(combine,
                                    torch.maximum(state["maxs"][n], v), v)
                     for n, v in sk["maxs"].items()},
            "lag": {},
        }
        for col, buf in sk["lag"].items():
            jj = torch.arange(buf.shape[0], dtype=torch.int32, device=dev)
            prev = A._at(state["lag"][col], jj - sk["count"])
            new["lag"][col] = torch.where(combine & (jj >= sk["count"]), prev,
                                          buf)
        # an empty shard leaves the prefix state untouched
        state = _tree_map(lambda n, o: torch.where(nonempty, n, o), new, state)
        states.append(state)
    return states


def _fold_window_lead_carry(gathered, p: int) -> list[dict]:
    """Right-to-left fold of the heading-group summaries (the lead
    counterpart of :func:`_fold_window_carry`): shard i's state describes
    the heading group of shards i+1..p-1."""
    def at(k):
        return _tree_map(lambda x: x[k], gathered)

    dev = gathered["rows"].device
    eq = A._tuple_eq
    s0 = at(0)
    state = {"has": torch.zeros((), dtype=torch.bool, device=dev),
             "key": _tree_map(torch.zeros_like, s0["first_by"]),
             "head_count": torch.zeros((), dtype=torch.int32, device=dev),
             "head": _tree_map(torch.zeros_like, s0["head"])}
    states = [None] * p
    for k in reversed(range(p)):
        states[k] = state
        if k == 0:
            break
        sk = at(k)
        nonempty = sk["rows"] > 0
        one_group = eq(sk["first_by"], sk["last_by"], dev)
        cont = state["has"] & eq(sk["last_by"], state["key"], dev)
        combine = nonempty & one_group & cont
        new = {
            "has": state["has"] | nonempty,
            "key": dict(sk["first_by"]),
            "head_count": torch.where(combine, sk["rows"] + state["head_count"],
                                      sk["head_count"]),
            "head": {},
        }
        for col, buf in sk["head"].items():
            jj = torch.arange(buf.shape[0], dtype=torch.int32, device=dev)
            nxt = A._at(state["head"][col], jj - sk["rows"])
            new["head"][col] = torch.where(combine & (jj >= sk["rows"]), nxt,
                                           buf)
        state = _tree_map(lambda n, o: torch.where(nonempty, n, o), new, state)
    return states


def dist_window(tables: Sequence[Table], by: Sequence[str] | str, funcs, *,
                mesh: VirtualMesh, bucket_capacity: int,
                order_by: Sequence[str] | str = (),
                samples_per_shard: int = 64, skip_shuffle: bool = False,
                use_kernel=None, report: list | None = None,
                stages: int | None = None, shuffle_mode: str = "alltoall"):
    """Distributed window functions: range partition -> local sort ->
    per-shard segment scans + cross-shard boundary carry.

    The input is range-partitioned on (by + order_by) like
    :func:`dist_sort`, so after the local sort every shard holds a
    contiguous slice of the globally sorted frame. ``skip_shuffle`` is for
    an input already range-partitioned on a (by + order_by) prefix.

    Groups that span shard boundaries are stitched exactly: each shard
    publishes its trailing-group state (and heading-group lead values), one
    ``all_gather`` per leaf of 0-d/(K,) tensors, no AllToAll, and a fold
    hands every shard the combined carry of all preceding (resp.
    following) shards. Equal to the single-host ``ops_agg.window`` bit for
    bit on integer-valued columns.
    """
    by_l = [by] if isinstance(by, str) else list(by)
    order_l = [order_by] if isinstance(order_by, str) else list(order_by)
    keys = by_l + order_l
    pairs = A.normalize_funcs(funcs)
    p = mesh.axis_size
    A._window_validate(tables[0], by_l, order_l, pairs)

    pids = functools.partial(_lex_splitter_pids, tables, keys, mesh=mesh,
                             samples_per_shard=samples_per_shard)
    t2, st = _shuffle(tables, keys, mesh=mesh, bucket_capacity=bucket_capacity,
                      seed=0, skip=skip_shuffle, pids=pids, report=report,
                      label="window", stages=stages, shuffle_mode=shuffle_mode)
    sorted_ts = [L.sort_by(L.pad_empty(t), keys) for t in t2]
    states = [A.window_state(t, by_l, order_l) for t in sorted_ts]

    carries = lead_carries = [None] * p
    if p > 1:
        gathered = _gather_summaries(
            [A.window_summary(t, s, by_l, order_l, pairs)
             for t, s in zip(sorted_ts, states)], mesh)
        carries = _fold_window_carry(gathered, p)
        if A.carry_requirements(pairs)[3]:
            lgathered = _gather_summaries(
                [A.window_lead_summary(t, s, by_l, pairs)
                 for t, s in zip(sorted_ts, states)], mesh)
            lead_carries = _fold_window_lead_carry(lgathered, p)

    outs = []
    for t, s, c, lc in zip(sorted_ts, states, carries, lead_carries):
        cols = A.window_sorted(t, s, by_l, order_l, pairs, carry=c,
                               lead_carry=lc, use_kernel=use_kernel)
        outs.append(Table({**t.columns, **cols}, t.row_count))
    return outs, (st,)
