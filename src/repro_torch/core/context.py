"""DistContext and DistTable, the eager half of ``repro.core.context``.

A :class:`DistTable` is the global view of a sharded table: every column is
one tensor of shape ``(p, C, ...)`` (shard, row, ...) and ``row_counts`` is
``(p,)`` int32; shard i owns rows ``[0, row_counts[i])`` of its slice. The
reference stores the same data flat, ``(p * C, ...)``; :meth:`DistTable.
from_numpy` and :meth:`DistTable.to_numpy` convert between the two.

:class:`DistContext` holds the virtual mesh (``core/mesh.py``) and the device
and calls the ``ops_dist`` operators directly, with the defaults the
reference's one-node eager plan resolves to when no table statistics exist
(``repro/core/plan.py`` ``execute_plan``): shuffle buckets of
``default_bucket_capacity(C, p)`` (slack 2), sort buckets at slack
``FALLBACK_SLACK * SORT_SLACK_FACTOR``, join buckets the larger of the two
sides' and ``out_capacity = JOIN_OUT_FACTOR * p * bucket``, groupby
``"auto"`` -> ``"two_phase"``, and ``stages=None`` -> ``pick_stages``. So
each call returns the rows and :class:`ShuffleStats` the reference's eager
``ctx.<op>`` returns. The plan IR, plan cache, fault ladder, result
validation and async futures are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import ops_dist as D
from repro_torch.core import ops_local as L
from repro_torch.core import stats as S
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.repartition import (Partitioning, RangePartitioning,
                                          default_bucket_capacity,
                                          fresh_range_fingerprint)
from repro_torch.core.table import Table
from repro_torch.utils import ceil_div, resolve_device


@dataclasses.dataclass(frozen=True)
class DistTable:
    """Sharded table: columns ``(p, C, ...)`` + ``row_counts`` ``(p,)``
    int32, with an optional static placement tag."""

    columns: dict[str, torch.Tensor]
    row_counts: torch.Tensor
    partitioning: Partitioning | RangePartitioning | None = None

    @classmethod
    def from_numpy(cls, columns: dict[str, np.ndarray], row_counts,
                   num_shards: int, device: str | torch.device = "cuda"
                   ) -> "DistTable":
        """From the reference's flat layout: ``(p * C, ...)`` arrays and the
        per-shard counts. The inverse of :meth:`to_numpy`."""
        dev = resolve_device(device)
        p = num_shards
        cols = {}
        for k, v in columns.items():
            a = np.ascontiguousarray(np.asarray(v))
            if a.shape[0] % p:
                raise ValueError(f"column {k!r}: {a.shape[0]} rows do not split "
                                 f"into {p} shards")
            cols[k] = torch.from_numpy(a.reshape((p, a.shape[0] // p) + a.shape[1:])).to(dev)
        rc = torch.as_tensor(np.asarray(row_counts, dtype=np.int32), device=dev)
        return cls(cols, rc)

    def to_numpy(self) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """(flat ``(p * C, ...)`` column arrays, per-shard counts) on the
        host: the reference's DistTable layout."""
        cols = {k: v.reshape((-1,) + tuple(v.shape[2:])).cpu().numpy()
                for k, v in sorted(self.columns.items())}
        return cols, self.row_counts.cpu().numpy()

    @property
    def num_shards(self) -> int:
        return self.row_counts.shape[0]

    @property
    def local_capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def device(self) -> torch.device:
        return self.row_counts.device

    @property
    def column_names(self) -> list[str]:
        return sorted(self.columns)

    def global_rows(self) -> torch.Tensor:
        return self.row_counts.sum()

    def shard(self, i: int) -> Table:
        """Shard i as a local Table (views, no copy)."""
        return Table({k: v[i] for k, v in self.columns.items()},
                     self.row_counts[i])

    def shards(self) -> list[Table]:
        return [self.shard(i) for i in range(self.num_shards)]

    @classmethod
    def from_shards(cls, tables: Sequence[Table], partitioning=None
                    ) -> "DistTable":
        """Stack per-shard Tables of equal capacity."""
        caps = {t.capacity for t in tables}
        if len(caps) != 1:
            raise ValueError(f"shards differ in capacity: {caps}")
        cols = {k: torch.stack([t.columns[k] for t in tables])
                for k in tables[0].columns}
        rc = torch.stack([t.row_count for t in tables]).to(torch.int32)
        return cls(cols, rc, partitioning)

    def to_table(self) -> Table:
        """Collapse to one Table of the valid rows, in shard order."""
        counts = self.row_counts.cpu().tolist()
        cols = {k: torch.cat([v[i, :n] for i, n in enumerate(counts)])
                for k, v in self.columns.items()}
        return Table(cols, torch.tensor(sum(counts), dtype=torch.int32,
                                        device=self.device))


class DistContext:
    """Binds the relational operators to a virtual mesh of ``num_shards``
    shards on ``device`` (``cuda`` unless the caller asks for another)."""

    def __init__(self, num_shards: int = 8,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.mesh = VirtualMesh(num_shards)

    @property
    def num_shards(self) -> int:
        return self.mesh.axis_size

    # -- table placement ----------------------------------------------------
    def scatter(self, table: Table, *, local_capacity: int | None = None
                ) -> DistTable:
        """Block-scatter a Table's valid rows over the shards: shard i gets
        ``n // p`` rows, the first ``n % p`` shards one more."""
        p = self.num_shards
        n = int(table.row_count)
        c = local_capacity or max(1, ceil_div(table.capacity, p))
        counts = np.full((p,), n // p, np.int64)
        counts[: n % p] += 1
        if counts.max() > c:
            raise ValueError(f"local_capacity {c} < {counts.max()} rows")
        offs = np.concatenate([[0], np.cumsum(counts)])
        cols = {}
        for k in table.column_names:
            v = table.columns[k].to(self.device)
            out = torch.zeros((p, c) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=self.device)
            for i in range(p):
                out[i, : counts[i]] = v[offs[i]: offs[i + 1]]
            cols[k] = out
        rc = torch.as_tensor(counts.astype(np.int32), device=self.device)
        return DistTable(cols, rc)

    def from_local_parts(self, parts: Sequence[Table]) -> DistTable:
        """Build a DistTable from one local Table per shard (equal capacity)."""
        if len(parts) != self.num_shards:
            raise ValueError(f"need {self.num_shards} parts, got {len(parts)}")
        return DistTable.from_shards([_to(t, self.device) for t in parts])

    # -- sizing defaults (the no-stats one-node plan) -------------------------
    def _bucket(self, t: DistTable, bucket, slack: float = S.FALLBACK_SLACK):
        if bucket is not None:
            return bucket
        return default_bucket_capacity(t.local_capacity, self.num_shards, slack)

    # -- pleasingly parallel operators -----------------------------------------
    def select(self, t: DistTable, predicate: Callable[[dict], torch.Tensor]
               ) -> DistTable:
        return DistTable.from_shards([L.select(s, predicate) for s in t.shards()])

    def project(self, t: DistTable, columns: Sequence[str]) -> DistTable:
        return DistTable({k: t.columns[k] for k in columns}, t.row_counts)

    def limit(self, t: DistTable, n: int, *, report: list | None = None
              ) -> DistTable:
        out, _ = D.dist_limit(t.shards(), int(n), mesh=self.mesh, report=report)
        return DistTable.from_shards(out)

    # -- shuffle-based operators ------------------------------------------------
    def partition_by(self, t: DistTable, keys, *, seed: int = 7,
                     bucket_capacity=None, stages: int | None = None,
                     shuffle_mode: str = "alltoall",
                     report: list | None = None):
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        out, st = D.dist_repartition_by(
            t.shards(), list(keys_t), mesh=self.mesh,
            bucket_capacity=self._bucket(t, bucket_capacity), seed=seed,
            report=report, stages=stages, shuffle_mode=shuffle_mode)
        return DistTable.from_shards(
            out, Partitioning(keys_t, self.num_shards, seed)), st

    def join(self, left: DistTable, right: DistTable, on, *, how="inner",
             algorithm="sort", bucket_capacity=None, out_capacity=None,
             seed: int = 7, stages: int | None = None,
             shuffle_mode: str = "alltoall", report: list | None = None):
        on_t = (on,) if isinstance(on, str) else tuple(on)
        p = self.num_shards
        cb = bucket_capacity or max(self._bucket(left, None),
                                    self._bucket(right, None))
        if out_capacity is None:
            out_capacity = int(S.JOIN_OUT_FACTOR * p * cb)
        out, st = D.dist_join(
            left.shards(), right.shards(), list(on_t), mesh=self.mesh,
            bucket_capacity=cb, how=how, algorithm=algorithm,
            out_capacity=out_capacity, seed=seed, report=report, stages=stages,
            shuffle_mode=shuffle_mode)
        part = Partitioning(on_t, p, seed) if how in ("inner", "left") else None
        return DistTable.from_shards(out, part), st

    def _set_op(self, fn, a: DistTable, b: DistTable, *, bucket_capacity,
                seed, stages, shuffle_mode, report, **kw):
        cb = bucket_capacity or max(self._bucket(a, None), self._bucket(b, None))
        out, st = fn(a.shards(), b.shards(), mesh=self.mesh, bucket_capacity=cb,
                     seed=seed, report=report, stages=stages,
                     shuffle_mode=shuffle_mode, **kw)
        part = Partitioning(tuple(a.column_names), self.num_shards, seed)
        return DistTable.from_shards(out, part), st

    def union(self, a: DistTable, b: DistTable, *, bucket_capacity=None,
              seed: int = 7, stages: int | None = None,
              shuffle_mode: str = "alltoall", report: list | None = None):
        return self._set_op(D.dist_union, a, b, bucket_capacity=bucket_capacity,
                            seed=seed, stages=stages, shuffle_mode=shuffle_mode,
                            report=report)

    def intersect(self, a: DistTable, b: DistTable, *, bucket_capacity=None,
                  seed: int = 7, stages: int | None = None,
                  shuffle_mode: str = "alltoall", report: list | None = None):
        return self._set_op(D.dist_intersect, a, b,
                            bucket_capacity=bucket_capacity, seed=seed,
                            stages=stages, shuffle_mode=shuffle_mode,
                            report=report)

    def difference(self, a: DistTable, b: DistTable, *, mode="symmetric",
                   bucket_capacity=None, seed: int = 7,
                   stages: int | None = None, shuffle_mode: str = "alltoall",
                   report: list | None = None):
        return self._set_op(D.dist_difference, a, b,
                            bucket_capacity=bucket_capacity, seed=seed,
                            stages=stages, shuffle_mode=shuffle_mode,
                            report=report, mode=mode)

    def distinct(self, a: DistTable, *, bucket_capacity=None, seed: int = 7,
                 stages: int | None = None, shuffle_mode: str = "alltoall",
                 report: list | None = None):
        out, st = D.dist_distinct(
            a.shards(), mesh=self.mesh,
            bucket_capacity=self._bucket(a, bucket_capacity), seed=seed,
            report=report, stages=stages, shuffle_mode=shuffle_mode)
        part = Partitioning(tuple(a.column_names), self.num_shards, seed)
        return DistTable.from_shards(out, part), st

    def groupby(self, t: DistTable, keys, aggs, *, strategy: str = "auto",
                bucket_capacity=None, partial_capacity: int | None = None,
                out_capacity: int | None = None, seed: int = 7,
                stages: int | None = None, shuffle_mode: str = "alltoall",
                report: list | None = None):
        """Distributed GroupBy (strategy 'auto' | 'two_phase' | 'shuffle');
        without statistics 'auto' is 'two_phase', as in the reference."""
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        pairs = A.normalize_aggs(aggs)
        strategy = "two_phase" if strategy == "auto" else strategy
        out, st = D.dist_groupby(
            t.shards(), list(keys_t), pairs, mesh=self.mesh,
            bucket_capacity=self._bucket(t, bucket_capacity),
            strategy=strategy, partial_capacity=partial_capacity,
            out_capacity=out_capacity, seed=seed, report=report, stages=stages,
            shuffle_mode=shuffle_mode)
        return DistTable.from_shards(
            out, Partitioning(keys_t, self.num_shards, seed)), st

    def sort(self, a: DistTable, by, *, bucket_capacity=None,
             samples_per_shard: int = 64, stages: int | None = None,
             shuffle_mode: str = "alltoall", report: list | None = None):
        """Global sort by one or more key columns (lexicographic order)."""
        by_t = (by,) if isinstance(by, str) else tuple(by)
        out, st = D.dist_sort(
            a.shards(), list(by_t), mesh=self.mesh,
            bucket_capacity=self._bucket(
                a, bucket_capacity, S.FALLBACK_SLACK * S.SORT_SLACK_FACTOR),
            samples_per_shard=samples_per_shard, report=report, stages=stages,
            shuffle_mode=shuffle_mode)
        part = RangePartitioning(by_t, self.num_shards, fresh_range_fingerprint())
        return DistTable.from_shards(out, part), st


def _to(t: Table, device: torch.device) -> Table:
    return Table({k: v.to(device) for k, v in t.columns.items()},
                 t.row_count.to(device))
