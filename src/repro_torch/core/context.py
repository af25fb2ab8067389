"""DistContext and DistTable (the port of ``repro.core.context``).

A :class:`DistTable` is the global view of a sharded table: every column is
one tensor of shape ``(p, C, ...)`` (shard, row, ...) and ``row_counts`` is
``(p,)`` int32; shard i owns rows ``[0, row_counts[i])`` of its slice. The
reference stores the same data flat, ``(p * C, ...)``; :meth:`DistTable.
from_numpy` and :meth:`DistTable.to_numpy` convert between the two. A table
may carry a static placement tag and :class:`~repro_torch.core.stats.
TableStats` (from :meth:`DistContext.analyze`, or propagated to an operator's
output by the cost model's estimators).

:class:`DistContext` holds the virtual mesh (``core/mesh.py``) and the
device. Every operator runs through one path, as in the reference: build a
logical plan (``core/plan.py``) and run it with :meth:`DistContext._run_plan`.
The eager methods are one-node plans (placement tag and cost pass, no
logical rewrites), so without statistics they give exactly the no-stats
defaults: buckets of ``default_bucket_capacity(C, p)``, the sort and window
at slack ``FALLBACK_SLACK * SORT_SLACK_FACTOR``, join outputs of
``JOIN_OUT_FACTOR * p * bucket``, groupby ``"auto"`` -> ``"two_phase"``;
:meth:`DistContext.frame` opens a lazy frame, whose ``collect()`` runs
every optimizer pass. The plan cache, fault ladder, result validation and
async futures are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import plan as PL
from repro_torch.core import stats as S
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.repartition import (Partitioning, RangePartitioning,
                                          fresh_range_fingerprint)
from repro_torch.core.table import KEY_DTYPES, ColumnSpec, Table
from repro_torch.utils import ceil_div, resolve_device


@dataclasses.dataclass(frozen=True)
class DistTable:
    """Sharded table: columns ``(p, C, ...)`` + ``row_counts`` ``(p,)``
    int32, with an optional static placement tag and optional statistics
    (exact after :meth:`DistContext.analyze`, estimated on the output of
    an operator over analyzed inputs)."""

    columns: dict[str, torch.Tensor]
    row_counts: torch.Tensor
    partitioning: Partitioning | RangePartitioning | None = None
    stats: S.TableStats | None = None

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

    @property
    def schema(self) -> dict[str, ColumnSpec]:
        """Per-row schema: name -> ColumnSpec of the trailing shape."""
        return {k: ColumnSpec(tuple(v.shape[2:]), v.dtype)
                for k, v in sorted(self.columns.items())}

    def global_rows(self) -> torch.Tensor:
        return self.row_counts.sum()

    def shard(self, i: int) -> Table:
        """Shard i as a local Table (views, no copy)."""
        return Table({k: v[i] for k, v in self.columns.items()},
                     self.row_counts[i])

    def shards(self) -> list[Table]:
        return [self.shard(i) for i in range(self.num_shards)]

    @classmethod
    def from_shards(cls, tables: Sequence[Table], partitioning=None,
                    stats: S.TableStats | None = None) -> "DistTable":
        """Stack per-shard Tables of equal capacity."""
        caps = {t.capacity for t in tables}
        if len(caps) != 1:
            raise ValueError(f"shards differ in capacity: {caps}")
        cols = {k: torch.stack([t.columns[k] for t in tables])
                for k in tables[0].columns}
        rc = torch.stack([t.row_count for t in tables]).to(torch.int32)
        return cls(cols, rc, partitioning, stats)

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
        # cost-sized plans whose estimates overflowed and were re-run at
        # safe capacities
        self.overflow_retries = 0

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

    # -- statistics (the cost-model input) -----------------------------------
    def analyze(self, t: DistTable) -> DistTable:
        """Exact :class:`~repro_torch.core.stats.TableStats` of ``t``, cached
        on the returned table (the reference's ``DistContext.analyze``).

        Covers the global row count, the exact per-shard max and, for every
        1-D column of a key dtype (int32, uint32, float32; so float32 value
        columns too), its min/max and an NDV sketch. The sketch is one
        launch of the fused hash-partition entry a key column over all
        ``p * C`` slots, the rows past each shard's count then masked out;
        the results come to the host in one transfer. Every plan over the
        returned table is cost-sized. Idempotent: a table that has stats is
        returned as it is.
        """
        if t.stats is not None:
            return t
        names = tuple(k for k, v in sorted(t.columns.items())
                      if v.ndim == 2 and v.dtype in KEY_DTYPES)
        p, c = t.num_shards, t.local_capacity
        valid = (torch.arange(c, device=t.device)[None, :]
                 < t.row_counts[:, None]).reshape(-1)
        flat = {n: t.columns[n].reshape(-1) for n in names}
        sk = S.sketch_columns(flat, valid, names)
        host = torch.cat([t.row_counts.to(torch.float64),
                          sk.reshape(-1)]).cpu().tolist()
        counts = [int(x) for x in host[:p]]
        sketch = [host[p + 3 * i: p + 3 * i + 3] for i in range(len(names))]
        stats = S.finish_stats(names, sketch, sum(counts), max(counts,
                                                                 default=0))
        return dataclasses.replace(t, stats=stats)

    # -- lazy frames -----------------------------------------------------------
    def frame(self, table: Table | DistTable):
        """Open a :class:`~repro_torch.core.frame.LazyFrame` over ``table``.

        Operators chained on the frame defer until ``collect()``, which
        optimizes the whole plan (predicate, limit and projection pushdown,
        shuffle elision from the table's placement tag, the cost model) and
        runs it once.
        """
        from repro_torch.core.frame import LazyFrame

        return LazyFrame.scan(self, table)

    # -- the plan route ---------------------------------------------------------
    def _run_plan(self, plan: PL.Node, tabs: Sequence[DistTable], *,
                  optimize: bool = False, report: list | None = None):
        """Run a plan over ``tabs``: every eager operator (a one-node plan)
        and ``LazyFrame.collect`` come here.

        Eager plans get the output placement and the cost pass only; frames
        get every optimizer pass. When any input carries TableStats the
        cost model sizes capacities from estimates, so the run is checked:
        the overflow of its cost-sized shuffles (``cost_sized_stats_mask``)
        is summed on the host, and if any row was dropped the plan runs once
        more without stats at safe capacities (``safe_capacity=True``),
        counted in :attr:`overflow_retries`. The output carries the
        estimator's stats unless the estimates failed. ``report`` gets the
        first run's records.
        """
        p = self.num_shards
        logical = plan
        schemas = [t.schema for t in tabs]
        input_stats = [t.stats for t in tabs]
        have_stats = any(s is not None for s in input_stats)
        if optimize:
            plan, part = PL.optimize_with_partitioning(
                plan, schemas, p, input_stats=input_stats)
        else:
            part = PL.output_partitioning(plan, schemas, p)
            plan = PL.apply_cost_model(plan, schemas, p, input_stats)
        if isinstance(part, RangePartitioning):
            # a materialized table gets its own provenance token: two runs
            # of one plan over different inputs have different splitters
            part = dataclasses.replace(
                part, fingerprint=fresh_range_fingerprint())
        shards = [t.shards() for t in tabs]
        out, stats = PL.execute_plan(plan, shards, mesh=self.mesh,
                                     report=report)
        bad_estimates = False
        if have_stats and PL.plan_cost_sized(plan):
            mask = PL.cost_sized_stats_mask(plan)
            sized = [s.overflow for s, m in zip(stats, mask) if m]
            if sized and int(torch.stack(sized).sum()) > 0:
                bad_estimates = True
                self.overflow_retries += 1
                del out, stats
                if optimize:
                    safe, _ = PL.optimize_with_partitioning(logical, schemas, p)
                else:
                    safe = PL.apply_cost_model(logical, schemas, p, None)
                out, stats = PL.execute_plan(safe, shards, mesh=self.mesh,
                                             safe_capacity=True)
        est = None
        if have_stats and not bad_estimates:
            est = PL.estimate_output_stats(plan, schemas, input_stats)
        return DistTable.from_shards(out, part, est), stats

    # -- pleasingly parallel operators -----------------------------------------
    def select(self, t: DistTable, predicate: Callable[[dict], torch.Tensor],
               *, key=None, report: list | None = None) -> DistTable:
        """Filter rows by ``predicate``. ``key``: an optional hashable name
        for the predicate (the plan's canonical key)."""
        plan = PL.Select(PL.Scan(0), predicate, key=key)
        out, _ = self._run_plan(plan, [t], report=report)
        return out

    def project(self, t: DistTable, columns: Sequence[str],
                *, report: list | None = None) -> DistTable:
        plan = PL.Project(PL.Scan(0), tuple(columns))
        out, _ = self._run_plan(plan, [t], report=report)
        return out

    def limit(self, t: DistTable, n: int, *, report: list | None = None
              ) -> DistTable:
        """True global head-n: the first ``min(n, total)`` rows in shard
        order (after :meth:`sort`, the global top-n)."""
        plan = PL.Limit(PL.Scan(0), int(n))
        out, _ = self._run_plan(plan, [t], report=report)
        return out

    # -- shuffle-based operators ------------------------------------------------
    def partition_by(self, t: DistTable, keys, *, seed: int = 7,
                     bucket_capacity=None, stages: int | None = None,
                     shuffle_mode: str = "alltoall",
                     report: list | None = None):
        """Hash-repartition ``t`` on ``keys`` and tag the result, so a later
        join or groupby on ``keys`` (same seed) through :meth:`frame`
        elides its shuffle."""
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        plan = PL.Repartition(PL.Scan(0), keys_t, seed=seed,
                              bucket_capacity=bucket_capacity,
                              stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [t], report=report)

    def join(self, left: DistTable, right: DistTable, on, *, how="inner",
             algorithm="sort", bucket_capacity=None, out_capacity=None,
             seed: int = 7, stages: int | None = None,
             shuffle_mode: str = "alltoall", report: list | None = None):
        on_t = (on,) if isinstance(on, str) else tuple(on)
        plan = PL.Join(PL.Scan(0), PL.Scan(1), on_t, how=how,
                       algorithm=algorithm, bucket_capacity=bucket_capacity,
                       out_capacity=out_capacity, seed=seed,
                       stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [left, right], report=report)

    def union(self, a: DistTable, b: DistTable, *, bucket_capacity=None,
              seed: int = 7, stages: int | None = None,
              shuffle_mode: str = "alltoall", report: list | None = None):
        plan = PL.Union(PL.Scan(0), PL.Scan(1),
                        bucket_capacity=bucket_capacity, seed=seed,
                        stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [a, b], report=report)

    def intersect(self, a: DistTable, b: DistTable, *, bucket_capacity=None,
                  seed: int = 7, stages: int | None = None,
                  shuffle_mode: str = "alltoall", report: list | None = None):
        plan = PL.Intersect(PL.Scan(0), PL.Scan(1),
                            bucket_capacity=bucket_capacity, seed=seed,
                            stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [a, b], report=report)

    def difference(self, a: DistTable, b: DistTable, *, mode="symmetric",
                   bucket_capacity=None, seed: int = 7,
                   stages: int | None = None, shuffle_mode: str = "alltoall",
                   report: list | None = None):
        plan = PL.Difference(PL.Scan(0), PL.Scan(1),
                             bucket_capacity=bucket_capacity, seed=seed,
                             mode=mode, stages=stages,
                             shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [a, b], report=report)

    def distinct(self, a: DistTable, *, bucket_capacity=None, seed: int = 7,
                 stages: int | None = None, shuffle_mode: str = "alltoall",
                 report: list | None = None):
        plan = PL.Distinct(PL.Scan(0), bucket_capacity=bucket_capacity,
                           seed=seed, stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [a], report=report)

    def groupby(self, t: DistTable, keys, aggs, *, strategy: str = "auto",
                bucket_capacity=None, partial_capacity: int | None = None,
                out_capacity: int | None = None, seed: int = 7,
                stages: int | None = None, shuffle_mode: str = "alltoall",
                report: list | None = None):
        """Distributed GroupBy (strategy 'auto' | 'two_phase' | 'shuffle').
        'auto' lets the cost model pick from the key-NDV-vs-rows crossover
        when ``t`` carries stats (:meth:`analyze`), which also right-sizes
        the bucket; without stats it is 'two_phase'."""
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        plan = PL.GroupBy(PL.Scan(0), keys_t, A.normalize_aggs(aggs),
                          strategy=strategy, bucket_capacity=bucket_capacity,
                          partial_capacity=partial_capacity,
                          out_capacity=out_capacity, seed=seed,
                          stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [t], report=report)

    def sort(self, a: DistTable, by, *, bucket_capacity=None,
             samples_per_shard: int = 64, stages: int | None = None,
             shuffle_mode: str = "alltoall", report: list | None = None):
        """Global sort by one or more key columns (lexicographic order). The
        result carries a fresh :class:`RangePartitioning` tag: fed back
        through :meth:`frame`, a downstream sort/groupby/join on a key
        prefix elides its shuffle."""
        by_t = (by,) if isinstance(by, str) else tuple(by)
        plan = PL.Sort(PL.Scan(0), by_t, bucket_capacity=bucket_capacity,
                       samples_per_shard=samples_per_shard,
                       stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [a], report=report)

    def window(self, t: DistTable, by, funcs, *, order_by=(),
               bucket_capacity=None, samples_per_shard: int = 64,
               stages: int | None = None, shuffle_mode: str = "alltoall",
               report: list | None = None):
        """Distributed window functions (rank/lag/running aggregates).

        Range-partitions on (by + order_by) like :meth:`sort`, then computes
        every function with per-shard segment scans plus a boundary-carry
        ``all_gather`` for groups spanning shards. An eager call always
        shuffles (its one-node plan gets no elision). The result carries a
        :class:`RangePartitioning` tag on (by + order_by).
        """
        by_t = (by,) if isinstance(by, str) else tuple(by)
        order_t = (order_by,) if isinstance(order_by, str) else tuple(order_by)
        plan = PL.Window(PL.Scan(0), by_t, order_t, A.normalize_funcs(funcs),
                         bucket_capacity=bucket_capacity,
                         samples_per_shard=samples_per_shard,
                         stages=stages, shuffle_mode=shuffle_mode)
        return self._run_plan(plan, [t], report=report)


def _to(t: Table, device: torch.device) -> Table:
    return Table({k: v.to(device) for k, v in t.columns.items()},
                 t.row_count.to(device))
