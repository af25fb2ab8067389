"""LazyFrame, the lazy relational frame (the port of ``repro.core.frame``).

``ctx.frame(t).select(...).join(...).groupby(...).collect()`` records a
logical plan (``core/plan.py``) instead of running operator by operator.
``collect()`` optimizes the plan (predicate, limit and projection pushdown,
shuffle elision from placement tags, the cost model when an input carries
stats) and submits it through ``DistContext.submit``, the route every eager
operator takes as a one-node plan; ``collect_async()`` returns the future.
``ctx.frame(eager_result)`` picks up the result's placement tag, so a
groupby chained after a join on the same key elides its shuffle.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import plan as PL
from repro_torch.core.context import DistContext, DistTable
from repro_torch.core.table import ColumnSpec, Table


class LazyFrame:
    """A deferred relational expression over one or more DistTables."""

    def __init__(self, ctx: DistContext, plan: PL.Node,
                 inputs: tuple[DistTable, ...]):
        self._ctx = ctx
        self._plan = plan
        self._inputs = tuple(inputs)

    # -- construction ---------------------------------------------------------
    @classmethod
    def scan(cls, ctx: DistContext, table: Table | DistTable) -> "LazyFrame":
        if isinstance(table, Table):
            table = ctx.scatter(table)
        return cls(ctx, PL.Scan(0, partitioning=table.partitioning), (table,))

    def _chain(self, plan: PL.Node) -> "LazyFrame":
        return LazyFrame(self._ctx, plan, self._inputs)

    def _lift(self, other) -> "LazyFrame":
        if isinstance(other, LazyFrame):
            if other._ctx is not self._ctx:
                raise ValueError("frames must share a DistContext")
            return other
        return LazyFrame.scan(self._ctx, other)

    def _merge(self, other: "LazyFrame"):
        """Union the two input lists (dedup by table identity) and remap the
        other plan's Scan slots into the merged numbering."""
        inputs = list(self._inputs)
        mapping = {}
        for i, t in enumerate(other._inputs):
            for j, s in enumerate(inputs):
                if s is t:
                    mapping[i] = j
                    break
            else:
                mapping[i] = len(inputs)
                inputs.append(t)
        return tuple(inputs), PL.remap_scans(other._plan, mapping)

    # -- operators (each returns a new frame) ---------------------------------
    def select(self, predicate: Callable[[dict], torch.Tensor], *, key=None
               ) -> "LazyFrame":
        """Filter rows. ``key``: a hashable name for the predicate that
        covers any values it captures (the plan's canonical key)."""
        return self._chain(PL.Select(self._plan, predicate, key=key))

    def project(self, columns: Sequence[str]) -> "LazyFrame":
        return self._chain(PL.Project(self._plan, tuple(columns)))

    def limit(self, n: int) -> "LazyFrame":
        """True global head(n): the first ``min(n, total)`` rows in shard
        order (the global top-n after :meth:`sort`)."""
        return self._chain(PL.Limit(self._plan, int(n)))

    def partition_by(self, keys, *, seed: int = 7, bucket_capacity=None,
                     stages: int | None = None,
                     shuffle_mode: str = "alltoall") -> "LazyFrame":
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        return self._chain(PL.Repartition(self._plan, keys_t, seed=seed,
                                          bucket_capacity=bucket_capacity,
                                          stages=stages,
                                          shuffle_mode=shuffle_mode))

    def join(self, other, on, *, how: str = "inner", algorithm: str = "sort",
             bucket_capacity=None, out_capacity=None, seed: int = 7,
             stages: int | None = None, shuffle_mode: str = "alltoall"
             ) -> "LazyFrame":
        other = self._lift(other)
        inputs, rplan = self._merge(other)
        on_t = (on,) if isinstance(on, str) else tuple(on)
        node = PL.Join(self._plan, rplan, on_t, how=how, algorithm=algorithm,
                       bucket_capacity=bucket_capacity,
                       out_capacity=out_capacity, seed=seed,
                       stages=stages, shuffle_mode=shuffle_mode)
        return LazyFrame(self._ctx, node, inputs)

    def groupby(self, keys, aggs, *, strategy: str = "auto",
                bucket_capacity=None, partial_capacity=None,
                out_capacity=None, seed: int = 7, stages: int | None = None,
                shuffle_mode: str = "alltoall") -> "LazyFrame":
        """Keyed aggregation. ``strategy='auto'`` leaves the shuffle vs
        two-phase choice to the cost model: with input stats it compares
        ``rows`` with ``shards * key NDV`` and right-sizes the bucket;
        without stats it is ``two_phase``."""
        keys_t = (keys,) if isinstance(keys, str) else tuple(keys)
        node = PL.GroupBy(self._plan, keys_t, A.normalize_aggs(aggs),
                          strategy=strategy, bucket_capacity=bucket_capacity,
                          partial_capacity=partial_capacity,
                          out_capacity=out_capacity, seed=seed,
                          stages=stages, shuffle_mode=shuffle_mode)
        return self._chain(node)

    def sort(self, by, *, bucket_capacity=None, samples_per_shard: int = 64,
             stages: int | None = None, shuffle_mode: str = "alltoall"
             ) -> "LazyFrame":
        """Global sort. The output is range-partitioned on ``by``: a
        downstream sort/groupby on a key prefix elides its shuffle and a
        downstream join range-aligns its other side."""
        by_t = (by,) if isinstance(by, str) else tuple(by)
        return self._chain(PL.Sort(self._plan, by_t,
                                   bucket_capacity=bucket_capacity,
                                   samples_per_shard=samples_per_shard,
                                   stages=stages,
                                   shuffle_mode=shuffle_mode))

    def window(self, by, funcs, *, order_by=(), bucket_capacity=None,
               samples_per_shard: int = 64, stages: int | None = None,
               shuffle_mode: str = "alltoall") -> "LazyFrame":
        """Window functions over (by, order_by)-sorted segments; result
        columns are appended and rows come back in (by, order_by) order. An
        input range-partitioned on a (by + order_by) prefix, such as a
        preceding ``.sort(...)``, elides the range shuffle."""
        by_t = (by,) if isinstance(by, str) else tuple(by)
        order_t = (order_by,) if isinstance(order_by, str) \
            else tuple(order_by)
        return self._chain(PL.Window(self._plan, by_t, order_t,
                                     A.normalize_funcs(funcs),
                                     bucket_capacity=bucket_capacity,
                                     samples_per_shard=samples_per_shard,
                                     stages=stages,
                                     shuffle_mode=shuffle_mode))

    def _set_op(self, cls, other, **kw) -> "LazyFrame":
        other = self._lift(other)
        inputs, rplan = self._merge(other)
        return LazyFrame(self._ctx, cls(self._plan, rplan, **kw), inputs)

    def union(self, other, *, bucket_capacity=None, seed: int = 7,
              stages: int | None = None, shuffle_mode: str = "alltoall"
              ) -> "LazyFrame":
        return self._set_op(PL.Union, other, bucket_capacity=bucket_capacity,
                            seed=seed, stages=stages,
                            shuffle_mode=shuffle_mode)

    def intersect(self, other, *, bucket_capacity=None, seed: int = 7,
                  stages: int | None = None, shuffle_mode: str = "alltoall"
                  ) -> "LazyFrame":
        return self._set_op(PL.Intersect, other,
                            bucket_capacity=bucket_capacity, seed=seed,
                            stages=stages, shuffle_mode=shuffle_mode)

    def difference(self, other, *, mode: str = "symmetric",
                   bucket_capacity=None, seed: int = 7,
                   stages: int | None = None,
                   shuffle_mode: str = "alltoall") -> "LazyFrame":
        return self._set_op(PL.Difference, other,
                            bucket_capacity=bucket_capacity, seed=seed,
                            mode=mode, stages=stages,
                            shuffle_mode=shuffle_mode)

    def distinct(self, *, bucket_capacity=None, seed: int = 7,
                 stages: int | None = None, shuffle_mode: str = "alltoall"
                 ) -> "LazyFrame":
        return self._chain(PL.Distinct(self._plan,
                                       bucket_capacity=bucket_capacity,
                                       seed=seed, stages=stages,
                                       shuffle_mode=shuffle_mode))

    # -- introspection --------------------------------------------------------
    def _schemas(self) -> list[dict]:
        return [t.schema for t in self._inputs]

    def _stats(self) -> list:
        return [t.stats for t in self._inputs]

    @property
    def schema(self) -> dict[str, ColumnSpec]:
        return PL._Analysis(self._schemas()).schema(self._plan)

    def logical_plan(self) -> PL.Node:
        return self._plan

    def optimized(self) -> PL.Node:
        """The plan after every optimizer pass (what collect() runs),
        including the cost model's choices when an input carries stats.
        Under ``REPRO_VERIFY_PLANS`` the verifier checks it (and raises on
        a finding)."""
        return PL.optimize(self._plan, self._schemas(), self._ctx.num_shards,
                           self._stats())

    def explain(self, *, optimize: bool = True, verify: bool = False,
                recovery: bool = False) -> str:
        """The plan tree, one node per line. On the optimized plan every
        potential shuffle is marked ``alltoall``/``elided``; when inputs
        carry stats each node shows its estimated rows and the capacities
        the cost model chose (``bucket=``, ``out=``, ``cost-sized``).

        ``verify=True`` also runs the plan verifier over the (logical,
        optimized) pair and appends its findings (or ``verification:
        clean``): it reports instead of raising, so a broken rewrite can
        be inspected. ``recovery=True`` shows each node's degradation
        rungs (``core/faults.py``)."""
        schemas, stats = self._schemas(), self._stats()
        if not optimize:
            return PL.explain(self._plan, schemas, stats, recovery=recovery)
        # verify=False here: explain renders findings, it does not raise
        plan = PL.optimize(self._plan, schemas, self._ctx.num_shards, stats,
                           verify=False)
        text = PL.explain(plan, schemas, stats, recovery=recovery)
        if verify:
            from repro_torch.core import verify as V

            findings = V.verify_plan(self._plan, plan, schemas,
                                     self._ctx.num_shards, stats)
            text += "\n" + V.format_findings(findings)
        return text

    def plan_report(self) -> list[dict]:
        """Static shuffle accounting of the optimized plan: one record per
        potential AllToAll (elided flag, bucket, bytes a row, dense wire
        bytes, stages), the records ``collect()`` appends to a report.
        Derived from the plan and the inputs' capacities
        (:func:`~repro_torch.core.plan.shuffle_report`): nothing runs and
        the device is not touched."""
        return PL.shuffle_report(self.optimized(), self._schemas(),
                                 [t.local_capacity for t in self._inputs],
                                 self._ctx.num_shards)

    # -- execution ------------------------------------------------------------
    def collect_with_stats(self, *, report: list | None = None):
        """Run the optimized plan; returns (DistTable, per-shuffle stats).
        ``report`` receives the executed shuffles' records."""
        return self._ctx._run_plan(self._plan, self._inputs, optimize=True,
                                   report=report)

    def collect(self) -> DistTable:
        """Optimize and run the whole chain."""
        out, _ = self.collect_with_stats()
        return out

    def collect_async(self):
        """Submit the optimized plan and return a
        :class:`~repro_torch.core.context.PlanFuture` as soon as its work
        is enqueued: the cost-sized overflow check waits for
        ``future.result()`` (or folds into a later dispatch). Clients
        submitting through one context share its plan cache; results equal
        sequential ``collect()`` calls bit for bit."""
        return self._ctx.submit(self._plan, self._inputs, optimize=True)
