"""Concurrent-query serving: a session layer over async plan dispatch (the
port of ``repro.core.serving``).

The paper's pitch is a data-engineering layer embedded in live AI
workloads rather than batch pipelines, which means MANY concurrent clients
issuing small relational queries over shared registered tables; the
metrics that matter are per-query p50/p99 latency and sustained
queries/sec under an open loop, not single-query wall time.

:class:`ServingSession` is that layer:

* **registered tables**: named ``DistTable``s shared by every client
  (``register`` / ``frame``);
* **async submission**: ``submit`` dispatches a ``LazyFrame`` through
  ``DistContext.submit`` and returns the future; the shared plan cache
  means a query shape any client has run before skips straight to
  dispatch (0 misses on the warm path);
* **the open loop**: :meth:`run_open_loop` drives N logical clients
  through a mixed-shape workload either ``sequential`` (submit + resolve
  one at a time) or ``async`` (a bounded in-flight window of futures:
  dispatch of one query overlaps the card's work on earlier ones, and
  their checks fold into later dispatches), and reports per-query latency
  percentiles, queries/sec, and the plan-cache counter deltas.

Results are bit-identical between the two modes, because a future is only
observable through its verified ``result()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.context import DistContext, DistTable, PlanFuture
from repro_torch.core.frame import LazyFrame
from repro_torch.core.table import Table

# one workload entry: (label, make); ``make`` receives the session
# and returns the LazyFrame to run; keyless lambdas inside it stay cached
# because the plan cache content-keys their code + captures
QueryFn = Callable[["ServingSession"], LazyFrame]


@dataclasses.dataclass
class ServingReport:
    """Open-loop measurement: latency distribution + throughput + cache."""

    mode: str                  # "sequential" | "async"
    num_clients: int
    num_queries: int
    elapsed_s: float
    latencies_s: list[float]
    shapes: list[str]          # per-query workload label, submission order
    cache_before: dict
    cache_after: dict
    # (label, repr(error)) per FAILED query, submission order — a failed
    # query resolves exceptionally for its owner but never kills the loop
    errors: list = dataclasses.field(default_factory=list)

    @property
    def qps(self) -> float:
        return self.num_queries / self.elapsed_s if self.elapsed_s > 0 \
            else float("inf")

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.latencies_s), q) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)

    @property
    def compiles(self) -> int:
        """Plans prepared DURING the run (cache-miss delta): 0 on a warm
        cache is the serving gate."""
        return self.cache_after["misses"] - self.cache_before["misses"]

    @property
    def recompiles(self) -> int:
        """Misses on previously-cached-then-evicted keys during the run —
        nonzero means the cache budgets are too small for the working set."""
        return self.cache_after["recompiles"] - self.cache_before["recompiles"]

    @property
    def failed(self) -> int:
        """Queries that resolved exceptionally during the run."""
        return len(self.errors)

    def _delta(self, key: str) -> int:
        # recovery counters appeared after the first report consumers;
        # .get keeps old snapshots (tests, serialized reports) readable
        return int(self.cache_after.get(key, 0)) \
            - int(self.cache_before.get(key, 0))

    @property
    def retries(self) -> int:
        """Recovery-ladder attempts taken during the run: overflow-safe
        recompiles + compile retries + generic retries."""
        return (self._delta("overflow_retries")
                + self._delta("compile_retries")
                + self._delta("generic_retries"))

    @property
    def degraded(self) -> int:
        """Queries that fell back to a degraded run (the kernels' plain
        versions and/or monolithic AllToAll shuffles)."""
        return self._delta("degraded_kernel") + self._delta("degraded_shuffle")

    @property
    def quarantines(self) -> int:
        """Results that failed validation and were re-executed degraded."""
        return self._delta("quarantines")

    def to_dict(self) -> dict:
        return {"mode": self.mode, "clients": self.num_clients,
                "queries": self.num_queries,
                "elapsed_s": self.elapsed_s, "qps": self.qps,
                "p50_ms": self.p50_ms, "p99_ms": self.p99_ms,
                "compiles": self.compiles, "recompiles": self.recompiles,
                "failed": self.failed, "retries": self.retries,
                "degraded": self.degraded, "quarantines": self.quarantines,
                "errors": list(self.errors),
                "cache": dict(self.cache_after)}

    def summary(self) -> str:
        recov = ""
        if self.failed or self.retries or self.degraded or self.quarantines:
            recov = (f", {self.failed} failed / {self.retries} retries / "
                     f"{self.degraded} degraded / "
                     f"{self.quarantines} quarantined")
        return (f"[{self.mode}] {self.num_queries} queries / "
                f"{self.num_clients} clients: {self.qps:.1f} q/s, "
                f"p50 {self.p50_ms:.1f}ms, p99 {self.p99_ms:.1f}ms, "
                f"{self.compiles} compiles ({self.recompiles} recompiles)"
                + recov)


class ServingSession:
    """Named shared tables + async dispatch + the open-loop driver.

    Concurrency contract: the N clients of :meth:`run_open_loop` are
    LOGICAL — one driver thread interleaves their submissions (an open
    loop measures queueing/overlap, not thread parallelism). Calling
    :meth:`submit` / ``future.result()`` from real threads is also safe
    for the shared bookkeeping — the plan cache and the context's
    deferred-verification list are internally locked, and a future
    resolves exactly once — but the catalog (:meth:`register`) must be
    populated before concurrent submission starts, and two racing misses
    on one plan shape may both compile it (the second wins; wasted work,
    never a wrong result).
    """

    def __init__(self, ctx: DistContext, *, max_in_flight: int = 32):
        assert max_in_flight >= 1, max_in_flight
        self.ctx = ctx
        self.max_in_flight = max_in_flight
        self._tables: dict[str, DistTable] = {}

    # -- the catalog ---------------------------------------------------------
    def register(self, name: str, table: Table | DistTable, *,
                 analyze: bool = False) -> DistTable:
        """Register ``table`` under ``name`` (scattering a host Table).
        ``analyze=True`` attaches TableStats so every query over it is
        cost-sized — overflow verification rides the deferred path."""
        if isinstance(table, Table):
            table = self.ctx.scatter(table)
        if analyze:
            table = self.ctx.analyze(table)
        self._tables[name] = table
        return table

    def table(self, name: str) -> DistTable:
        return self._tables[name]

    def table_names(self) -> list[str]:
        return sorted(self._tables)

    def frame(self, name: str) -> LazyFrame:
        """A LazyFrame over the registered table — the query entry point."""
        return self.ctx.frame(self._tables[name])

    # -- submission ----------------------------------------------------------
    def submit(self, query: LazyFrame | QueryFn) -> PlanFuture:
        """Dispatch one query (a LazyFrame, or a function of this session
        that returns one) and return its future immediately."""
        frame = query(self) if callable(query) else query
        return frame.collect_async()

    # -- the open loop -------------------------------------------------------
    def run_open_loop(self, workload: Sequence[tuple[str, QueryFn]], *,
                      num_clients: int = 4, queries_per_client: int = 4,
                      mode: str = "async"
                      ) -> tuple[ServingReport, list[DistTable]]:
        """Drive ``num_clients`` logical clients through the mixed-shape
        ``workload`` (round-robin interleaved, so no two consecutive
        submissions share a shape once clients > 1) and measure per-query
        latency (submit -> verified result materialized) and overall
        queries/sec. Returns the report and the per-query results in
        submission order — the bit-identity anchor between modes.
        """
        assert mode in ("sequential", "async"), mode
        assert len(workload) >= 1
        # submission order: clients interleave, each walking the workload
        # from a different offset — the mixed-shape open loop
        queries = []
        for step in range(queries_per_client):
            for client in range(num_clients):
                label, make = workload[
                    (step + client) % len(workload)]
                queries.append((label, make))

        before = self.ctx.cache_stats()
        results: list[DistTable | None] = [None] * len(queries)
        latencies: list[float] = [0.0] * len(queries)
        errors: list[tuple[str, str]] = []

        def resolve(i: int, t_submit: float, fut: PlanFuture):
            # a query that exhausted its recovery ladder resolves
            # exceptionally; record it and keep serving — one bad query
            # must never kill the session or the other clients' results
            try:
                out = fut.result()
                if out.device.type == "cuda":
                    torch.cuda.synchronize(out.device)
                results[i] = out
            except Exception as e:
                errors.append((queries[i][0], repr(e)))
            latencies[i] = time.perf_counter() - t_submit

        def dispatch(make) -> PlanFuture:
            # plan-level failures already come back as pre-failed futures
            # (DistContext.submit never raises); this guards the query FUNCTION
            try:
                return self.submit(make)
            except Exception as e:
                return PlanFuture.failed(e)

        t0 = time.perf_counter()
        if mode == "sequential":
            for i, (label, make) in enumerate(queries):
                t = time.perf_counter()
                resolve(i, t, dispatch(make))
        else:
            in_flight: list[tuple[int, float, PlanFuture]] = []
            for i, (label, make) in enumerate(queries):
                t = time.perf_counter()
                in_flight.append((i, t, dispatch(make)))
                if len(in_flight) >= self.max_in_flight:
                    resolve(*in_flight.pop(0))
            for item in in_flight:
                resolve(*item)
        elapsed = time.perf_counter() - t0

        report = ServingReport(
            mode=mode, num_clients=num_clients, num_queries=len(queries),
            elapsed_s=elapsed, latencies_s=latencies,
            shapes=[label for label, _ in queries],
            cache_before=before, cache_after=self.ctx.cache_stats(),
            errors=errors)
        return report, results
