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
logical plan (``core/plan.py``) and submit it (:meth:`DistContext.submit`).
The eager methods are one-node plans (placement tag and cost pass, no
logical rewrites), so without statistics they give exactly the no-stats
defaults: buckets of ``default_bucket_capacity(C, p)``, the sort and window
at slack ``FALLBACK_SLACK * SORT_SLACK_FACTOR``, join outputs of
``JOIN_OUT_FACTOR * p * bucket``, groupby ``"auto"`` -> ``"two_phase"``;
:meth:`DistContext.frame` opens a lazy frame, whose ``collect()`` runs
every optimizer pass.

:meth:`DistContext.submit` is the one execution route: it looks the
prepared plan up in the context's :class:`~repro_torch.core.plan_cache.
PlanCache`, runs it under the recovery ladder of ``core/faults.py`` and
returns a :class:`PlanFuture` whose ``result()`` performs the deferred
checks (the overflow of cost-sized capacities, result validation).
Eager operators and ``LazyFrame.collect`` are ``submit(...).
result_with_stats()``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import faults as FLT
from repro_torch.core import ops_agg as A
from repro_torch.core import plan as PL
from repro_torch.core import stats as S
from repro_torch.core import verify as V
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.repartition import (Partitioning, RangePartitioning,
                                          fresh_range_fingerprint)
from repro_torch.core.table import KEY_DTYPES, ColumnSpec, Table, to_device
from repro_torch.kernels import ops as kops
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


class PlanFuture:
    """Handle to a submitted plan run.

    :meth:`DistContext.submit` returns one as soon as the plan's kernels
    and copies are enqueued on the card. What needs the host is deferred
    to :meth:`result`: the overflow counters of a cost-sized plan stay on
    the device until then, and if a cost-sized capacity did overflow,
    :meth:`result` runs the safe-capacity re-run late, so the table is
    only ever observed verified. A later ``submit`` also resolves this
    future when the card has finished it (:meth:`ready`), folding the
    check into that dispatch.
    """

    def __init__(self, finalize: Callable | None,
                 event: "torch.cuda.Event | None" = None):
        self._finalize = finalize
        self._event = event
        self._out = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()  # resolve-once under concurrent result()

    @classmethod
    def failed(cls, error: BaseException) -> "PlanFuture":
        """A future already resolved exceptionally (dispatch failed before
        anything was enqueued). ``result()`` re-raises."""
        fut = cls(None)
        fut._error = error
        return fut

    @property
    def done(self) -> bool:
        """True once resolved: to a verified result OR exceptionally."""
        return self._out is not None or self._error is not None

    def ready(self) -> bool:
        """Best-effort: would :meth:`result` find the card's work finished
        (the CUDA event recorded after the dispatch has completed)? Always
        True on the CPU, where the work ran when it was submitted.
        Advisory only."""
        if self.done or self._event is None:
            return True
        return bool(self._event.query())

    def result_with_stats(self):
        """Verified ``(DistTable, per-shuffle stats)``: blocks on the
        overflow check (and runs the late safe re-run) the first time.

        A failed finalization resolves the future exceptionally EXACTLY
        once: the error is stored under the lock, the finalize closure
        and the event are dropped (no pinned device buffers, no
        half-finalized retry on a later call), and every later call
        re-raises the same error."""
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._out is None:
                try:
                    self._out = self._finalize()
                except BaseException as e:
                    self._error = e
                    raise
                finally:
                    self._finalize = None
                    self._event = None
        return self._out

    def result(self) -> DistTable:
        """The verified output table (see :meth:`result_with_stats`)."""
        return self.result_with_stats()[0]


#: Recovery counters every context tracks (beside ``overflow_retries``).
#: Surfaced in ``cache_stats()`` and, as before/after deltas, in
#: ``ServingReport``.
_RECOVERY_KEYS = ("degraded_kernel", "degraded_shuffle", "compile_retries",
                  "generic_retries", "quarantines", "failed_queries")


class DistContext:
    """Binds the relational operators to a virtual mesh of ``num_shards``
    shards on ``device`` (``cuda`` unless the caller asks for another).

    plan_cache: the canonical-plan cache (a fresh LRU if None).
    faults: fault injection: a ``FaultRegistry``, a sequence of
        ``FaultPlan``s, or None to arm from the ``REPRO_FAULTS`` env spec
        (inert when that is unset).
    retry_policy: bounds + backoff of the recovery ladder (the default
        never sleeps).
    validate: result validation at ``result()`` time (row-count and
        received-row invariants, a NaN scan). None = on exactly when
        faults are armed or ``REPRO_VALIDATE`` is set, so the fault-free
        path pays no extra host syncs.
    """

    def __init__(self, num_shards: int = 8,
                 device: str | torch.device = "cuda", *,
                 plan_cache: PlanCache | None = None,
                 faults: "FLT.FaultRegistry | Sequence[FLT.FaultPlan] | None"
                 = None,
                 retry_policy: FLT.RetryPolicy | None = None,
                 validate: bool | None = None):
        self.device = resolve_device(device)
        self.mesh = VirtualMesh(num_shards)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        if faults is None:
            faults = FLT.from_env()
        elif not isinstance(faults, FLT.FaultRegistry):
            faults = FLT.FaultRegistry(tuple(faults))
        self.faults = faults if faults is not None else FLT.FaultRegistry()
        self.retry_policy = retry_policy if retry_policy is not None \
            else FLT.RetryPolicy()
        self._validate = validate
        self.recovery = {k: 0 for k in _RECOVERY_KEYS}
        # cost-sized plans whose estimates overflowed and were re-run at
        # safe capacities
        self.overflow_retries = 0
        # run keys of cost-sized plans whose estimates already proved
        # wrong: later submits go straight to the safe plan
        self._overflow_bad: set = set()
        # in-flight futures with deferred checks, weakly held so an
        # abandoned future never pins its tables
        self._pending: list = []
        # guards _pending / _overflow_bad / the counters: submit and
        # result() may be called from several client threads
        self._lock = threading.RLock()

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
        return DistTable.from_shards([to_device(t, self.device) for t in parts])

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

    # -- counters ----------------------------------------------------------------
    def cache_stats(self) -> dict:
        """Plan-cache counters (hits/misses/evictions/recompiles and
        residency), the plan verifier's ``verify_runs``/``verify_findings``
        (process-wide), this context's recovery counters
        (``overflow_retries``, ``degraded_kernel``/``degraded_shuffle``,
        ``compile_retries``, ``generic_retries``, ``quarantines``,
        ``failed_queries``) and the fault registry's
        ``fault_calls``/``fault_fires``."""
        with self._lock:
            rec = dict(self.recovery)
            rec["overflow_retries"] = self.overflow_retries
        return {**self.plan_cache.stats(), **V.counter_snapshot(),
                **self.faults.stats(), **rec}

    def _bump(self, counter: str, n: int = 1):
        with self._lock:
            self.recovery[counter] += n

    # -- result validation (the quarantine gate) -------------------------------
    def _validation_on(self) -> bool:
        """Validation costs host syncs (row counts, a NaN scan), so it is
        opt-in: explicit ``validate=``, the ``REPRO_VALIDATE`` env, or
        whenever faults are armed (a chaos run must see its own poison)."""
        if self._validate is not None:
            return bool(self._validate)
        return self.faults.active or \
            os.environ.get("REPRO_VALIDATE", "") not in ("", "0")

    def _validate_result(self, out: DistTable, stats,
                         tabs: Sequence[DistTable]) -> list[str]:
        """Post-run invariants. Findings quarantine a run that an
        injected fault poisoned (one fully degraded re-run) and fail any
        other. Checks: per-shard row counts within [0,
        capacity]; every shuffle's received-row total bounded by the rows
        the inputs could hold (garbled counts decode to absurd totals); no
        NaN in any valid float cell (kernel or chunk poison). Assumes
        NaN-free user data."""
        problems = []
        c = out.local_capacity
        rc = out.row_counts.cpu().numpy()
        if (rc < 0).any() or (rc > c).any():
            problems.append(f"row_counts outside [0, {c}]: {rc.tolist()}")
        cap_total = sum(t.num_shards * t.local_capacity for t in tabs)
        for i, s in enumerate(stats):
            recv = int(s.received.to(torch.int64).sum())
            if recv < 0 or recv > cap_total:
                problems.append(f"shuffle {i} received {recv} rows; "
                                f"inputs hold at most {cap_total}")
        counts = torch.as_tensor(np.clip(rc, 0, c), device=out.device)
        valid = torch.arange(c, device=out.device)[None, :] < counts[:, None]
        for name, col in sorted(out.columns.items()):
            if not col.is_floating_point():
                continue
            mask = valid.reshape(valid.shape + (1,) * (col.ndim - 2))
            if bool(torch.isnan(torch.where(mask, col, 0)).any()):
                problems.append(f"NaN in column {name!r}")
        return problems

    # -- the plan route ---------------------------------------------------------
    def _run(self, key, plan: PL.Node, tabs: Sequence[DistTable], *,
             safe: bool, report: list | None):
        """Run ``plan`` over ``tabs`` through the plan cache.

        ``key`` (None: never cached) is joined with each input's sorted
        (name, shape, dtype); the cached value is the prepared plan,
        ``plan`` bound to ``execute_plan`` and the mesh, and a miss
        prepares it. The first run of a miss (and every run of an uncached
        plan) opens the fault sites' first-run gate; the prepared plan is
        admitted only after a first run that raised nothing and fired no
        fault. A cache hit consults the ``compile`` site.
        """
        sig = fn = None
        if key is not None:
            sig = (key, tuple(
                tuple(sorted((k, tuple(v.shape), str(v.dtype))
                             for k, v in t.columns.items()))
                for t in tabs))
            fn = self.plan_cache.get(sig)
        cached = fn is not None
        if cached and FLT.check("compile") is not None:
            # injected: the cached plan is corrupt. Drop the entry so the
            # ladder's plain retry prepares it afresh.
            self.plan_cache.invalidate(sig)
            raise FLT.FaultError("compile", "cached plan corrupt")
        if fn is None:
            fn = functools.partial(PL.execute_plan, plan, mesh=self.mesh,
                                   safe_capacity=safe)
        shards = [t.shards() for t in tabs]
        if cached:
            out, stats = fn(shards, report=report)
            return DistTable.from_shards(out), stats
        fires = FLT.thread_fires()
        with FLT.first_run(self.num_shards):
            out, stats = fn(shards, report=report)
        if sig is not None and FLT.thread_fires() == fires:
            self.plan_cache.put(sig, fn)
        return DistTable.from_shards(out), stats

    def submit(self, plan: PL.Node, tabs: Sequence[DistTable], *,
               optimize: bool = False, report: list | None = None
               ) -> PlanFuture:
        """Dispatch a plan and return a :class:`PlanFuture` as soon as its
        work is enqueued: the concurrent-query serving route.

        Eager plans get the output placement and the cost pass only;
        frames (``optimize=True``) get every optimizer pass. The prepared
        plan is cached under its canonical key (``("plan", key)``), or,
        for plans with keyless lambdas, under its content key
        (``PL.identity_key``: ``("plan-id", key)``), so a re-created
        predicate stays cached while a rebound global or changed capture
        misses; a plan that cannot be content-keyed is never cached.
        ``report`` receives the primary run's shuffle records.

        When an input carries TableStats the cost model sizes capacities
        from estimates; the overflow check of those cost-sized shuffles
        (``cost_sized_stats_mask``) is deferred to ``result()``. If any
        row was dropped, ``result()`` runs the plan again without stats at
        safe capacities (``safe_capacity=True``, cached under
        ``plan-safe``), counts it in :attr:`overflow_retries`, and
        remembers the key: a later submit of that plan goes straight to
        the safe plan. A failed-estimate output carries no propagated
        stats.

        Every run goes through the recovery ladder (``core/faults.py``),
        bounded by :attr:`retry_policy`: an injected ``FaultError`` at
        ``kernel.dispatch`` re-runs on the kernels' plain versions
        (``oracle_scope``), at ``shuffle.chunk`` with monolithic
        exchanges, at ``compile`` with a fresh preparation; a result that
        fails validation after a fault was injected into its runs is
        quarantined and re-run once fully degraded; one that fails it
        with no injected fault raises through ``result()``. Degraded plans
        cache under ``plan-degraded``. Any other error (a
        kernel that fails to build or launch, a bad predicate) rides no
        rung. A failure resolves the future exceptionally: a dispatch
        error returns an already-failed future rather than raising, so
        one bad query never stops a serving loop; ``result()`` re-raises
        it.
        """
        try:
            with FLT.scope(self.faults):
                return self._submit_impl(plan, tabs, optimize=optimize,
                                         report=report)
        except Exception as e:
            self._bump("failed_queries")
            return PlanFuture.failed(e)

    def _submit_impl(self, plan: PL.Node, tabs: Sequence[DistTable], *,
                     optimize: bool, report: list | None) -> PlanFuture:
        fires = FLT.thread_fires()
        p = self.num_shards
        logical = plan
        schemas = [t.schema for t in tabs]
        input_stats = [t.stats for t in tabs]
        have_stats = any(s is not None for s in input_stats)
        policy = self.retry_policy
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
        key = PL.canonical_key(plan)
        if key is None:
            ikey = PL.identity_key(plan)
            run_key = ("plan-id", ikey) if ikey is not None else None
        else:
            run_key = ("plan", key)
        sized = have_stats and PL.plan_cost_sized(plan)
        safe_memo: dict = {}  # the safe plan is derived at most once

        def run_variant(safe: bool, degrade: frozenset):
            """One ladder rung: the primary or safe-capacity plan, further
            degraded per ``degrade``."""
            if safe:
                if "plan" not in safe_memo:
                    if optimize:
                        sp, _ = PL.optimize_with_partitioning(
                            logical, schemas, p)
                    else:
                        sp = PL.apply_cost_model(logical, schemas, p, None)
                    safe_memo["plan"] = sp
                v_plan, ns = safe_memo["plan"], "plan-safe"
            else:
                v_plan, ns = plan, "plan"
            if FLT.MONO_SHUFFLE in degrade:
                v_plan = PL.degrade_shuffles(v_plan)
            if not safe and v_plan is plan:  # the primary: run_key
                base = run_key
            elif (v_key := PL.canonical_key(v_plan)) is not None:
                base = (ns, v_key)
            else:
                ik = PL.identity_key(v_plan)
                base = (ns + "-id", ik) if ik is not None else None
            if base is None:
                v_run_key = None
            elif degrade:
                v_run_key = ("plan-degraded", tuple(sorted(degrade))) + base
            else:
                v_run_key = base
            rep = report if not (safe or degrade) else None
            if FLT.ORACLE_KERNEL in degrade:
                with kops.oracle_scope():
                    return self._run(v_run_key, v_plan, tabs, safe=safe,
                                     report=rep)
            return self._run(v_run_key, v_plan, tabs, safe=safe, report=rep)

        injected = 0  # faults fired behind the current result

        def run_with_recovery(safe: bool, degrade: frozenset = frozenset(),
                              since: int | None = None):
            """Walk the ladder: run, classify the failure, degrade the next
            attempt, bounded by the retry policy. Only injected
            ``FaultError``s ride it; every other error propagates. Sets
            ``injected`` to the faults fired on this thread since
            ``since`` (default: the call)."""
            nonlocal injected
            degrade = set(degrade)
            last = None
            before = FLT.thread_fires() if since is None else since
            try:
                for attempt in range(1, max(1, policy.max_attempts) + 1):
                    if attempt > 1:
                        policy.sleep(attempt - 1)
                    try:
                        out, stats = run_variant(safe, frozenset(degrade))
                        return out, stats, frozenset(degrade)
                    except FLT.FaultError as e:
                        last = e
                        rung = FLT.rung_for(e)
                        if rung == FLT.ORACLE_KERNEL:
                            degrade.add(FLT.ORACLE_KERNEL)
                            self._bump("degraded_kernel")
                        elif rung == FLT.MONO_SHUFFLE:
                            degrade.add(FLT.MONO_SHUFFLE)
                            self._bump("degraded_shuffle")
                        elif rung == "recompile":
                            # _run already dropped the corrupt entry; the
                            # plain retry prepares it afresh
                            self._bump("compile_retries")
                        else:
                            self._bump("generic_retries")
                raise RuntimeError(
                    f"plan failed after {policy.max_attempts} attempts "
                    f"(degradations tried: {sorted(degrade)})") from last
            finally:
                injected = FLT.thread_fires() - before

        with self._lock:
            bad_estimates = sized and run_key is not None \
                and run_key in self._overflow_bad
        # this plan's estimates already failed once -> straight to safe;
        # a fault at plan time (a derated estimate) counts behind its result
        out, stats, degraded = run_with_recovery(safe=bad_estimates,
                                                 since=fires)

        def finalize_inner():
            nonlocal out, stats, bad_estimates, degraded
            if sized and not bad_estimates:
                mask = PL.cost_sized_stats_mask(plan)
                if len(mask) != len(stats):  # defensive: never mis-attribute
                    mask = [True] * len(stats)
                dropped = [s.overflow for s, m in zip(stats, mask) if m]
                if dropped and int(torch.stack(dropped).sum()) > 0:
                    # late safe-capacity re-run; the failed run's buffers
                    # are released first
                    bad_estimates = True
                    with self._lock:
                        self.overflow_retries += 1
                        if run_key is not None:
                            self._overflow_bad.add(run_key)
                    out = stats = dropped = None
                    out, stats, degraded = run_with_recovery(
                        safe=True, degrade=degraded)
            if self._validation_on():
                problems = self._validate_result(out, stats, tabs)
                if problems and not injected:
                    # no fault was injected behind this result: the kernels
                    # or the plan wrote it, and no rung may hide that
                    raise RuntimeError("result failed validation: "
                                       + "; ".join(problems))
                if problems:
                    # quarantine: drop the poisoned result, run once more
                    # fully degraded (plain kernels + monolithic shuffles)
                    self._bump("quarantines")
                    out = stats = None
                    out, stats, degraded = run_with_recovery(
                        safe=bad_estimates,
                        degrade=frozenset((FLT.ORACLE_KERNEL,
                                           FLT.MONO_SHUFFLE)))
                    problems = self._validate_result(out, stats, tabs)
                    if problems:
                        raise RuntimeError(
                            "result failed validation after degraded "
                            "re-execution: " + "; ".join(problems))
            est = None
            if have_stats and not bad_estimates:
                est = PL.estimate_output_stats(plan, schemas, input_stats)
            return dataclasses.replace(out, partitioning=part, stats=est), \
                stats

        def finalize():
            try:
                with FLT.scope(self.faults):
                    return finalize_inner()
            except Exception:
                self._bump("failed_queries")
                raise

        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        fut = PlanFuture(finalize, event)
        self._fold_pending(skip=fut)
        # only a cost-sized first run (or validation) has anything to check
        if (sized and not bad_estimates) or self._validation_on():
            with self._lock:
                self._pending.append(weakref.ref(fut))
        return fut

    def _fold_pending(self, skip: PlanFuture | None = None):
        """Resolve earlier futures whose work the card has finished: the
        deferred check folded into this dispatch. Dropped or resolved
        futures fall out of the list; one still in flight stays. The list
        is swapped out under the lock and resolved outside it (resolution
        may itself run a safe re-run)."""
        if not self._pending:  # the common case: nothing deferred
            return
        with self._lock:
            pending, self._pending = self._pending, []
        still = []
        for ref in pending:
            f = ref()
            if f is None or f.done or f is skip:
                continue
            if f.ready():
                try:
                    f.result_with_stats()
                except Exception:
                    # stored on the future for its OWNER to re-raise; a
                    # background fold must not abort an unrelated dispatch
                    pass
            else:
                still.append(ref)
        with self._lock:
            self._pending.extend(still)

    def drain(self, raise_errors: bool = True):
        """Block until every outstanding future is verified. Every future
        is resolved even when some fail; the errors are returned, and the
        first is re-raised unless ``raise_errors=False``."""
        with self._lock:
            pending, self._pending = self._pending, []
        errors = []
        for ref in pending:
            f = ref()
            if f is not None:
                try:
                    f.result_with_stats()
                except Exception as e:
                    errors.append(e)
        if errors and raise_errors:
            raise errors[0]
        return errors

    def _run_plan(self, plan: PL.Node, tabs: Sequence[DistTable], *,
                  optimize: bool = False, report: list | None = None):
        """Synchronous run: :meth:`submit` + immediate verification. Every
        eager operator and ``LazyFrame.collect`` rides this."""
        return self.submit(plan, tabs, optimize=optimize,
                           report=report).result_with_stats()

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
