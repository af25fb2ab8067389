"""Chaos cases: seeded fault injection vs. the recovery ladder (the port of
``repro.testing.chaos_cases``).

``python -m repro_torch.testing.chaos_cases <case> [--rows N] [--device cpu]``
prints one JSON line (``JSON:{...}``) with the reference's keys. Every case
arms one fault class (``repro_torch.core.faults``) on 8 virtual shards and
checks three things against the fault-free run:

* the query still completes, through the documented recovery rung for
  that failure class (plain versions, monolithic AllToAll, safe capacity,
  re-preparation, quarantine + degraded re-execute);
* the recovered result is bit-identical to the fault-free result, row for
  row on the same shards in the same order (data is integer-valued
  float32, so kernel and plain paths agree exactly);
* the recovery counters in ``ctx.cache_stats()`` record what happened.

Each case takes ``rows`` a shard (the reference's 400 by default) and the
``device``. Given ``record`` (a dict), a case also stores under each run's
name that run's rows (valid rows in shard order) and ``cache_stats()``, and
for the open loops every ``ServingReport`` field that is not a time, so a
test can hold them against the reference's. :func:`checks` says what each
case's JSON must show. The fault sites answer as the
port defines them: ``shuffle.chunk`` and ``kernel.dispatch`` only during
the first run of a plan-cache miss, the per-shard kernel seam on every
p-th call (``repro_torch.core.faults.first_run``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

P = 8
ROWS = 400  # rows a shard, as in the reference's cases


def _ctx(device, faults=None, retry=None):
    from repro_torch.core import faults as FLT
    from repro_torch.core.context import DistContext

    return DistContext(num_shards=P, device=device, faults=faults,
                       retry_policy=retry or FLT.RetryPolicy())


def _orders(rows=ROWS, keys=57, seed=11, device="cuda"):
    from repro_torch.core.table import Table

    rng = np.random.default_rng(seed)
    n = rows * P
    return Table.from_numpy({
        "k": rng.integers(0, keys, n).astype(np.int32),
        "d0": rng.integers(-50, 50, n).astype(np.float32),
        "d1": rng.integers(0, 1000, n).astype(np.int32)}, device=device)


def _bucket(rows: int) -> int:
    """The partition bucket: the reference's 1024 at 400 rows a shard, and
    a quarter of a shard's rows (never overflowing over 57 keys) above."""
    return max(1024, 2 * rows // P)


def _rows(dt) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """(per-shard row counts, the valid rows collapsed in shard order, a
    float32 column by its bits). Equal results put the same rows on the
    same shards in the same order, which is stricter than the reference's
    sorted row tuples."""
    d = dt.to_table().to_numpy()
    return (dt.row_counts.cpu().numpy(),
            {k: v.view(np.int32) if v.dtype == np.float32 else v
             for k, v in d.items()})


def _same(a, b) -> bool:
    (rca, ca), (rcb, cb) = a, b
    return bool(np.array_equal(rca, rcb) and sorted(ca) == sorted(cb)
                and all(ca[k].dtype == cb[k].dtype
                        and np.array_equal(ca[k], cb[k]) for k in cb))


def _seen(record, name, ctx, out, **extra):
    if record is not None:
        record[name] = {**extra, "rows": out.to_table().to_numpy(),
                        "stats": ctx.cache_stats()}


def case_shuffle_recovery(rows=ROWS, device="cuda", record=None):
    """shuffle.chunk faults on staged AND ring shuffles: a raised chunk
    degrades to the monolithic AllToAll rung; a garbled chunk is caught
    by result validation and quarantined into a degraded re-execute.
    Either way the result is bit-identical to the fault-free shuffle."""
    from repro_torch.core import faults as FLT

    t = _orders(rows, device=device)
    out = {}
    for mode_name, kw in (("staged", {"stages": 3}),
                          ("ring", {"shuffle_mode": "ring"})):
        ctx0 = _ctx(device)
        ref, _ = ctx0.partition_by(ctx0.scatter(t), "k",
                                   bucket_capacity=_bucket(rows), **kw)
        _seen(record, f"{mode_name}_ref", ctx0, ref)
        ref_rows = _rows(ref)
        for fmode in ("raise", "garble"):
            ctx = _ctx(device, faults=[FLT.FaultPlan(
                "shuffle.chunk", mode=fmode, nth=1)])
            got, _ = ctx.partition_by(ctx.scatter(t), "k",
                                      bucket_capacity=_bucket(rows), **kw)
            _seen(record, f"{mode_name}_{fmode}", ctx, got)
            cs = ctx.cache_stats()
            tag = f"{mode_name}_{fmode}"
            out[f"{tag}_identical"] = _same(_rows(got), ref_rows)
            out[f"{tag}_fires"] = cs["fault_fires"]
            out[f"{tag}_degraded_shuffle"] = cs["degraded_shuffle"]
            out[f"{tag}_quarantines"] = cs["quarantines"]
            out[f"{tag}_failed"] = cs["failed_queries"]
    out["all_identical"] = all(v for k, v in out.items()
                               if k.endswith("_identical"))
    return out


def case_kernel_recovery(rows=ROWS, device="cuda", record=None):
    """kernel.dispatch faults on a distributed GroupBy: a raising kernel
    degrades to the plain-version rung at dispatch; a NaN-poisoned kernel
    output is caught by validation at finalize and quarantined into a
    fully degraded re-execute. Bit-identical both ways (integer-valued
    float32 keeps kernel and plain sums exactly equal)."""
    from repro_torch.core import faults as FLT

    t = _orders(rows, device=device)
    ctx0 = _ctx(device)
    ref, _ = ctx0.groupby(ctx0.scatter(t), "k",
                          (("d0", "sum"), ("d0", "count")))
    _seen(record, "raise_ref", ctx0, ref)
    ref_rows = _rows(ref)
    # nan poison needs a FLOAT kernel output (an int aggregate raises
    # instead), so it gets its own query
    ctx0b = _ctx(device)
    nan_ref, _ = ctx0b.groupby(ctx0b.scatter(t), "k", (("d0", "sum"),))
    _seen(record, "nan_ref", ctx0b, nan_ref)
    nan_ref_rows = _rows(nan_ref)
    out = {}
    for fmode, rung_counter, aggs, want in (
            ("raise", "degraded_kernel",
             (("d0", "sum"), ("d0", "count")), ref_rows),
            ("nan", "quarantines", (("d0", "sum"),), nan_ref_rows)):
        ctx = _ctx(device, faults=[FLT.FaultPlan("kernel.dispatch",
                                                 mode=fmode, nth=1)])
        got, _ = ctx.groupby(ctx.scatter(t), "k", aggs)
        _seen(record, fmode, ctx, got)
        cs = ctx.cache_stats()
        out[f"{fmode}_identical"] = _same(_rows(got), want)
        out[f"{fmode}_fires"] = cs["fault_fires"]
        out[f"{fmode}_rung"] = cs[rung_counter]
        out[f"{fmode}_failed"] = cs["failed_queries"]
    # persistent fault: every kernel dispatch raises, forever; the plain
    # rung must still recover within the bounded ladder
    ctx = _ctx(device, faults=[FLT.FaultPlan("kernel.dispatch",
                                             probability=1.0,
                                             max_fires=10_000)],
               retry=FLT.RetryPolicy(max_attempts=3))
    got, _ = ctx.groupby(ctx.scatter(t), "k",
                         (("d0", "sum"), ("d0", "count")))
    _seen(record, "persistent", ctx, got)
    cs = ctx.cache_stats()
    out["persistent_identical"] = _same(_rows(got), ref_rows)
    out["persistent_degraded"] = cs["degraded_kernel"]
    out["persistent_failed"] = cs["failed_queries"]
    return out


def case_stats_overflow_recovery(rows=ROWS, device="cuda", record=None):
    """stats.estimate fault: the sizing budget is derated 64x under an
    analyzed (cost-sized) plan, forcing real bucket overflow, recovered
    by the safe-capacity rung (overflow_retries), result bit-identical
    to the un-derated run, and the plan key is remembered as bad so the
    SECOND submit goes straight to the safe plan (no second retry)."""
    from repro_torch.core import faults as FLT

    t = _orders(rows, keys=97, device=device)
    ctx0 = _ctx(device)
    ref, _ = ctx0.groupby(ctx0.analyze(ctx0.scatter(t)), "k",
                          (("d0", "sum"),), strategy="shuffle")
    _seen(record, "ref", ctx0, ref)
    ref_rows = _rows(ref)
    ctx = _ctx(device, faults=[FLT.FaultPlan("stats.estimate",
                                             probability=1.0,
                                             max_fires=10_000, factor=64.0)])
    dt = ctx.analyze(ctx.scatter(t))
    got, _ = ctx.groupby(dt, "k", (("d0", "sum"),), strategy="shuffle")
    _seen(record, "first", ctx, got)
    first = ctx.cache_stats()
    got2, _ = ctx.groupby(dt, "k", (("d0", "sum"),), strategy="shuffle")
    _seen(record, "second", ctx, got2)
    second = ctx.cache_stats()
    return {"identical": _same(_rows(got), ref_rows),
            "identical_second": _same(_rows(got2), ref_rows),
            "overflow_retries": first["overflow_retries"],
            "second_submit_retries": second["overflow_retries"]
            - first["overflow_retries"],
            "fires": first["fault_fires"] > 0,
            "failed": second["failed_queries"]}


def case_cache_and_compile(rows=ROWS, device="cuda", record=None):
    """cache.admission + compile faults. A spurious miss/evict recovers
    by a natural re-preparation (results identical, the recompile counter
    records it). A corrupt cached plan raises at dispatch; the ladder
    invalidates the entry and retries with a fresh preparation."""
    from repro_torch.core import faults as FLT

    t = _orders(rows, device=device)
    ctx0 = _ctx(device)
    ref, _ = ctx0.groupby(ctx0.scatter(t), "k", (("d0", "sum"),))
    _seen(record, "ref", ctx0, ref)
    ref_rows = _rows(ref)
    out = {}
    for fmode in ("miss", "evict"):
        ctx = _ctx(device, faults=[FLT.FaultPlan("cache.admission",
                                                 mode=fmode, nth=2)])
        dt = ctx.scatter(t)  # the warm hit is call 2
        a, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
        b, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
        _seen(record, fmode, ctx, b, a=a.to_table().to_numpy())
        cs = ctx.cache_stats()
        out[f"{fmode}_identical"] = _same(_rows(a), ref_rows) \
            and _same(_rows(b), ref_rows)
        out[f"{fmode}_fires"] = cs["fault_fires"]
        out[f"{fmode}_recompiles"] = cs["recompiles"]
        out[f"{fmode}_failed"] = cs["failed_queries"]
    ctx = _ctx(device, faults=[FLT.FaultPlan("compile", nth=1)])
    dt = ctx.scatter(t)
    a, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
    b, _ = ctx.groupby(dt, "k", (("d0", "sum"),))  # fires on the warm hit
    _seen(record, "compile", ctx, b, a=a.to_table().to_numpy())
    cs = ctx.cache_stats()
    out["compile_identical"] = _same(_rows(a), ref_rows) \
        and _same(_rows(b), ref_rows)
    out["compile_retries"] = cs["compile_retries"]
    out["compile_failed"] = cs["failed_queries"]
    return out


def _report_fields(rep) -> dict:
    """Every ServingReport field that is not a time."""
    d = rep.to_dict()
    for k in ("elapsed_s", "qps", "p50_ms", "p99_ms"):
        d.pop(k)
    return {**d, "shapes": list(rep.shapes)}


def case_serving_survival(rows=ROWS, device="cuda", record=None):
    """A ServingSession open loop survives faults injected mid-workload:
    a kernel fault degrades one query to the plain rung, a raising query
    function resolves its future exceptionally, and in BOTH cases every
    other query completes bit-identical to the fault-free loop, the
    session and plan cache stay healthy, and the report surfaces the
    failure/recovery counters."""
    from repro_torch.core import faults as FLT
    from repro_torch.core.serving import ServingSession

    t = _orders(rows, keys=64, device=device)
    workload = [
        ("gb", lambda s: s.frame("orders")
            .groupby("k", (("d0", "sum"), ("d0", "count")))),
        ("sel", lambda s: s.frame("orders")
            .select(lambda c: c["d0"] > 0.0, key=("pos",))
            .groupby("k", (("d0", "sum"),))),
        ("sort", lambda s: s.frame("orders").sort("k").limit(16)),
    ]

    def loop(name, ctx, wl):
        sess = ServingSession(ctx, max_in_flight=4)
        sess.register("orders", t)
        rep, res = sess.run_open_loop(wl, num_clients=3,
                                      queries_per_client=2, mode="async")
        if record is not None:
            record[name] = {
                "report": _report_fields(rep),
                "rows": [None if r is None else r.to_table().to_numpy()
                         for r in res]}
        return rep, res

    ref_rep, ref_res = loop("ref", _ctx(device), workload)

    # kernel fault fires once mid-loop -> one query degrades, all succeed
    rep1, res1 = loop("fault", _ctx(device, faults=[FLT.FaultPlan(
        "kernel.dispatch", probability=1.0, max_fires=1)]), workload)
    identical1 = all(a is not None and _same(_rows(a), _rows(b))
                     for a, b in zip(res1, ref_res))

    # a raising query function -> exactly that query fails, the loop goes on
    def boom(_s):
        raise ValueError("client bug")

    rep2, res2 = loop("boom", _ctx(device), list(workload) + [("boom", boom)])
    ok2 = [r is not None for r in res2]
    return {
        "fault_all_succeeded": identical1,
        "fault_failed": rep1.failed,
        "fault_degraded": rep1.degraded + rep1.quarantines,
        "fault_retries_bounded": rep1.retries + rep1.degraded
        + rep1.quarantines <= rep1.num_queries,
        "boom_failed": rep2.failed,
        "boom_failed_labels": sorted({lbl for lbl, _ in rep2.errors}),
        "boom_succeeded": sum(ok2),
        "boom_queries": rep2.num_queries,
        "ref_failed": ref_rep.failed,
    }


CASES = {k[5:]: v for k, v in list(globals().items())
         if k.startswith("case_")}


def checks(out: dict) -> dict[str, bool]:
    """What each case's JSON must show, by ``"<case>: <condition>"``, for
    every case in ``out`` (case name -> its JSON): what tests/test_chaos.py
    asserts of the reference, and that each shuffle fault and the derated
    estimate fired."""
    got = {}
    if "shuffle_recovery" in out:
        r = out["shuffle_recovery"]
        got["shuffle_recovery: all identical"] = r["all_identical"]
        for t in ("staged", "ring"):
            for f in ("raise", "garble"):
                got[f"shuffle_recovery: {t} {f} fired once"] = \
                    r[f"{t}_{f}_fires"] == 1
                got[f"shuffle_recovery: {t} {f} failed none"] = \
                    r[f"{t}_{f}_failed"] == 0
            got[f"shuffle_recovery: {t} raise degraded the shuffle"] = \
                r[f"{t}_raise_degraded_shuffle"] >= 1
            got[f"shuffle_recovery: {t} garble quarantined"] = \
                r[f"{t}_garble_quarantines"] >= 1
    if "kernel_recovery" in out:
        r = out["kernel_recovery"]
        for f in ("raise", "nan"):
            got[f"kernel_recovery: {f} identical"] = r[f"{f}_identical"]
            got[f"kernel_recovery: {f} took its rung"] = r[f"{f}_rung"] >= 1
        got["kernel_recovery: persistent identical"] = \
            r["persistent_identical"]
        got["kernel_recovery: persistent failed none"] = \
            r["persistent_failed"] == 0
    if "stats_overflow_recovery" in out:
        r = out["stats_overflow_recovery"]
        got["stats_overflow_recovery: both submits identical"] = \
            r["identical"] and r["identical_second"]
        got["stats_overflow_recovery: the estimate fired"] = r["fires"]
        got["stats_overflow_recovery: one overflow retry"] = \
            r["overflow_retries"] == 1
        got["stats_overflow_recovery: no retry on the second submit"] = \
            r["second_submit_retries"] == 0
        got["stats_overflow_recovery: failed none"] = r["failed"] == 0
    if "cache_and_compile" in out:
        r = out["cache_and_compile"]
        for m in ("miss", "evict"):
            got[f"cache_and_compile: {m} identical"] = r[f"{m}_identical"]
            got[f"cache_and_compile: {m} re-prepared"] = \
                r[f"{m}_recompiles"] >= 1
            got[f"cache_and_compile: {m} failed none"] = r[f"{m}_failed"] == 0
        got["cache_and_compile: compile identical"] = r["compile_identical"]
        got["cache_and_compile: compile retried"] = r["compile_retries"] >= 1
        got["cache_and_compile: compile failed none"] = \
            r["compile_failed"] == 0
    if "serving_survival" in out:
        r = out["serving_survival"]
        got["serving_survival: every faulted query identical"] = \
            r["fault_all_succeeded"]
        got["serving_survival: fault failed none"] = r["fault_failed"] == 0
        got["serving_survival: fault degraded a query"] = \
            r["fault_degraded"] >= 1
        got["serving_survival: retries bounded"] = r["fault_retries_bounded"]
        got["serving_survival: only boom failed"] = \
            r["boom_failed"] == 1 and r["boom_failed_labels"] == ["boom"] \
            and r["boom_succeeded"] == r["boom_queries"] - 1
        got["serving_survival: the fault-free loop failed none"] = \
            r["ref_failed"] == 0
    return {k: bool(v) for k, v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = CASES[args.case](rows=args.rows, device=args.device)
    print("JSON:" + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
