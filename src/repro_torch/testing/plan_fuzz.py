"""Random-plan correctness fuzzer: verifier-clean + bit-identical to eager
(the port of ``repro.testing.plan_fuzz``).

Generates arbitrary well-typed LazyFrame chains over every plan-node type
(Select/Project/Limit/Repartition/Join/GroupBy/Sort/Window/SetOp/Distinct)
and checks, per plan:

1. the optimizer's output passes every ``repro_torch.core.verify`` rule
   (``REPRO_VERIFY_PLANS`` also makes ``optimize()`` raise on violations);
2. ``canonical_key`` is defined and stable for the optimized plan;
3. the FUSED result (``optimize=True`` — pushdowns, elisions, cost sizing,
   staged shuffles all active) is bit-identical, as a sorted row multiset,
   to the EAGER oracle (the same logical plan with ``optimize=False``).

Bit-identity across different shuffle routes requires numeric discipline,
which the generator enforces by construction: integer columns are exact
(i32 wraps mod 2^32, associatively) and float columns carry an
(integer-valued, |value| bound) tag — order-sensitive float reductions
(sum/mean/var/cumsum/running_mean) are only generated where every
intermediate stays exactly representable in f32 (< 2^24), so any shard
cut or partial-aggregation order yields the same bits. Join partners are
unique-key dimension tables (row counts never grow), every shuffle gets
an explicit overflow-proof bucket unless the cost model is being
exercised (analyzed inputs + cost-sized capacities: a wrong estimate
triggers the safe-capacity retry, never wrong results), and order-
sensitive ops (limit; window/sort determinism) ride a tracked unique key.

Deterministic per (seed, index): the same seed always builds the same
data and the same plans, and the generator draws from
``random.Random(f"{seed}:{i}")`` in exactly the reference's sequence, so a
seed builds the same plans in both packages. CLI (8 virtual shards on the
card; ``--device cpu`` runs the plain versions on the host)::

    PYTHONPATH=src python -m repro_torch.testing.plan_fuzz \
        --plans 200 --seed 20260807 --shards 8
"""
from __future__ import annotations

import os
import random
import sys

F32_EXACT = 1 << 24  # integers exactly representable in float32
MAX_ROWS = 1024      # global row bound the generator never exceeds
BUCKET = 1024        # >= any per-source-shard row count: never overflows
JOIN_OUT = 2048      # >= any per-shard join output under MAX_ROWS

_AGG_OPS = ("sum", "count", "min", "max", "mean", "var")  # no "first":
# first is placement-order-dependent, the one agg eager and fused may
# legitimately disagree on


class _Col:
    """Fuzzer-side column tag: dtype kind plus the float-exactness state
    the generator consults before emitting an order-sensitive reduction.

    ``kind``: "i" (int32) or "f" (float32). ``exact``: every value is an
    integer (always True for "i"). ``bound``: abs-value bound for floats
    (meaningless for ints — i32 wraps associatively, so int reductions
    are bit-deterministic at ANY magnitude)."""

    __slots__ = ("kind", "exact", "bound")

    def __init__(self, kind: str, exact: bool = True, bound: int = 0):
        self.kind, self.exact, self.bound = kind, exact, bound

    def sum_ok(self) -> bool:
        return self.kind == "i" or (self.exact
                                    and self.bound * MAX_ROWS < F32_EXACT)

    def var_ok(self) -> bool:
        return self.kind == "i" or (self.exact
                                    and self.bound * self.bound * MAX_ROWS
                                    < F32_EXACT)


class _Frame:
    """A LazyFrame plus the metadata the generator steers by."""

    def __init__(self, frame, cols: dict, unique: tuple, ordered: bool):
        self.frame = frame
        self.cols = cols          # name -> _Col, in schema order
        self.unique = unique      # column tuple that is a row key
        self.ordered = ordered    # shard-order == a deterministic total
        #                           order (sort/window by a unique suffix)
        self.ops: list[str] = []  # trace for failure reports


def make_inputs(ctx, data_seed: int, *, analyze: bool):
    """Three base DistTables: two fact tables sharing one schema (set-op
    operands) and a unique-key dimension table (join partner — joining a
    unique key never grows row counts, so capacities stay bounded)."""
    import numpy as np

    from repro_torch.core.table import Table

    rng = np.random.default_rng(data_seed)
    p = ctx.num_shards
    rows, kr = max(8, 384 // p), 64

    def fact(seed_off):
        ids = rng.permutation(p * rows).astype(np.int32) + seed_off
        parts = []
        for i in range(p):
            s = slice(i * rows, (i + 1) * rows)
            parts.append(Table.from_numpy({
                "id": ids[s],
                "k": rng.integers(0, kr, rows).astype(np.int32),
                "g": rng.integers(0, 6, rows).astype(np.int32),
                "v": rng.integers(-40, 40, rows).astype(np.int32),
                "w": rng.integers(-25, 25, rows).astype(np.float32),
            }, device=ctx.device))
        return ctx.from_local_parts(parts)

    def dims():
        keys = rng.permutation(kr).astype(np.int32)
        per = kr // p
        parts = []
        for i in range(p):
            ks = keys[i * per:(i + 1) * per]
            parts.append(Table.from_numpy({
                "k": ks,
                "dv": rng.integers(-40, 40, per).astype(np.int32),
                "dw": rng.integers(-25, 25, per).astype(np.float32),
            }, device=ctx.device))
        return ctx.from_local_parts(parts)

    tabs = [fact(0), dims(), fact(10_000)]
    if analyze:
        tabs = [ctx.analyze(t) for t in tabs]
    return tabs


_FACT_COLS = {"id": ("i", 20_000), "k": ("i", 64), "g": ("i", 6),
              "v": ("i", 40), "w": ("f", 25)}
_DIM_COLS = {"k": ("i", 64), "dv": ("i", 40), "dw": ("f", 25)}


def _fresh(cols_spec):
    return {n: _Col(k, True, b) for n, (k, b) in cols_spec.items()}


def random_frame(ctx, inputs, r: random.Random, *, max_ops: int = 6,
                 cost_sized: bool = False) -> _Frame:
    """One random well-typed chain over the base tables. ``cost_sized``
    leaves shuffle capacities to the optimizer's cost model (requires
    analyzed inputs) instead of the explicit overflow-proof buckets."""
    fact, dims, fact2 = inputs
    st = _Frame(ctx.frame(fact), _fresh(_FACT_COLS), ("id",), False)

    def bucket():
        # cost-sized plans may under-estimate; the safe-capacity retry
        # guarantees correctness. Explicit plans can never overflow.
        return None if cost_sized and r.random() < 0.6 else BUCKET

    def op_select():
        name = r.choice(list(st.cols))
        c = st.cols[name]
        if c.kind == "i":
            m, rem = r.randint(2, 5), 0
            rem = r.randrange(m)
            st.frame = st.frame.select(
                lambda t, name=name, m=m, rem=rem: t[name] % m == rem,
                key=("fuzz-mod", name, m, rem))
            st.ops.append(f"select({name}%{m}=={rem})")
        else:
            thr = r.randint(-20, 20)
            st.frame = st.frame.select(
                lambda t, name=name, thr=thr: t[name] > thr + 0.5,
                key=("fuzz-gt", name, thr))
            st.ops.append(f"select({name}>{thr}.5)")

    def op_project():
        keep = [n for n in st.cols
                if n in st.unique or r.random() < 0.6]
        if not keep:
            keep = [next(iter(st.cols))]
        st.frame = st.frame.project(tuple(keep))
        st.cols = {n: st.cols[n] for n in keep}
        if not all(u in keep for u in st.unique):
            st.unique = ()
        st.ops.append(f"project({keep})")

    def op_limit():
        n = r.choice([0, 1, 5, 17, 100, 1000])
        st.frame = st.frame.limit(n)
        st.ops.append(f"limit({n})")

    def op_sort():
        by = [r.choice(list(st.cols))] if r.random() < 0.5 else []
        by += [u for u in st.unique if u not in by]
        st.frame = st.frame.sort(tuple(by), bucket_capacity=bucket())
        st.ordered = True
        st.ops.append(f"sort({by})")

    def op_partition():
        keys = [n for n in st.cols if st.cols[n].kind == "i"]
        keys = r.sample(keys, r.randint(1, min(2, len(keys))))
        kw = {}
        if r.random() < 0.15:
            kw["shuffle_mode"] = "ring"
        else:
            kw["stages"] = r.choice([None, 2, 3])
        st.frame = st.frame.partition_by(tuple(keys),
                                         bucket_capacity=bucket(), **kw)
        st.ordered = False
        st.ops.append(f"partition({keys},{kw})")

    def op_groupby():
        keys = [n for n in ("k", "g") if n in st.cols]
        keys = r.sample(keys, r.randint(1, len(keys)))
        cands = []
        for n, c in st.cols.items():
            if n in keys:
                continue
            for agg in _AGG_OPS:
                if agg in ("sum", "mean") and not c.sum_ok():
                    continue
                if agg == "var" and not c.var_ok():
                    continue
                cands.append((n, agg))
        if not cands:
            # only key columns left: the reference's generator raises here
            # (randint(1, 0); seed 20260807, plan 107); skip the op, as
            # op_window does when it has no function to add
            return
        aggs = r.sample(cands, r.randint(1, min(3, len(cands))))
        st.frame = st.frame.groupby(
            tuple(keys), tuple(aggs),
            strategy=r.choice(["auto", "shuffle", "two_phase"]),
            bucket_capacity=bucket())
        out = {n: st.cols[n] for n in keys}
        for n, agg in aggs:
            c = st.cols[n]
            if agg == "count":
                out[f"{n}_{agg}"] = _Col("i")
            elif agg in ("mean", "var"):
                out[f"{n}_{agg}"] = _Col("f", exact=False)
            elif agg == "sum":
                out[f"{n}_{agg}"] = _Col(c.kind, c.exact,
                                         c.bound * MAX_ROWS)
            else:  # min/max: exact selection
                out[f"{n}_{agg}"] = _Col(c.kind, c.exact, c.bound)
        st.cols, st.unique, st.ordered = out, tuple(keys), False
        st.ops.append(f"groupby({keys},{aggs})")

    def op_window():
        from repro_torch.core.ops_agg import window_output_name

        by = [n for n in ("k", "g") if n in st.cols]
        by = r.sample(by, r.randint(1, len(by)))
        order = [n for n in st.cols
                 if n not in by and r.random() < 0.3][:1]
        order += [u for u in st.unique if u not in by and u not in order]
        cands = [("rank", None, 0), ("dense_rank", None, 0),
                 ("row_number", None, 0)]
        for n, c in st.cols.items():
            off = r.choice([1, 1, 2, 4])
            cands += [("cummax", n, 0), ("lag", n, off), ("lead", n, off)]
            if c.sum_ok():
                cands += [("cumsum", n, 0), ("running_mean", n, 0)]
        picks, out = [], dict(st.cols)
        r.shuffle(cands)
        for fn, coln, off in cands[:r.randint(1, 3)]:
            name = window_output_name(fn, coln, off)
            if name in out:
                continue
            picks.append((fn, coln, off) if coln else fn)
            if coln is None:
                out[name] = _Col("i")
            elif fn == "cumsum":
                c = st.cols[coln]
                out[name] = _Col(c.kind, c.exact, c.bound * MAX_ROWS)
            elif fn == "running_mean":
                out[name] = _Col("f", exact=False)
            else:  # cummax/lag/lead: exact selection
                out[name] = st.cols[coln]
        if not picks:
            return
        st.frame = st.frame.window(tuple(by), tuple(picks),
                                   order_by=tuple(order),
                                   bucket_capacity=bucket())
        # rows come back range-placed + locally sorted on (by + order_by),
        # which ends with the unique key: a deterministic global order
        st.cols, st.ordered = out, True
        st.ops.append(f"window({by},{picks},{order})")

    def op_distinct():
        st.frame = st.frame.distinct(bucket_capacity=bucket())
        st.unique, st.ordered = tuple(st.cols), False
        st.ops.append("distinct")

    def op_join():
        how = "left" if r.random() < 0.25 else "inner"
        st.frame = st.frame.join(
            ctx.frame(dims), "k", how=how,
            algorithm=r.choice(["hash", "sort"]),
            bucket_capacity=BUCKET, out_capacity=JOIN_OUT)
        for n, (kind, b) in _DIM_COLS.items():
            out_n = n + "_r" if n in st.cols else n
            if out_n not in st.cols:
                st.cols[out_n] = _Col(kind, True, b)
        st.ordered = False
        st.ops.append(f"join(dims,{how})")

    def op_setop():
        kind = r.choice(["union", "intersect", "difference"])
        other = ctx.frame(fact2)
        st.frame = getattr(st.frame, kind)(other, bucket_capacity=bucket())
        st.unique, st.ordered = tuple(st.cols), False
        st.ops.append(kind)

    for _ in range(r.randint(2, max_ops)):
        ops = [op_select, op_select, op_project, op_sort, op_partition,
               op_distinct]
        if "k" in st.cols or "g" in st.cols:
            ops += [op_groupby, op_groupby, op_window, op_window]
        if st.ordered:
            ops.append(op_limit)
        if "k" in st.cols and sum(o.startswith("join")
                                  for o in st.ops) < 2:
            ops += [op_join, op_join]
        if tuple(st.cols) == tuple(_FACT_COLS):
            ops.append(op_setop)
        r.choice(ops)()
    return st


def check_frame(ctx, st: _Frame) -> dict:
    """Verifier-clean optimization + bit-identical fused-vs-eager rows.
    Raises AssertionError (with the op trace) on any divergence."""
    from repro_torch.core import plan as PL
    from repro_torch.core import verify as V
    from repro_torch.testing.compare import tables_bitwise_equal

    fr = st.frame
    logical = fr.logical_plan()
    schemas = [t.schema for t in fr._inputs]
    stats = [t.stats for t in fr._inputs]
    optimized = PL.optimize(logical, schemas, ctx.num_shards, stats,
                            verify=False)
    findings = V.verify_plan(logical, optimized, schemas, ctx.num_shards,
                             stats)
    assert not findings, (st.ops, [str(f) for f in findings])
    key = PL.canonical_key(optimized)
    key2 = PL.canonical_key(PL.optimize(logical, schemas, ctx.num_shards,
                                        stats, verify=False))
    assert key == key2, (st.ops, "canonical_key unstable")

    # fused: the full optimizer + cost model + verify-on-optimize path
    fused, fstats = ctx._run_plan(logical, fr._inputs, optimize=True)
    # eager oracle: the logical plan as written, no rewrites
    eager, estats = ctx._run_plan(logical, fr._inputs, optimize=False)
    f_ovf = sum(int(s.overflow.sum()) for s in fstats)
    e_ovf = sum(int(s.overflow.sum()) for s in estats)
    assert e_ovf == 0, (st.ops, "eager overflow — fuzzer sizing bug")
    assert f_ovf == 0, (st.ops, "fused overflow survived the safe retry")
    assert tables_bitwise_equal(fused, eager), (
        st.ops, "fused result != eager oracle")
    return {"ops": list(st.ops), "rows": int(fused.global_rows()),
            "cacheable": key is not None}


def run_fuzz(num_plans: int, seed: int, *, max_ops: int = 6,
             ctx=None, log=None, num_shards: int = 8,
             device="cuda") -> dict:
    """``num_plans`` seeded random plans, each checked by
    :func:`check_frame`. Returns summary counters; raises on the first
    failing plan (the message carries the plan's op trace and index).
    Without ``ctx`` it runs on a fresh ``DistContext(num_shards, device)``."""
    from repro_torch.core.context import DistContext

    if ctx is None:
        ctx = DistContext(num_shards=num_shards, device=device)
    os.environ[
        "REPRO_VERIFY_PLANS"] = "1"  # optimize() must raise on findings
    inputs_plain = make_inputs(ctx, seed, analyze=False)
    inputs_stats = make_inputs(ctx, seed + 1, analyze=True)
    summary = {"plans": 0, "rows": 0, "cacheable": 0, "cost_sized": 0}
    for i in range(num_plans):
        r = random.Random(f"{seed}:{i}")
        cost_sized = r.random() < 0.5
        inputs = inputs_stats if cost_sized else inputs_plain
        st = random_frame(ctx, inputs, r, max_ops=max_ops,
                          cost_sized=cost_sized)
        try:
            res = check_frame(ctx, st)
        except Exception:
            print(f"[plan-fuzz] FAILED at plan {i} "
                  f"(seed={seed}, ops={st.ops})", file=sys.stderr)
            raise
        summary["plans"] += 1
        summary["rows"] += res["rows"]
        summary["cacheable"] += res["cacheable"]
        summary["cost_sized"] += cost_sized
        if log and (i + 1) % 20 == 0:
            log(f"[plan-fuzz] {i + 1}/{num_plans} plans clean "
                f"(last: {'+'.join(st.ops)})")
    from repro_torch.core import verify as V

    summary["verify"] = V.counter_snapshot()
    return summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plans", type=int, default=200)
    ap.add_argument("--seed", type=int, default=20260807)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--max-ops", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    summary = run_fuzz(args.plans, args.seed, max_ops=args.max_ops,
                       log=print, num_shards=args.shards, device=args.device)
    print(f"[plan-fuzz] OK: {summary['plans']} plans "
          f"({summary['cost_sized']} cost-sized, "
          f"{summary['cacheable']} cacheable, "
          f"{summary['rows']} result rows, "
          f"verifier {summary['verify']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
