"""Distributed test cases on virtual shards (the port of the relational and
MoE cases of ``repro.testing.dist_cases``).

``python -m repro_torch.testing.dist_cases <case> [--device cpu]`` prints
one JSON line (``JSON:{...}``) with the reference's keys. The reference
runs each case in a child process with 8 XLA host devices; the port's
shards are virtual, so every case runs in process. Each case checks itself
against its own oracle (a counting, set or one-host oracle, or the eager
run), as the reference's does; :func:`checks` says what each case's JSON
must show.

The MoE cases (``moe_ep``, ``moe_decode_psum``) take the reference's
(2, 4) data x model mesh as two batch halves, each over a ``VirtualMesh(4)``
as the model axis: every shard holds the reference's tokens and capacity.
The other three LM-side cases run on the reference's mesh shapes as
``launch/mesh`` meshes of virtual devices: ``flash_decode_shard`` (the
seq-sharded decode on (2, 4) data x model against the plain decode),
``compress_pod`` (3 int8 error-feedback steps on (2, 2, 2) pod x data x
model against 3 exact ones) and ``elastic_restore`` (a train state saved
under (4, 2), restored under (4, 2), (2, 4) and (8, 1)).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

P = 8


def _ctx(device):
    from repro_torch.core.context import DistContext

    return DistContext(num_shards=P, device=device)


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _ovf(*stats) -> int:
    return sum(int(s.overflow.sum()) for s in stats)


def _table(cols, device, **kw):
    from repro_torch.core.table import Table

    return Table.from_numpy(cols, device=device, **kw)


def case_join_union_sort(device="cuda"):
    from collections import Counter

    from repro_torch.data.synthetic import random_table, zipf_table

    ctx = _ctx(device)
    a = random_table(3000, key_range=300, seed=1, device=device)
    b = zipf_table(3000, key_range=300, seed=2, device=device)
    da = ctx.scatter(a, local_capacity=512)
    db = ctx.scatter(b, local_capacity=512)
    ka, kb = _np(a.columns["k"]), _np(b.columns["k"])

    out = {}
    # join (both algorithms) vs counting oracle
    ca = Counter(ka.tolist())
    cb = Counter(kb.tolist())
    expect = sum(ca[k] * cb.get(k, 0) for k in ca)
    for algo in ("hash", "sort"):
        j, (sl, sr) = ctx.join(da, db, "k", algorithm=algo,
                               bucket_capacity=640)
        out[f"join_{algo}_rows"] = int(j.global_rows())
        out[f"join_{algo}_overflow"] = _ovf(sl, sr)
    out["join_expect"] = int(expect)

    # union vs set oracle
    u, _ = ctx.union(ctx.project(da, ["k"]), ctx.project(db, ["k"]),
                     bucket_capacity=640)
    su = set(ka.tolist()) | set(kb.tolist())
    out["union_rows"] = int(u.global_rows())
    out["union_expect"] = len(su)

    # distributed sort: globally non-decreasing
    s, _ = ctx.sort(da, "k", bucket_capacity=2048)
    ks = s.to_table().to_numpy()["k"].astype(np.int64)
    out["sort_rows"] = len(ks)
    out["sort_ok"] = bool(np.all(np.diff(ks) >= 0)) and len(ks) == 3000
    return out


def case_intersect_difference(device="cuda"):
    ctx = _ctx(device)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 60, 400).astype(np.int32)
    b = rng.integers(30, 90, 400).astype(np.int32)
    da = ctx.scatter(_table({"k": a}, device), local_capacity=128)
    db = ctx.scatter(_table({"k": b}, device), local_capacity=128)
    sa, sb = set(a.tolist()), set(b.tolist())
    i, _ = ctx.intersect(da, db, bucket_capacity=256)
    d, _ = ctx.difference(da, db, bucket_capacity=256)
    got_i = sorted(i.to_table().to_numpy()["k"].tolist())
    got_d = sorted(d.to_table().to_numpy()["k"].tolist())
    return {"intersect_ok": got_i == sorted(sa & sb),
            "difference_ok": got_d == sorted(sa ^ sb)}


def case_groupby(device="cuda"):
    """Both dist_groupby strategies == local groupby on the gathered table,
    and two-phase shuffles strictly fewer rows on low-cardinality keys."""
    from repro_torch.core import ops_agg as A
    from repro_torch.data.synthetic import zipf_table

    ctx = _ctx(device)
    key_range = 48
    parts = [zipf_table(600, key_range=key_range, seed=11, shard=i,
                        device=device) for i in range(ctx.num_shards)]
    dt = ctx.from_local_parts(parts)
    aggs = (("d0", "sum"), ("d0", "count"), ("d0", "min"), ("d0", "max"),
            ("d0", "mean"), ("d0", "var"), ("d0", "first"), ("d1", "sum"))

    # reference: local groupby over the global concatenation in shard order
    cols = {k: np.concatenate([p.to_numpy()[k] for p in parts])
            for k in parts[0].column_names}
    ref_t = A.groupby(_table(cols, device), "k", aggs)
    ref = ref_t.to_numpy()

    out = {"groups_expect": int(ref_t.row_count)}
    received = {}
    for strat, cb in (("shuffle", 1024), ("two_phase", 64)):
        g, (st,) = ctx.groupby(dt, "k", aggs, strategy=strat,
                               bucket_capacity=cb)
        d = g.to_table().to_numpy()
        order = np.argsort(d["k"])
        ok = bool(np.array_equal(d["k"][order], ref["k"]))
        exact = ("d0_count",)
        for name in ref:
            got = d[name][order]
            if name in exact or not np.issubdtype(got.dtype, np.floating):
                ok &= bool(np.array_equal(got, ref[name]))
            else:
                ok &= bool(np.allclose(got, ref[name], atol=1e-4, rtol=1e-4))
        out[f"{strat}_ok"] = ok
        out[f"{strat}_overflow"] = _ovf(st)
        received[strat] = int(st.received.sum())
        out[f"{strat}_received"] = received[strat]
    out["two_phase_fewer_rows"] = received["two_phase"] < received["shuffle"]
    return out


def _int_table(n, kr, seed, device, cols=("d0", "d1")):
    rng = np.random.default_rng(seed)
    d = {"k": rng.integers(0, kr, n).astype(np.int32)}
    for c in cols:
        d[c] = rng.integers(-40, 40, n).astype(np.float32)
    return _table(d, device)


def case_plan_fused(device="cuda"):
    """Fused LazyFrame chain == eager op-by-op on 8 shards, with strictly
    fewer AllToAlls (pushdown + elision), including the co-partitioned
    join fast path."""
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    cap, kr = 600, 2400  # sparse join: no truncation on either path
    orders = ctx.from_local_parts([_int_table(cap, kr, 100 + i, device)
                                   for i in range(p)])
    users = ctx.from_local_parts([_int_table(cap, kr, 200 + i, device)
                                  for i in range(p)])
    dims, _ = ctx.partition_by(ctx.scatter(_table({
        "k": np.arange(kr, dtype=np.int32),
        "dval": (np.arange(kr) % 31).astype(np.float32)}, device)), "k")
    aggs = (("d0", "sum"), ("d0", "mean"), ("d0", "count"), ("d0_r", "max"))
    gb_bucket = 2 * cap  # eager re-shuffles are all self-sends: one bucket

    erep: list = []
    j, (sl, sr) = ctx.join(orders, users, "k", report=erep)
    s = ctx.select(j, lambda c: c["d0"] > 0.0, key="pos", report=erep)
    g, (sg,) = ctx.groupby(s, "k", aggs, strategy="shuffle",
                           bucket_capacity=gb_bucket, report=erep)
    e_out, (s3l, s3r) = ctx.join(g, dims, "k", bucket_capacity=gb_bucket,
                                 report=erep)
    eager_overflow = _ovf(sl, sr, sg, s3l, s3r)

    fused = (ctx.frame(orders).join(ctx.frame(users), "k")
             .select(lambda c: c["d0"] > 0.0, key="pos")
             .groupby("k", aggs, strategy="shuffle",
                      bucket_capacity=gb_bucket)
             .join(ctx.frame(dims), "k", bucket_capacity=gb_bucket))
    frep = fused.plan_report()
    f_out, f_stats = fused.collect_with_stats()
    return {
        "identical": tables_bitwise_equal(e_out, f_out),
        "rows": int(f_out.global_rows()),
        "eager_overflow": eager_overflow,
        "fused_overflow": _ovf(*f_stats),
        "eager_alltoall": sum(not r["elided"] for r in erep),
        "fused_alltoall": sum(not r["elided"] for r in frep),
        "eager_wire": sum(r["wire_bytes"] for r in erep),
        "fused_wire": sum(r["wire_bytes"] for r in frep),
    }


def case_sort_chain(device="cuda"):
    """Range-partition provenance: fused sort->join (sort-merge) keeps the
    sorted side in place and range-aligns the other side (exactly one
    fewer AllToAll than eager, identical row multiset), and the range tag
    survives the join so a chained groupby elides its shuffle too."""
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    cap, kr = 500, 4000  # sparse join: no truncation on either path
    orders = ctx.from_local_parts([_int_table(cap, kr, 300 + i, device,
                                              ("d0",)) for i in range(p)])
    users = ctx.from_local_parts([_int_table(cap, kr, 400 + i, device,
                                             ("d0",)) for i in range(p)])
    bucket = 2 * cap

    erep: list = []
    s_e, (st_s,) = ctx.sort(orders, "k", bucket_capacity=bucket, report=erep)
    e_out, (sl, sr) = ctx.join(s_e, users, "k", algorithm="sort",
                               bucket_capacity=bucket, report=erep)
    fused = (ctx.frame(orders).sort("k", bucket_capacity=bucket)
             .join(ctx.frame(users), "k", algorithm="sort",
                   bucket_capacity=bucket))
    frep = fused.plan_report()
    f_out, f_stats = fused.collect_with_stats()
    out = {
        "identical": tables_bitwise_equal(e_out, f_out),
        "rows": int(f_out.global_rows()),
        "eager_overflow": _ovf(st_s, sl, sr),
        "fused_overflow": _ovf(*f_stats),
        "eager_alltoall": sum(not r["elided"] for r in erep),
        "fused_alltoall": sum(not r["elided"] for r in frep),
    }

    # eager provenance: ctx.sort's RangePartitioning tag rides the frame()
    # boundary, so the downstream groupby elides its shuffle entirely
    gb = ctx.frame(s_e).groupby("k", (("d0", "sum"), ("d0", "count")))
    gb_rep = gb.plan_report()
    g_f = gb.collect()
    g_e, _ = ctx.groupby(s_e, "k", (("d0", "sum"), ("d0", "count")))
    out["groupby_elided"] = all(r["elided"] for r in gb_rep)
    out["groupby_identical"] = tables_bitwise_equal(g_e, g_f)
    return out


def case_sort_align_skew(device="cuda"):
    """The range-align join must survive probe-side key skew with DEFAULT
    bucket sizing: every probe row here targets a single anchor range."""
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    rng = np.random.default_rng(23)
    anchor = ctx.from_local_parts([_table({
        "k": rng.integers(0, 1_000_000, 400).astype(np.int32),
        "d0": rng.integers(-9, 9, 400).astype(np.float32)}, device)
        for _ in range(p)])
    probe = ctx.from_local_parts([_table({
        "k": rng.integers(600_000, 600_100, 300).astype(np.int32),
        "d0": rng.integers(-9, 9, 300).astype(np.float32)}, device)
        for _ in range(p)])

    s, _ = ctx.sort(anchor, "k")
    eager, _ = ctx.join(s, probe, "k")
    fused = ctx.frame(anchor).sort("k").join(ctx.frame(probe), "k")
    f_out, f_stats = fused.collect_with_stats()
    return {
        "identical": tables_bitwise_equal(eager, f_out),
        "fused_overflow": _ovf(*f_stats),
        "rows": int(f_out.global_rows()),
    }


def case_global_limit(device="cuda"):
    """Global limit == the local oracle: head-n of the shard-order
    concatenation on unordered plans, the true top-n (bit-identical) after
    sort; never the per-shard heads."""
    ctx = _ctx(device)
    p = ctx.num_shards
    rng = np.random.default_rng(17)
    n_per = 200
    # unique keys: the global top-n is a unique row set, so the oracle
    # comparison is bit-exact even through the distributed sort
    keys = rng.permutation(p * n_per).astype(np.int32)
    d0 = rng.integers(-99, 99, p * n_per).astype(np.float32)
    parts = [_table({"k": keys[i * n_per:(i + 1) * n_per],
                     "d0": d0[i * n_per:(i + 1) * n_per]}, device)
             for i in range(p)]
    dt = ctx.from_local_parts(parts)

    out = {"ok": True, "checked": []}
    for n in (0, 1, 7, 64, n_per + 3, p * n_per, p * n_per + 50):
        got = ctx.limit(dt, n).to_table().to_numpy()
        expect = min(n, p * n_per)
        head_ok = (len(got["k"]) == expect
                   and np.array_equal(got["k"], keys[:expect])
                   and np.array_equal(got["d0"], d0[:expect]))

        topn = (ctx.frame(dt).sort("k").limit(n).collect()
                .to_table().to_numpy())
        order = np.argsort(keys, kind="stable")
        top_ok = (np.array_equal(topn["k"], keys[order][:expect])
                  and np.array_equal(topn["d0"], d0[order][:expect]))
        out["ok"] = out["ok"] and head_ok and top_ok
        out["checked"].append([n, bool(head_ok), bool(top_ok)])

    # the limit node must be attributed in the wire accounting at 0 bytes
    rep = ctx.frame(dt).sort("k").limit(9).plan_report()
    lim = [r for r in rep if r["op"] == "limit"]
    out["limit_reported_zero"] = (len(lim) == 1
                                  and lim[0]["wire_bytes"] == 0)
    return out


def _one_key_parts(p, n_per, device):
    # ONE key: maximal placement skew
    return [_table({
        "k": np.zeros(n_per, np.int32),
        "d0": np.arange(i * n_per, (i + 1) * n_per).astype(np.float32)},
        device) for i in range(p)]


def case_overflow_retry(device="cuda"):
    """The cost model's overflow-safe contract: a skewed repartition whose
    stats-sized first-pass bucket overflows must re-run ONCE at
    conservative capacities and still match the local oracle bit for bit,
    never return the truncated result."""
    ctx = _ctx(device)
    p = ctx.num_shards
    n_per = 400
    parts = _one_key_parts(p, n_per, device)
    dt = ctx.analyze(ctx.from_local_parts(parts))
    if dt.stats is None or dt.stats.col("k").ndv > 2.0:
        raise AssertionError(f"analyze gave {dt.stats}")

    out, (st,) = ctx.partition_by(dt, "k")
    got = out.to_table().to_numpy()
    # oracle: all rows land on hash(0)'s shard, ordered by source shard
    # then original row order == the input's global concatenation order
    want_d0 = np.concatenate([_np(t.columns["d0"]) for t in parts])
    retries_first = ctx.overflow_retries
    # a failed-estimate output carries no propagated stats
    stats_dropped = out.stats is None
    # the same plan again: the known-bad key goes STRAIGHT to the safe plan
    out2, (st2,) = ctx.partition_by(dt, "k")
    got2 = out2.to_table().to_numpy()
    return {
        "retries": retries_first,
        "retries_after_repeat": ctx.overflow_retries,
        "stats_dropped": stats_dropped,
        "rows": int(out.global_rows()),
        "rows_expect": p * n_per,
        "final_overflow": _ovf(st, st2),
        "identical": bool(np.array_equal(got["d0"], want_d0)
                          and np.array_equal(got["k"],
                                             np.zeros(p * n_per, np.int32))
                          and np.array_equal(got2["d0"], want_d0)),
    }


def case_cost_groupby(device="cuda"):
    """Cost-model strategy choice + capacity right-sizing on 8 shards:
    two_phase at low key cardinality, raw shuffle at high, strictly fewer
    dense wire bytes than the fixed-slack no-stats baseline at BOTH ends,
    and bit-identical to the eager result."""
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    rows_per = 600
    aggs = (("d0", "sum"), ("d0", "count"), ("d0", "min"))

    def run(key_range):
        parts = [_table({
            "k": np.random.default_rng(500 + key_range + i)
            .integers(0, key_range, rows_per).astype(np.int32),
            "d0": np.random.default_rng(900 + i)
            .integers(-40, 40, rows_per).astype(np.float32)}, device,
            capacity=2 * rows_per)  # half-full: stats know what slack can't
            for i in range(p)]
        raw = ctx.from_local_parts(parts)
        analyzed = ctx.analyze(raw)
        base = ctx.frame(raw).groupby("k", aggs)      # no stats: fallback
        cost = ctx.frame(analyzed).groupby("k", aggs)  # stats: cost model
        strategy = cost.optimized().strategy
        base_wire = sum(r["wire_bytes"] for r in base.plan_report())
        cost_wire = sum(r["wire_bytes"] for r in cost.plan_report())
        eager, _ = ctx.groupby(raw, "k", aggs)
        got, stats = cost.collect_with_stats()
        return {
            "strategy": strategy,
            "base_wire": base_wire, "cost_wire": cost_wire,
            "identical": tables_bitwise_equal(eager, got),
            "overflow": _ovf(*stats),
        }

    return {"low": run(32), "high": run(rows_per * p * 4),
            "retries": ctx.overflow_retries}


def case_window_chain(device="cuda"):
    """Window functions over a sorted frame: the fused sort -> window ->
    select chain runs the window with ZERO AllToAlls, stays bit-identical
    to the one-host oracle for all 8 window functions, and strictly
    undercuts the naive lowering (window pays its own range shuffle) on
    wire bytes."""
    from repro_torch.core import ops_agg as A

    ctx = _ctx(device)
    p = ctx.num_shards
    rng = np.random.default_rng(31)
    n_per = 300
    n = p * n_per
    # FEW groups so nearly every group spans several shards; unique order
    # values keep every function deterministic, hence bit-comparable
    k = rng.integers(0, 5, n).astype(np.int32)
    o = rng.permutation(n).astype(np.int32)
    d0 = rng.integers(-30, 30, n).astype(np.float32)
    parts = [_table({
        "k": k[i * n_per:(i + 1) * n_per],
        "o": o[i * n_per:(i + 1) * n_per],
        "d0": d0[i * n_per:(i + 1) * n_per]}, device) for i in range(p)]
    dt = ctx.from_local_parts(parts)
    funcs = ["rank", "dense_rank", "row_number", ("lag", "d0"),
             ("lead", "d0"), ("cumsum", "d0"), ("cummax", "d0"),
             ("running_mean", "d0")]

    # one-host oracle: the local operator
    local = A.window(_table({"k": k, "o": o, "d0": d0}, device), "k",
                     funcs, order_by="o").to_numpy()

    # naive lowering: the window node pays its own range partition
    naive = ctx.frame(dt).window("k", funcs, order_by="o")
    nrep = naive.plan_report()
    n_out, n_stats = naive.collect_with_stats()
    got_naive = n_out.to_table().to_numpy()

    # pre-sorted lowering: fused sort -> window -> select
    fused = (ctx.frame(dt).sort(["k", "o"]).window("k", funcs, order_by="o")
             .select(lambda c: c["rank"] <= 9, key="top9"))
    frep = fused.plan_report()
    f_out, f_stats = fused.collect_with_stats()
    got = f_out.to_table().to_numpy()

    ok = True
    for name in local:
        ok &= bool(np.array_equal(got_naive[name], local[name]))
    sel = local["rank"] <= 9
    for name in local:
        ok &= bool(np.array_equal(got[name], local[name][sel]))

    win_rep = [r for r in frep if r["op"] == "window"]
    return {
        "identical": ok,
        "rows": int(f_out.global_rows()),
        "rows_expect": int(sel.sum()),
        "naive_overflow": _ovf(*n_stats),
        "fused_overflow": _ovf(*f_stats),
        "window_elided": len(win_rep) == 1 and win_rep[0]["elided"]
        and win_rep[0]["wire_bytes"] == 0,
        "naive_window_alltoall": sum(not r["elided"] for r in nrep),
        "fused_alltoall": sum(not r["elided"] for r in frep),
        "naive_wire": sum(r["wire_bytes"] for r in nrep),
        "fused_window_wire": sum(r["wire_bytes"] for r in frep
                                 if r["op"] == "window"),
    }


def case_window_thin_shards(device="cuda"):
    """Adversarial carry stitching: a group split across shards whose
    per-shard portions are SMALLER than the lag/lead offset, plus an empty
    middle shard. The input is hand-tagged range-partitioned so the crafted
    placement is kept (shuffle elided)."""
    import dataclasses

    from repro_torch.core import ops_agg as A
    from repro_torch.core.repartition import (RangePartitioning,
                                              fresh_range_fingerprint)

    ctx = _ctx(device)
    p = ctx.num_shards
    sizes = [6, 1, 2, 0, 1, 6, 1, 3]
    group = [0, 0, 0, 0, 0, 0, 1, 1]  # group id per shard (contiguous)
    n = sum(sizes)
    cap = 8
    o_all = np.arange(n, dtype=np.int32)
    d_all = (np.arange(n, dtype=np.int32) * 3 - 7).astype(np.float32)
    k_all = np.concatenate([np.full(s, g, np.int32)
                            for s, g in zip(sizes, group)])
    parts, off = [], 0
    for i in range(p):
        s = sizes[i]
        parts.append(_table(
            {"k": np.pad(k_all[off:off + s], (0, cap - s)),
             "o": np.pad(o_all[off:off + s], (0, cap - s)),
             "d0": np.pad(d_all[off:off + s], (0, cap - s))},
            device, row_count=s))
        off += s
    dt = dataclasses.replace(
        ctx.from_local_parts(parts),
        partitioning=RangePartitioning(("k", "o"), p,
                                       fresh_range_fingerprint()))
    funcs = ["rank", "dense_rank", "row_number", ("lag", "d0", 4),
             ("lead", "d0", 4), ("cumsum", "d0"), ("cummax", "d0"),
             ("running_mean", "d0")]
    fr = ctx.frame(dt).window("k", funcs, order_by="o")
    rep = fr.plan_report()
    got = fr.collect().to_table().to_numpy()
    local = A.window(_table({"k": k_all, "o": o_all, "d0": d_all}, device),
                     "k", funcs, order_by="o").to_numpy()
    ok = all(bool(np.array_equal(got[name], local[name])) for name in local)
    return {"identical": ok, "rows": int(len(got["k"])), "rows_expect": n,
            "window_elided": all(r["elided"] for r in rep
                                 if r["op"] == "window")}


def case_sort_multikey(device="cuda"):
    """Multi-key distributed sort: global lexicographic order across shards,
    row multiset preserved."""
    ctx = _ctx(device)
    rng = np.random.default_rng(13)
    parts = [_table({
        "k": rng.integers(0, 40, 700).astype(np.int32),   # heavy ties
        "d0": rng.integers(-1000, 1000, 700).astype(np.int32),
        "d1": rng.standard_normal(700).astype(np.float32)}, device)
        for _ in range(ctx.num_shards)]
    dt = ctx.from_local_parts(parts)
    s, (st,) = ctx.sort(dt, ["k", "d0"], bucket_capacity=4096)
    d = s.to_table().to_numpy()
    pairs = list(zip(d["k"].tolist(), d["d0"].tolist()))
    in_rows = sorted(
        (int(k), int(v)) for t in parts
        for k, v in zip(t.to_numpy()["k"], t.to_numpy()["d0"]))
    return {
        "rows": len(pairs),
        "rows_expect": len(in_rows),
        "order_ok": all(x <= y for x, y in zip(pairs, pairs[1:])),
        "multiset_ok": sorted(pairs) == in_rows,
        "overflow": _ovf(st),
    }


def case_serving_async(device="cuda"):
    """Concurrent-query serving on 8 shards: interleaved clients through a
    shared ServingSession give per-query results bit-identical to
    sequential collects, with ZERO plan preparations on the warm cache
    (the inline keyless lambda included), and out-of-order future
    resolution perturbs nothing."""
    from repro_torch.core.serving import ServingSession
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    rng = np.random.default_rng(71)
    n = 500 * p
    orders = _table({
        "k": rng.integers(0, 64, n).astype(np.int32),
        "d0": rng.integers(-50, 50, n).astype(np.float32)}, device)
    dims = _table({
        "k": np.arange(64, dtype=np.int32),
        "w": rng.integers(0, 9, 64).astype(np.float32)}, device)
    sess = ServingSession(ctx, max_in_flight=6)
    sess.register("orders", orders, analyze=True)
    sess.register("dims", dims, analyze=True)
    workload = [
        ("gb", lambda s: s.frame("orders")
            .groupby("k", (("d0", "sum"), ("d0", "count")))),
        ("topn", lambda s: s.frame("orders").sort("k").limit(16)),
        ("sel", lambda s: s.frame("orders")
            .select(lambda c: c["d0"] > 0.0)
            .groupby("k", (("d0", "mean"),))),
        ("join", lambda s: s.frame("orders").join(s.frame("dims"), "k")
            .groupby("k", (("w", "sum"),))),
    ]
    seq_rep, seq_res = sess.run_open_loop(
        workload, num_clients=3, queries_per_client=2, mode="sequential")
    asy_rep, asy_res = sess.run_open_loop(
        workload, num_clients=3, queries_per_client=2, mode="async")
    identical = all(tables_bitwise_equal(a.to_table(), b.to_table())
                    for a, b in zip(asy_res, seq_res))

    # out-of-order resolution: submit every shape, resolve in REVERSE
    pre = ctx.cache_stats()
    base = [sess.submit(b).result() for _, b in workload]
    futs = [sess.submit(b) for _, b in workload]
    rev = [f.result() for f in reversed(futs)][::-1]
    rev_ok = all(tables_bitwise_equal(a.to_table(), b.to_table())
                 for a, b in zip(rev, base))
    return {
        "identical": identical,
        "reverse_resolution_ok": rev_ok,
        "cold_compiles": seq_rep.compiles,
        "warm_compiles": asy_rep.compiles + (
            ctx.cache_stats()["misses"] - pre["misses"]),
        "warm_recompiles": asy_rep.recompiles,
        "queries_per_mode": seq_rep.num_queries,
        "seq_qps": seq_rep.qps, "async_qps": asy_rep.qps,
        "p50_ms": asy_rep.p50_ms, "p99_ms": asy_rep.p99_ms,
    }


def case_async_overflow_deferred(device="cuda"):
    """The deferred-verification contract on the async path: a cost-sized
    plan with a WRONG estimate (single-key skew) dispatches with its
    overflow unchecked; ``future.result()`` finds it, runs EXACTLY ONE
    safe-capacity retry and returns oracle-exact rows. A repeat submit of
    the known-bad plan goes straight to the safe plan, and the sized and
    safe plans sit in the plan cache under distinct key namespaces."""
    ctx = _ctx(device)
    p = ctx.num_shards
    n_per = 400
    parts = _one_key_parts(p, n_per, device)
    dt = ctx.analyze(ctx.from_local_parts(parts))
    if dt.stats is None or dt.stats.col("k").ndv > 2.0:
        raise AssertionError(f"analyze gave {dt.stats}")

    fut = ctx.frame(dt).partition_by("k").collect_async()
    # dispatch verified nothing: the future is unresolved
    deferred = (ctx.overflow_retries == 0) and not fut.done
    out = fut.result()  # verification: finds the overflow, retries safe
    got = out.to_table().to_numpy()
    want_d0 = np.concatenate([_np(t.columns["d0"]) for t in parts])
    retries_first = ctx.overflow_retries
    again = fut.result()  # resolved future: same object, no re-execution
    idempotent = again is out

    out2 = ctx.frame(dt).partition_by("k").collect_async().result()
    got2 = out2.to_table().to_numpy()
    namespaces = sorted({k[0][0] for k in ctx.plan_cache.keys()})
    return {
        "deferred": deferred,
        "retries": retries_first,
        "retries_after_repeat": ctx.overflow_retries,
        "idempotent": idempotent,
        "stats_dropped": out.stats is None,
        "rows": int(out.global_rows()),
        "rows_expect": p * n_per,
        "identical": bool(
            np.array_equal(got["d0"], want_d0)
            and np.array_equal(got["k"], np.zeros(p * n_per, np.int32))
            and np.array_equal(got2["d0"], want_d0)),
        "cache_namespaces": namespaces,
    }


def case_staged_shuffle(device="cuda"):
    """Staged / ring shuffles vs the monolithic exchange, under skew: the
    same rows, the same overflow with an undersized bucket, the same
    wire-byte accounting; and an empty (capacity-0) table shuffles."""
    import torch

    from repro_torch.core.table import Table
    from repro_torch.testing.compare import tables_bitwise_equal

    ctx = _ctx(device)
    p = ctx.num_shards
    rng = np.random.default_rng(11)
    n_per = 300
    # heavy skew: ~half the rows share one key -> one destination bucket
    # overflows at bucket_capacity=64
    k = np.where(rng.random(p * n_per) < 0.5, 0,
                 rng.integers(0, 997, p * n_per)).astype(np.int32)
    host = _table({"k": k, "v": rng.random(p * n_per).astype(np.float32)},
                  device)
    dt = ctx.scatter(host, local_capacity=n_per)

    results, reports = {}, {}
    for name, kw in (("mono", dict(stages=1)),
                     ("staged", dict(stages=3)),
                     ("ring", dict(shuffle_mode="ring"))):
        rep = []
        out, (st,) = ctx.partition_by(dt, "k", bucket_capacity=64,
                                      report=rep, **kw)
        results[name] = (out, _ovf(st), int(out.global_rows()))
        reports[name] = rep[0]

    mono, staged, ring = (results[n] for n in ("mono", "staged", "ring"))
    empty = ctx.from_local_parts(
        [Table.empty({"k": torch.int32}, 0, device=device)] * p)
    eout, (est_,) = ctx.partition_by(empty, "k", bucket_capacity=4, stages=2)

    return {
        "overflow_mono": mono[1],
        "overflow_positive": mono[1] > 0,
        "overflow_identical": mono[1] == staged[1] == ring[1],
        "rows_identical": mono[2] == staged[2] == ring[2],
        "staged_bitwise_equal": tables_bitwise_equal(mono[0], staged[0]),
        "ring_bitwise_equal": tables_bitwise_equal(mono[0], ring[0]),
        "wire_bytes_identical": len({reports[n]["wire_bytes"]
                                     for n in reports}) == 1,
        "stages_reported": [reports[n]["stages"]
                            for n in ("mono", "staged", "ring")],
        "modes_reported": [reports[n]["mode"]
                           for n in ("mono", "staged", "ring")],
        "empty_rows": int(eout.global_rows()),
        "empty_overflow": _ovf(est_),
    }


def case_verify_audit(device="cuda"):
    """``verify.audit_collectives`` on 8 shards: the static per-record
    accounting derived from ``plan_report`` equals the collectives the
    run made (``VirtualMesh.counts``), across every distributed operator
    family."""
    from repro_torch.core import verify as V

    ctx = _ctx(device)
    p = ctx.num_shards
    cap, kr = 200, 800
    orders = ctx.from_local_parts([_int_table(cap, kr, 500 + i, device)
                                   for i in range(p)])
    users = ctx.from_local_parts([_int_table(cap, kr, 600 + i, device)
                                  for i in range(p)])
    bucket = 2 * cap

    pipelines = {
        "groupby_chain": (
            ctx.frame(orders).join(ctx.frame(users), "k",
                                   bucket_capacity=bucket,
                                   out_capacity=4 * cap)
            .select(lambda c: c["d0"] > 0.0, key="pos")
            .groupby("k", (("d0", "sum"), ("d0", "count")),
                     strategy="shuffle", bucket_capacity=bucket)),
        "sort_join_align": (
            ctx.frame(orders).sort("k", bucket_capacity=bucket)
            .join(ctx.frame(users), "k", algorithm="sort",
                  bucket_capacity=bucket, out_capacity=4 * cap)),
        "sort_window": (
            ctx.frame(orders).sort(("k", "d1"), bucket_capacity=bucket)
            .window(("k",), (("rank", None, 0), ("cumsum", "d0", 0)),
                    order_by=("d1",), bucket_capacity=bucket)),
        "staged_shuffle": (
            ctx.frame(orders).partition_by("k", bucket_capacity=bucket,
                                           stages=3)),
        "ring_shuffle": (
            ctx.frame(orders).partition_by("k", bucket_capacity=bucket,
                                           shuffle_mode="ring")),
        "sorted_limit": (
            ctx.frame(orders).sort("k", bucket_capacity=bucket).limit(17)),
    }

    out = {}
    for name, fr in pipelines.items():
        audit = V.audit_collectives(fr, strict=False)
        out[name] = {"matched": audit["matched"],
                     "expected": audit["expected"],
                     "actual": audit["actual"]}
    out["all_matched"] = all(v["matched"] for v in out.values())
    return out


def _moe_case(device, num_shared: int, seq: int):
    """The reference's MoE case setup: its config (d_model 32, 8 experts
    top-2, d_ff 48, capacity factor 8), weights drawn for a 4-way model
    axis from a generator seeded 0, x (4, seq, 32) standard normal from one
    seeded 1; the local path's output and aux, and each batch half's
    through ``moe_fwd`` over a ``VirtualMesh(4)``."""
    import torch

    from repro_torch.core.mesh import VirtualMesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.moe import init_moe, moe_fwd
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = ModelConfig(arch="m", family="moe", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
                      moe_num_experts=8, moe_top_k=2,
                      moe_num_shared=num_shared, moe_d_ff=48,
                      moe_capacity_factor=8.0, dtype=torch.float32,
                      param_dtype=torch.float32)
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0), 4)
    x = torch.randn((4, seq, 32), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        y_local, aux_local = moe_fwd(p, x, cfg, None)
        halves = [moe_fwd(p, x[h:h + 2], cfg, VirtualMesh(4))
                  for h in (0, 2)]
    return y_local, aux_local, halves


def case_moe_ep(device="cuda"):
    """Expert-parallel dispatch (the shuffle over the model axis) equal to
    the one-device dispatch on the same weights. The EP aux is each seq
    shard's, averaged over the axis (a deliberate approximation of the
    global statistic, noisy at 8 tokens a shard): it must be a sane
    positive value near uniform routing's 1.0. The reference's replicated
    aux output is its first data shard's: here the first batch half's."""
    import torch

    y_local, aux_l, halves = _moe_case(device, 1, 8)
    y_ep = torch.cat([y for y, _ in halves], 0)
    aux_ep = halves[0][1]
    return {"moe_ep_err": float((y_local - y_ep).abs().max()),
            "moe_dropped_local": float(aux_l["moe_dropped"]),
            "aux_close": 0.5 < float(aux_ep["moe_aux"]) < 3.0
            and float(aux_l["moe_aux"]) > 0}


def case_moe_decode_psum(device="cuda"):
    """The decode path (S == 1: each shard's own experts over every token,
    summed) equal to the local path."""
    import torch

    y_local, _, halves = _moe_case(device, 0, 1)
    y_ep = torch.cat([y for y, _ in halves], 0)
    return {"moe_decode_err": float((y_local - y_ep).abs().max())}


def _lm_case_setup(device):
    """The reference's 2-layer dense config of its training cases (d 32,
    4/2 heads of 8, vocab 128, no remat) and its batch: 8 x 16 tokens from
    ``default_rng(0)``, unit weights. No flash instance takes head dim 8:
    the two cases run their model under ``oracle_scope()`` (the plain
    attention, on the card too), named so; what they test is the pod
    compression and the restore, not the kernel."""
    import torch

    from repro_torch.models.common import ModelConfig
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = ModelConfig(arch="t", family="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                      head_dim=8, remat="none")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, 128, (8, 16)).astype(np.int32)).to(dev),
        "weight": torch.ones((8,), dtype=torch.float32, device=dev)}
    return dev, cfg, batch


def case_flash_decode_shard(device="cuda"):
    """Seq-sharded flash decode == the plain decode attention, on the
    reference's (2, 4) data x model mesh and its shapes (B 4, a 64-row fp32
    cache of 2 KV heads of 8, 8 query heads, pos 17): the batch divides the
    data axis, so the cache splits 4 ways over the model axis."""
    import torch

    from repro_torch.core.mesh import NamedMesh
    from repro_torch.models import layers as NN
    from repro_torch.models.common import ModelConfig
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    mesh = NamedMesh({"data": 2, "model": 4})
    cfg = ModelConfig(arch="d", family="dense", num_layers=1, d_model=64,
                      num_heads=8, num_kv_heads=2, d_ff=64, vocab_size=64,
                      head_dim=8, decode_seq_shard=True)
    rng = np.random.default_rng(0)
    b, s_max = 4, 64

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    cache = {"k": f32(b, s_max, 2, 8), "v": f32(b, s_max, 2, 8)}
    p = NN.init_attention(cfg, torch.Generator(device=dev).manual_seed(0))
    x = f32(b, 1, 64)
    pos = 17
    rope = NN.rope_tables(torch.arange(1, device=dev) + pos, cfg.hd, 1e4)
    with torch.no_grad():
        y_shard, _ = NN.attention_fwd(
            p, x, cfg, mode="decode", rope=rope, pos=pos, mesh=mesh,
            cache={k: v.clone() for k, v in cache.items()})
        y_plain, _ = NN.attention_fwd(p, x, cfg, mode="decode", rope=rope,
                                      cache=cache, pos=pos)
    return {"flash_decode_err": float((y_shard - y_plain).abs().max()),
            "merges": dict(mesh.counts)}


def case_compress_pod(device="cuda"):
    """int8 error-feedback pod gradients track exact training: 3 steps of
    the reference's 2-layer model on its (2, 2, 2) pod x data x model mesh,
    compressed and exact from one seed; the largest parameter difference
    after them and the last losses' agreement."""
    import torch

    from repro_torch.kernels.ops import oracle_scope
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    dev, cfg, batch = _lm_case_setup(device)
    mesh = make_local_mesh(8, model=2, pod=2)
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    model_c = build_model(cfg, dev, mesh=mesh)
    model_e = build_model(cfg, dev, mesh=mesh)
    st_c = init_train_state(model_c, 0, compress_pod=True, n_pods=2)
    st_e = init_train_state(model_e, 0)
    step_c = make_train_step(model_c, ocfg, compress_pod=True)
    step_e = make_train_step(model_e, ocfg)
    with oracle_scope():
        for _ in range(3):
            st_c, mc = step_c(st_c, batch)
            st_e, me = step_e(st_e, batch)
    diff = max(float((st_c.params[n].float() - st_e.params[n].float())
                     .abs().max()) for n in st_c.params)
    ef_abs = max(float(e.abs().max()) for e in st_c.ef.values())
    return {"pod_compress_max_param_diff": diff,
            "loss_close": abs(float(mc["loss"]) - float(me["loss"])) < 0.2,
            "ef_finite": all(bool(torch.isfinite(e).all())
                             for e in st_c.ef.values()),
            "ef_max_abs": ef_abs}


def case_elastic_restore(device="cuda"):
    """Save on a (4, 2) data x model mesh, restore on (4, 2), (2, 4) and
    (8, 1): the loss of the restored state is the same under each (the
    reference allows 2e-3 for its meshes' reduction orders; here the
    dense arithmetic does not depend on the mesh)."""
    import tempfile

    import torch

    from repro_torch.core.mesh import NamedMesh
    from repro_torch.kernels.ops import oracle_scope
    from repro_torch.models.factory import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.steps import init_train_state

    dev, cfg, batch = _lm_case_setup(device)
    losses, steps = {}, []
    with tempfile.TemporaryDirectory() as d:
        for name, shape in (("a", (4, 2)), ("b", (2, 4)), ("c", (8, 1))):
            mesh = NamedMesh({"data": shape[0], "model": shape[1]})
            model = build_model(cfg, dev, mesh=mesh)
            if not losses:
                ckpt.save(d, 1, init_train_state(model, 0))
            # another draw, which the restore must overwrite
            like = init_train_state(model, 1)
            state, step = ckpt.CheckpointManager(d).resume(like, mesh=mesh)
            steps.append(step if state is like else None)
            with torch.no_grad(), oracle_scope():
                loss, _ = model.loss_fn(batch)
            losses[name] = float(loss)
    vals = list(losses.values())
    return {"elastic_losses": vals, "restored_steps": steps,
            "elastic_ok": steps == [1, 1, 1]
            and max(vals) - min(vals) < 2e-3}


CASES = {k[5:]: v for k, v in list(globals().items())
         if k.startswith("case_")}


def _all(*keys):
    return lambda r: all(r[k] for k in keys)


def _eq(a, b):
    return lambda r: r[a] == r[b]


def _zero(*keys):
    return lambda r: all(r[k] == 0 for k in keys)


# what tests/test_dist.py asserts of each case's JSON: (condition, test)
_CHECKS = {
    "join_union_sort": (
        ("hash join rows as counted", _eq("join_hash_rows", "join_expect")),
        ("sort join rows as counted", _eq("join_sort_rows", "join_expect")),
        ("no hash join overflow", _zero("join_hash_overflow")),
        ("union rows as counted", _eq("union_rows", "union_expect")),
        ("sorted", _all("sort_ok"))),
    "intersect_difference": (
        ("intersect and difference as the set oracle",
         _all("intersect_ok", "difference_ok")),),
    "groupby": (
        ("both strategies as the oracle", _all("shuffle_ok", "two_phase_ok")),
        ("no overflow", _zero("shuffle_overflow", "two_phase_overflow")),
        ("two-phase shuffles fewer rows", _all("two_phase_fewer_rows"))),
    "plan_fused": (
        ("fused equal to eager", _all("identical")),
        ("no overflow", _zero("eager_overflow", "fused_overflow")),
        ("fewer AllToAlls", lambda r: r["fused_alltoall"] < r["eager_alltoall"]),
        ("fewer wire bytes", lambda r: r["fused_wire"] < r["eager_wire"])),
    "sort_chain": (
        ("fused equal to eager", _all("identical")),
        ("no overflow", _zero("eager_overflow", "fused_overflow")),
        ("one AllToAll fewer",
         lambda r: r["fused_alltoall"] == r["eager_alltoall"] - 1),
        ("groupby shuffle elided, equal",
         _all("groupby_elided", "groupby_identical"))),
    "sort_align_skew": (
        ("fused equal to eager", _all("identical")),
        ("no overflow", _zero("fused_overflow"))),
    "global_limit": (
        ("equal to the local oracle", _all("ok")),
        ("limit reports no overflow", _all("limit_reported_zero"))),
    "overflow_retry": (
        ("one retry, one after a repeat",
         lambda r: r["retries"] == 1 and r["retries_after_repeat"] == 1),
        ("stats dropped", _all("stats_dropped")),
        ("no final overflow", _zero("final_overflow")),
        ("rows as the oracle", _eq("rows", "rows_expect")),
        ("equal to the oracle", _all("identical"))),
    "cost_groupby": (
        ("no retry", _zero("retries")),
        ("two_phase at low cardinality",
         lambda r: r["low"]["strategy"] == "two_phase"),
        ("shuffle at high cardinality",
         lambda r: r["high"]["strategy"] == "shuffle"),
        ("both ends equal, no overflow, fewer wire bytes",
         lambda r: all(r[e]["identical"] and r[e]["overflow"] == 0
                       and r[e]["cost_wire"] < r[e]["base_wire"]
                       for e in ("low", "high")))),
    "window_chain": (
        ("equal to the one-host oracle", _all("identical")),
        ("window shuffle elided", _all("window_elided")),
        ("one AllToAll each way", lambda r: r["fused_alltoall"] == 1
         and r["naive_window_alltoall"] == 1),
        ("elided window moves no wire bytes", _zero("fused_window_wire")),
        ("naive window moves wire bytes", lambda r: r["naive_wire"] > 0),
        ("no overflow", _zero("naive_overflow", "fused_overflow")),
        ("rows as the oracle", _eq("rows", "rows_expect"))),
    "window_thin_shards": (
        ("equal to the one-host oracle", _all("identical")),
        ("window shuffle elided", _all("window_elided")),
        ("rows as the oracle", _eq("rows", "rows_expect"))),
    "sort_multikey": (
        ("ordered, same multiset", _all("order_ok", "multiset_ok")),
        ("rows as the oracle", _eq("rows", "rows_expect")),
        ("no overflow", _zero("overflow"))),
    "serving_async": (
        ("interleaved equal to sequential", _all("identical")),
        ("reverse resolution changes nothing", _all("reverse_resolution_ok")),
        ("the cold pass prepared", lambda r: r["cold_compiles"] > 0),
        ("the warm pass prepared nothing",
         _zero("warm_compiles", "warm_recompiles")),
        ("timed", lambda r: r["async_qps"] > 0 and r["p99_ms"] > 0)),
    "async_overflow_deferred": (
        ("deferred, idempotent, stats dropped, equal",
         _all("deferred", "idempotent", "stats_dropped", "identical")),
        ("one retry, one after a repeat",
         lambda r: r["retries"] == 1 and r["retries_after_repeat"] == 1),
        ("rows as the oracle", _eq("rows", "rows_expect")),
        ("sized and safe plans cached apart",
         lambda r: {"plan", "plan-safe"} <= set(r["cache_namespaces"]))),
    "staged_shuffle": (
        ("skew overflows", _all("overflow_positive")),
        ("every staging equal to the monolithic exchange",
         _all("overflow_identical", "rows_identical", "staged_bitwise_equal",
              "ring_bitwise_equal", "wire_bytes_identical")),
        ("stages and modes reported", lambda r: r["stages_reported"]
         == [1, 3, 1] and r["modes_reported"] == ["alltoall", "alltoall",
                                                  "ring"]),
        ("an empty table shuffles", _zero("empty_rows", "empty_overflow"))),
    "verify_audit": (
        ("every audit matched", _all("all_matched")),
        ("ring uses ppermutes only",
         lambda r: r["ring_shuffle"]["actual"]["all_to_all"] == 0
         and r["ring_shuffle"]["actual"]["ppermute"] > 0),
        ("staging multiplies AllToAlls",
         lambda r: r["staged_shuffle"]["actual"]["all_to_all"]
         > r["groupby_chain"]["actual"]["all_to_all"]),
        ("alignment and window carries gather",
         lambda r: r["sort_join_align"]["actual"]["all_gather"] > 0
         and r["sort_window"]["actual"]["all_gather"] > 0)),
    "moe_ep": (
        ("EP dispatch equal to the local path", lambda r: r["moe_ep_err"] < 2e-5),
        ("aux sane", _all("aux_close"))),
    "moe_decode_psum": (
        ("psum decode equal to the local path",
         lambda r: r["moe_decode_err"] < 2e-5),),
    "flash_decode_shard": (
        ("seq-sharded decode equal to the plain decode",
         lambda r: r["flash_decode_err"] < 2e-4),),
    "compress_pod": (
        ("compressed training tracks exact",
         lambda r: r["pod_compress_max_param_diff"] < 5e-2),
        ("losses close", _all("loss_close"))),
    "elastic_restore": (
        ("the restored loss is the same on every mesh", _all("elastic_ok")),),
}


def checks(out: dict) -> dict[str, bool]:
    """What each case's JSON must show, by ``"<case>: <condition>"``, for
    every case in ``out`` (case name -> its JSON): what tests/test_dist.py
    asserts of the reference's case of the same name."""
    return {f"{case}: {desc}": bool(test(out[case]))
            for case in out for desc, test in _CHECKS[case]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("JSON:" + json.dumps(CASES[args.case](device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
