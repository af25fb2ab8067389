"""repro_torch.core.trace: the program's spans and counters.

Spans are profiler ranges only inside ``trace.spanning()`` while the
profiler runs, one a step over all shards, each under the range that
encloses it; counters keep the program's own tensors inside
``trace.counting()`` and equal the shuffle stats and ``report=`` records of
the same call, and hold only the queries of the thread that opened them.
Also the reductions of ``tools/trace_cells.py`` on a synthetic profile.
"""
import importlib.util
import os
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import trace  # noqa: E402
from repro_torch.core.context import DistContext, DistTable  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 8
ROWS = 64


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(seed, rows=ROWS):
    g = torch.Generator().manual_seed(seed)
    return DistTable(
        {"k": torch.randint(0, 4 * rows, (P, rows), generator=g,
                            dtype=torch.int32),
         "v": torch.randn(P, rows, generator=g)},
        torch.full((P,), rows, dtype=torch.int32))


def _calls(ctx, a, b):
    """(name, thunk) of the calls the span tests make: a join, a two-phase
    groupby, a global sort and a join whose shuffles the planner elides."""
    ap, _ = ctx.partition_by(a, "k")
    bp, _ = ctx.partition_by(b, "k")

    def frame_join(report):
        return ctx.frame(ap).join(ctx.frame(bp), "k").collect_with_stats(
            report=report)
    return [
        ("join", lambda report: ctx.join(a, b, "k", report=report)),
        ("groupby", lambda report: ctx.groupby(
            a, "k", {"v": ["sum"]}, strategy="two_phase", report=report)),
        ("sort", lambda report: ctx.sort(a, "k", report=report)),
        ("elided join", frame_join),
    ]


def _named_spans(prof):
    """(name, its innermost enclosing program span) of every span."""
    out = []
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("repro_torch."):
                p = p.cpu_parent
            out.append((e.name, p.name if p is not None else None))
    return out


def test_span_is_the_null_context_unless_spanning_under_the_profiler(
        monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    ctx = DistContext(num_shards=P, device="cpu")
    a, b = _table(1), _table(2)
    with trace.spanning():  # no profiler
        ctx.join(a, b, "k")
        assert trace.span("repro_torch.x") is trace.span("repro_torch.y")
    with profile(activities=[ProfilerActivity.CPU]):  # not spanning
        ctx.join(a, b, "k")
    assert opened == []
    with trace.spanning(), profile(activities=[ProfilerActivity.CPU]):
        ctx.join(a, b, "k")
        with trace.spanning(False):
            assert trace.span("repro_torch.x") is trace.span("repro_torch.y")
    assert opened[0] == "repro_torch.submit" and "repro_torch.exchange" in opened


def test_spans_nest_under_their_parents_and_change_nothing():
    ctx = DistContext(num_shards=P, device="cpu")
    a, b = _table(3), _table(4)
    calls = _calls(ctx, a, b)
    plain = []
    for _, call in calls:
        rep = []
        plain.append((call(rep), rep))
    ex = "repro_torch.exchange"
    root = {("repro_torch.submit", None),
            ("repro_torch.plan", "repro_torch.submit"),
            ("repro_torch.execute", "repro_torch.submit"),
            ("repro_torch.result", None)}

    def op(name, *inner, exchange=True):
        o = "repro_torch.op." + name
        got = root | {(o, "repro_torch.execute")} | {(n, o) for n in inner}
        if exchange:
            got |= {(ex, o)} | {(ex + step, ex) for step in (
                ".partition_ids", ".pack", ".buffers", ".all_to_all",
                ".compact")}
        return got
    want = {
        "join": op("join", "repro_torch.join.local"),
        "groupby": op("groupby", "repro_torch.groupby.partial",
                      "repro_torch.groupby.final"),
        "sort": op("sort"),
        "elided join": op("join", "repro_torch.join.local", exchange=False),
    }
    for (name, call), ((out0, st0), rep0) in zip(calls, plain):
        rep = []
        with trace.spanning(), profile(activities=[ProfilerActivity.CPU]) as prof:
            out, st = call(rep)
        got = _named_spans(prof)
        assert set(got) == want[name], name
        assert sum(n == ex for n, _ in got) == sum(not r["elided"] for r in rep)
        assert sum(n == "repro_torch.submit" for n, _ in got) == 1
        # the spans change no result and no record
        assert rep == rep0
        assert torch.equal(out.row_counts, out0.row_counts)
        for k in out.columns:
            assert torch.equal(out.columns[k], out0.columns[k]), (name, k)
        for s, s0 in zip(st, st0):
            assert torch.equal(s.received, s0.received)


def test_counters_equal_shuffle_stats_and_report():
    ctx = DistContext(num_shards=P, device="cpu")
    a, b = _table(5), _table(6)
    for how in ("join", "groupby"):
        rep = []
        with trace.counting() as c:
            if how == "join":
                out, st = ctx.join(a, b, "k", report=rep)
            else:
                out, st = ctx.groupby(a, "k", {"v": ["sum", "count"]},
                                      strategy="two_phase", report=rep)
        got = c.resolve()
        assert got["exchange.rows_received"] == sum(
            int(s.received.sum()) for s in st)
        assert got["exchange.slots"] == sum(
            r["wire_bytes"] // r["row_bytes"] for r in rep)
        if how == "join":
            assert got["join.rows_out"] == int(out.row_counts.sum())
            assert got["join.slots"] == P * out.local_capacity
        else:
            assert "join.rows_out" not in got
    # nothing kept outside a scope; scopes nest
    trace.count("join.slots", 5)
    with trace.counting() as outer:
        trace.count("x", torch.tensor([1, 2], dtype=torch.int32))
        with trace.counting() as inner:
            trace.count("x", 10)
        trace.count("x", torch.tensor(4))
    trace.count("x", 100)
    assert outer.resolve() == {"x": 7} and inner.resolve() == {"x": 10}


def test_a_counting_scope_sees_only_its_own_threads_queries():
    """Two client threads hold their scopes open over both queries: each
    scope counts only the query of its own thread."""
    ctx = DistContext(num_shards=P, device="cpu")
    tabs = {"a": (_table(8), _table(9)),
            "b": (_table(10, rows=ROWS // 2), _table(11, rows=ROWS // 2))}
    both = threading.Barrier(2)
    got, want = {}, {}

    def client(name):
        a, b = tabs[name]
        with trace.counting() as c:
            both.wait()
            out, st = ctx.join(a, b, "k")
            both.wait()
        got[name] = c.resolve()
        want[name] = {"exchange.rows_received": sum(
            int(s.received.sum()) for s in st),
            "join.rows_out": int(out.row_counts.sum())}

    threads = [threading.Thread(target=client, args=(n,)) for n in tabs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert want["a"] != want["b"]
    for name in tabs:
        assert {k: got[name][k] for k in want[name]} == want[name], name


def _ev(name, start, end, dev="CPU", parent=None):
    e = types.SimpleNamespace(
        name=name, device_type=getattr(torch.autograd.DeviceType, dev),
        time_range=types.SimpleNamespace(start=start, end=end),
        cpu_parent=parent, cpu_children=[])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_trace_cells_reduces_a_synthetic_profile():
    """One call (us): submit [1, 100] > execute > op.join [10, 90] >
    exchange [10, 30], join.local [30, 90] (a sync [31, 48] in it); the
    exchange's kernels run at [15, 25], [25, 33], the local join's at [50,
    70], [70, 80] (the spans' device-side ranges [15, 33], [50, 80]); two
    more, under no span, at [101, 102] and [300, 310]."""
    tc = _load("trace_cells", os.path.join(ROOT, "tools", "trace_cells.py"))
    call = _ev("bench.call", 0, 150)
    sub = _ev("repro_torch.submit", 1, 100, parent=call)
    plan = _ev("repro_torch.plan", 2, 9, parent=sub)
    exe = _ev("repro_torch.execute", 9, 95, parent=sub)
    op = _ev("repro_torch.op.join", 10, 90, parent=exe)
    x = _ev("repro_torch.exchange", 10, 30, parent=op)
    loc = _ev("repro_torch.join.local", 30, 90, parent=op)
    sync = _ev("cudaStreamSynchronize", 31, 48, parent=loc)
    kernels = [_ev(f"k{i}", s, e, dev="CUDA") for i, (s, e) in enumerate(
        ((15, 25), (25, 33), (50, 70), (70, 80), (101, 102), (300, 310)))]
    ann = [_ev("repro_torch.exchange", 15, 33, dev="CUDA"),
           _ev("repro_torch.join.local", 50, 80, dev="CUDA"),
           _ev("bench.call", 15, 310, dev="CUDA")]
    r = tc.reduce_spans([call, sub, plan, exe, op, x, loc, sync, *kernels,
                         *ann], calls=1)
    ms = 1e-3
    assert r["busy_ms"] == pytest.approx(59 * ms)
    assert r["exchange_device_ms"] == pytest.approx(18 * ms)
    assert r["local_join_device_ms"] == pytest.approx(30 * ms)
    assert r["aggregate_device_ms"] == 0
    assert r["op_ms"] == pytest.approx(48 * ms)
    assert r["spans"]["repro_torch.op.join"]["device_ms"] == 0
    assert r["spans"]["repro_torch.exchange"] == {
        "n": 1, "host_ms": pytest.approx(20 * ms),
        "device_ms": pytest.approx(18 * ms)}
    assert r["plan_host_ms"] == pytest.approx(7 * ms)
    assert r["op_cover"] == pytest.approx(48 / 59)
    assert r["inner_cover"] == pytest.approx(1.0)
    assert r["idle_gaps_ms"] == {
        "bench.call": pytest.approx(198 * ms),
        "repro_torch.join.local": pytest.approx(21 * ms),
        "repro_torch.join.local > cudaStreamSynchronize": pytest.approx(
            17 * ms)}
    assert r["gaps_in_a_call_unnamed"] == [
        ["bench.call", pytest.approx(198 * ms)]]
    f = tc.fills({"exchange.rows_received": 64, "exchange.slots": 128,
                  "join.rows_out": 16, "join.slots": 128})
    assert f["exchange_fill_pct"] == 50.0 and f["join_fill_pct"] == 12.5
    assert tc.fills({})["join_fill_pct"] is None
