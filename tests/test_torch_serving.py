"""The serving layer as a whole: repro_torch's fault registry, plan cache,
futures, recovery ladder and ServingSession against repro's.

The pure-Python modules (``faults``, ``plan_cache``) are held against the
reference's in this process, call for call. The rest runs in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as in
tests/test_torch_dist.py) that runs every case below on the reference and
pickles what it saw. The port runs the chaos cases through its own
``repro_torch.testing.chaos_cases`` (each case records its runs' rows and
counters), on 8 virtual shards on the CPU; the reference side runs them
through the code below, which makes the same calls in the same order (so
the verifier's process-wide counters agree too), fault-free runs first.
The cases are those of ``repro.testing.chaos_cases`` (shuffle garble and
raise on staged and ring exchanges, kernel raise, NaN and persistent
faults, a derated ``stats.estimate``, ``cache.admission`` miss and evict,
``compile`` on the warm hit, an open loop that survives a kernel fault and
a raising query) and ``case_serving_async`` of
``repro.testing.dist_cases``, which both sides run through the code below.
Every recovered run's rows must also equal its fault-free run's. Tolerance:
none. For every case these must be equal: the rows (bitwise, in shard
order) and every ``cache_stats()`` counter, the verifier's counters taken
from zero at the start of the case; for the open loops also every
``ServingReport`` field that is not a time. The reference's
``DistContext.analyze`` raises on the installed jax, so the reference side
puts ``analyze_table(dt.to_table())`` on its tables with
``dataclasses.replace`` (max_shard_rows = the largest shard's count), as
tests/test_torch_plan.py does.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the cases, one code for both sides (``api`` holds one side's modules)
# ---------------------------------------------------------------------------


def orders(api, n_per_shard=400, keys=57, seed=11):
    rng = np.random.default_rng(seed)
    n = n_per_shard * P
    return api.table({
        "k": rng.integers(0, keys, n).astype(np.int32),
        "d0": rng.integers(-50, 50, n).astype(np.float32),
        "d1": rng.integers(0, 1000, n).astype(np.int32)})


def seen(api, ctx, out) -> dict:
    return {"rows": api.rows(out), "stats": ctx.cache_stats()}


def case_shuffle_recovery(api):
    FLT = api.FLT
    t = orders(api)
    out = {}
    for mode_name, kw in (("staged", {"stages": 3}),
                          ("ring", {"shuffle_mode": "ring"})):
        ctx0 = api.ctx()
        ref, _ = ctx0.partition_by(ctx0.scatter(t), "k",
                                   bucket_capacity=1024, **kw)
        out[f"{mode_name}_ref"] = seen(api, ctx0, ref)
        for fmode in ("raise", "garble"):
            ctx = api.ctx(faults=[FLT.FaultPlan("shuffle.chunk", mode=fmode,
                                                nth=1)])
            got, _ = ctx.partition_by(ctx.scatter(t), "k",
                                      bucket_capacity=1024, **kw)
            out[f"{mode_name}_{fmode}"] = seen(api, ctx, got)
    return out


def case_kernel_recovery(api):
    FLT = api.FLT
    t = orders(api)
    out = {}
    modes = (("raise", (("d0", "sum"), ("d0", "count"))),
             ("nan", (("d0", "sum"),)))
    for fmode, aggs in modes:
        ctx0 = api.ctx()
        ref, _ = ctx0.groupby(ctx0.scatter(t), "k", aggs)
        out[f"{fmode}_ref"] = seen(api, ctx0, ref)
    for fmode, aggs in modes:
        ctx = api.ctx(faults=[FLT.FaultPlan("kernel.dispatch", mode=fmode,
                                            nth=1)])
        got, _ = ctx.groupby(ctx.scatter(t), "k", aggs)
        out[fmode] = seen(api, ctx, got)
    ctx = api.ctx(faults=[FLT.FaultPlan("kernel.dispatch", probability=1.0,
                                        max_fires=10_000)],
                  retry=FLT.RetryPolicy(max_attempts=3))
    got, _ = ctx.groupby(ctx.scatter(t), "k",
                         (("d0", "sum"), ("d0", "count")))
    out["persistent"] = seen(api, ctx, got)
    return out


def case_stats_overflow_recovery(api):
    FLT = api.FLT
    t = orders(api, keys=97)
    out = {}
    ctx0 = api.ctx()
    ref, _ = ctx0.groupby(api.analyze(ctx0, ctx0.scatter(t)), "k",
                          (("d0", "sum"),), strategy="shuffle")
    out["ref"] = seen(api, ctx0, ref)
    ctx = api.ctx(faults=[FLT.FaultPlan("stats.estimate", probability=1.0,
                                        max_fires=10_000, factor=64.0)])
    dt = api.analyze(ctx, ctx.scatter(t))
    got, _ = ctx.groupby(dt, "k", (("d0", "sum"),), strategy="shuffle")
    out["first"] = seen(api, ctx, got)
    got2, _ = ctx.groupby(dt, "k", (("d0", "sum"),), strategy="shuffle")
    out["second"] = seen(api, ctx, got2)
    return out


def case_cache_and_compile(api):
    FLT = api.FLT
    t = orders(api)
    ctx0 = api.ctx()
    ref, _ = ctx0.groupby(ctx0.scatter(t), "k", (("d0", "sum"),))
    out = {"ref": seen(api, ctx0, ref)}
    for fmode in ("miss", "evict"):
        ctx = api.ctx(faults=[FLT.FaultPlan("cache.admission", mode=fmode,
                                            nth=2)])  # the warm hit
        dt = ctx.scatter(t)
        a, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
        b, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
        out[fmode] = {"a": api.rows(a), **seen(api, ctx, b)}
    ctx = api.ctx(faults=[FLT.FaultPlan("compile", nth=1)])
    dt = ctx.scatter(t)
    a, _ = ctx.groupby(dt, "k", (("d0", "sum"),))
    b, _ = ctx.groupby(dt, "k", (("d0", "sum"),))  # fires on the warm hit
    out["compile"] = {"a": api.rows(a), **seen(api, ctx, b)}
    return out


def report_fields(rep) -> dict:
    """Every ServingReport field that is not a time."""
    d = rep.to_dict()
    for k in ("elapsed_s", "qps", "p50_ms", "p99_ms"):
        d.pop(k)
    return {**d, "shapes": list(rep.shapes)}


def case_serving_survival(api):
    FLT = api.FLT
    t = orders(api, keys=64)
    workload = [
        ("gb", lambda s: s.frame("orders")
            .groupby("k", (("d0", "sum"), ("d0", "count")))),
        ("sel", lambda s: s.frame("orders")
            .select(lambda c: c["d0"] > 0.0, key=("pos",))
            .groupby("k", (("d0", "sum"),))),
        ("sort", lambda s: s.frame("orders").sort("k").limit(16)),
    ]

    def loop(ctx, wl):
        sess = api.ServingSession(ctx, max_in_flight=4)
        sess.register("orders", t)
        rep, res = sess.run_open_loop(wl, num_clients=3, queries_per_client=2,
                                      mode="async")
        return {"report": report_fields(rep),
                "rows": [None if r is None else api.rows(r) for r in res]}

    def boom(_s):
        raise ValueError("client bug")

    out = {"ref": loop(api.ctx(), workload)}
    out["fault"] = loop(api.ctx(faults=[FLT.FaultPlan(
        "kernel.dispatch", probability=1.0, max_fires=1)]), workload)
    out["boom"] = loop(api.ctx(), list(workload) + [("boom", boom)])
    return out


def case_serving_async(api):
    ctx = api.ctx()
    rng = np.random.default_rng(71)
    n = 500 * P
    orders_t = api.table({
        "k": rng.integers(0, 64, n).astype(np.int32),
        "d0": rng.integers(-50, 50, n).astype(np.float32)})
    dims = api.table({
        "k": np.arange(64, dtype=np.int32),
        "w": rng.integers(0, 9, 64).astype(np.float32)})
    sess = api.ServingSession(ctx, max_in_flight=6)
    sess.register("orders", api.analyze(ctx, ctx.scatter(orders_t)))
    sess.register("dims", api.analyze(ctx, ctx.scatter(dims)))
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
    pre = ctx.cache_stats()
    base = [sess.submit(b).result() for _, b in workload]
    futs = [sess.submit(b) for _, b in workload]
    rev = [f.result() for f in reversed(futs)][::-1]
    return {"seq": report_fields(seq_rep), "async": report_fields(asy_rep),
            "seq_rows": [api.rows(r) for r in seq_res],
            "async_rows": [api.rows(r) for r in asy_res],
            "base_rows": [api.rows(r) for r in base],
            "reverse_rows": [api.rows(r) for r in rev],
            "warm_misses": ctx.cache_stats()["misses"] - pre["misses"],
            "stats": ctx.cache_stats()}


CASES = {k[5:]: v for k, v in list(globals().items())
         if k.startswith("case_")}


def run_cases(api) -> dict:
    out = {}
    for name, case in CASES.items():
        api.V.reset_counters()
        out[name] = case(api)
    return out


def reference_api():
    import jax.numpy as jnp  # noqa: F401  (initializes the 8 devices)

    from repro.core import faults as FLT
    from repro.core import stats as RS
    from repro.core import verify as V
    from repro.core.context import DistContext
    from repro.core.serving import ServingSession
    from repro.core.table import Table

    def analyze(ctx, dt):
        st = RS.analyze_table(dt.to_table())
        st = dataclasses.replace(
            st, max_shard_rows=float(np.asarray(dt.row_counts).max()))
        return dataclasses.replace(dt, stats=st)

    def rows(dt):
        t = dt.to_table()
        n = int(t.row_count)
        return {k: np.asarray(v)[:n] for k, v in sorted(t.columns.items())}

    return types.SimpleNamespace(
        FLT=FLT, V=V, ServingSession=ServingSession, analyze=analyze,
        rows=rows, table=lambda cols: Table.from_arrays(cols),
        ctx=lambda faults=None, retry=None: DistContext(
            faults=faults, retry_policy=retry or FLT.RetryPolicy()))


def port_api():
    from repro_torch.core import faults as FLT
    from repro_torch.core import verify as V
    from repro_torch.core.context import DistContext
    from repro_torch.core.serving import ServingSession
    from repro_torch.core.table import Table

    return types.SimpleNamespace(
        FLT=FLT, V=V, ServingSession=ServingSession,
        analyze=lambda ctx, dt: ctx.analyze(dt),
        rows=lambda dt: dt.to_table().to_numpy(),
        table=lambda cols: Table.from_numpy(cols, device="cpu"),
        ctx=lambda faults=None, retry=None: DistContext(
            num_shards=P, device="cpu", faults=faults,
            retry_policy=retry or FLT.RetryPolicy()))


def reference_main(out_path: str) -> None:
    """Run every case on the reference (8 host devices) into ``out_path``."""
    res = run_cases(reference_api())
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    # Every case opens fresh contexts whose plan caches prepare the same
    # programs again (the counters under test); XLA's persistent cache
    # compiles each distinct program once. Its loader's notes on
    # compile-time tuning flags are silenced.
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path_factory.mktemp("xla"))
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "-1"
    env["TF_CPP_MIN_LOG_LEVEL"] = "3"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, \
        f"reference run failed:\n{proc.stdout}\n{proc.stderr}"
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_run():
    """The chaos cases through ``repro_torch.testing.chaos_cases`` (their
    recorded runs and their JSON), ``serving_async`` through
    :func:`case_serving_async`; the verifier's counters from zero at each
    case's start."""
    from repro_torch.core import verify as V
    from repro_torch.testing import chaos_cases as C

    api = port_api()
    records, results = {}, {}
    for name, case in CASES.items():
        V.reset_counters()
        if name in C.CASES:
            records[name] = {}
            results[name] = C.CASES[name](device="cpu", record=records[name])
        else:
            records[name] = case(api)
    return records, results


@pytest.fixture(scope="module")
def port(port_run):
    return port_run[0]


@pytest.fixture(scope="module")
def chaos(port_run):
    """Each chaos case's JSON, as its CLI prints it."""
    return port_run[1]


def test_the_port_runs_every_chaos_case_of_its_module():
    from repro_torch.testing import chaos_cases as C

    assert set(C.CASES) == set(CASES) - {"serving_async"}


def assert_same(got, want, path: str = "") -> None:
    """Equal nested results: arrays bitwise (floats by their bits)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, path
        if want.dtype == np.float32:
            g, want = g.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(g, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_reference(reference, port, case):
    assert_same(port[case], reference[case], case)


def test_chaos_recovers_through_its_rung(port):
    """What tests/test_chaos.py asserts of the reference, on the port."""
    r = port["shuffle_recovery"]
    for tag in ("staged", "ring"):
        assert_same(r[f"{tag}_raise"]["rows"], r[f"{tag}_ref"]["rows"])
        assert_same(r[f"{tag}_garble"]["rows"], r[f"{tag}_ref"]["rows"])
        assert r[f"{tag}_raise"]["stats"]["degraded_shuffle"] >= 1
        assert r[f"{tag}_garble"]["stats"]["quarantines"] >= 1
        assert r[f"{tag}_raise"]["stats"]["failed_queries"] == 0
        assert r[f"{tag}_garble"]["stats"]["failed_queries"] == 0
    k = port["kernel_recovery"]
    assert_same(k["raise"]["rows"], k["raise_ref"]["rows"])
    assert_same(k["nan"]["rows"], k["nan_ref"]["rows"])
    assert_same(k["persistent"]["rows"], k["raise_ref"]["rows"])
    assert k["raise"]["stats"]["degraded_kernel"] >= 1
    assert k["nan"]["stats"]["quarantines"] >= 1
    assert k["persistent"]["stats"]["failed_queries"] == 0
    s = port["stats_overflow_recovery"]
    assert_same(s["first"]["rows"], s["ref"]["rows"])
    assert_same(s["second"]["rows"], s["ref"]["rows"])
    assert s["first"]["stats"]["overflow_retries"] == 1
    assert s["second"]["stats"]["overflow_retries"] == 1  # bad key kept
    c = port["cache_and_compile"]
    for mode in ("miss", "evict", "compile"):
        assert_same(c[mode]["a"], c[mode]["rows"])
        assert c[mode]["stats"]["failed_queries"] == 0
    assert c["miss"]["stats"]["recompiles"] >= 1
    assert c["evict"]["stats"]["recompiles"] >= 1
    assert c["compile"]["stats"]["compile_retries"] >= 1
    v = port["serving_survival"]
    assert_same(v["fault"]["rows"], v["ref"]["rows"])
    rep = v["fault"]["report"]
    assert rep["failed"] == 0 and rep["degraded"] + rep["quarantines"] >= 1
    assert v["boom"]["report"]["failed"] == 1
    assert [e[0] for e in v["boom"]["report"]["errors"]] == ["boom"]
    assert sum(r is not None for r in v["boom"]["rows"]) == \
        v["boom"]["report"]["queries"] - 1


CHAOS = [c for c in CASES if c != "serving_async"]


@pytest.mark.parametrize("case", CHAOS)
def test_chaos_case_meets_its_checks(chaos, case):
    """What tests/test_chaos.py asserts of the reference's JSON, and that
    each shuffle fault fired once and the derated estimate fired
    (``chaos_cases.checks``, which chip_smoke.py's phase 13 uses too)."""
    from repro_torch.testing import chaos_cases as C

    failed = [k for k, ok in C.checks({case: chaos[case]}).items() if not ok]
    assert not failed, (failed, chaos[case])


# one bad value a case, planted in its real JSON: each must fail its checks
PLANTED = {
    "shuffle_recovery": ("staged_raise_fires", 2),
    "kernel_recovery": ("nan_identical", False),
    "stats_overflow_recovery": ("fires", False),
    "cache_and_compile": ("evict_recompiles", 0),
    "serving_survival": ("boom_failed_labels", ["boom", "gb"]),
}


@pytest.mark.parametrize("case", CHAOS)
def test_a_planted_bad_chaos_output_fails_its_checks(chaos, case):
    from repro_torch.testing import chaos_cases as C

    key, value = PLANTED[case]
    assert key in chaos[case]
    bad = {**chaos[case], key: value}
    assert not all(C.checks({case: bad}).values()), bad


def test_serving_async_warm_cache(port):
    """case_serving_async's gates: modes bit-identical, the cold loop
    prepares each of the 4 shapes once (the inline keyless lambda
    included), nothing after, and reverse resolution changes nothing."""
    s = port["serving_async"]
    assert_same(s["async_rows"], s["seq_rows"])
    assert_same(s["reverse_rows"], s["base_rows"])
    # 4 shapes, and the safe plan of one whose estimates overflow at
    # this size
    assert s["seq"]["compiles"] == 4 + s["seq"]["retries"]
    assert s["async"]["compiles"] == 0 and s["warm_misses"] == 0
    assert s["async"]["recompiles"] == 0


# ---------------------------------------------------------------------------
# faults and plan_cache: the pure-Python modules, call for call
# ---------------------------------------------------------------------------


def _fault_trace(FLT) -> list:
    out = []
    reg = FLT.FaultRegistry([FLT.FaultPlan("compile", nth=2, max_fires=1),
                             FLT.FaultPlan("kernel.dispatch", probability=0.3,
                                           seed=5, max_fires=4)])
    with FLT.scope(reg):
        for _ in range(24):
            out.append((FLT.check("compile") is not None,
                        FLT.check("kernel.dispatch") is not None,
                        FLT.check("shuffle.chunk") is not None))
    out.append((reg.stats(), reg.fires_by_site()))
    plans = FLT.parse_spec(
        "shuffle.chunk:mode=raise,nth=3;compile:prob=0.25,seed=9;"
        "stats.estimate:factor=16,max_fires=0")
    out.append([dataclasses.astuple(p) for p in plans])
    for bad in ("compile:bogus=1", "no.site:nth=1"):
        with pytest.raises(ValueError):
            FLT.parse_spec(bad)
    pol = FLT.RetryPolicy(max_attempts=5, base_delay_s=0.1, backoff=2.0,
                          jitter=0.25, seed=3)
    out.append([pol.delay_s(a) for a in range(0, 6)])
    out.append([FLT.rung_for(e) for e in (
        FLT.FaultError("kernel.dispatch"), FLT.FaultError("shuffle.chunk"),
        FLT.FaultError("compile"), FLT.FaultError("stats.estimate"),
        RuntimeError("x"))])
    out.append((FLT.SITES, FLT.DEFAULT_MODES, str(FLT.FaultError("compile",
                                                                "d"))))
    return out


def _cache_trace(mod, FLT) -> list:
    out = []
    cache = mod.PlanCache(max_entries=3, max_weight=5)
    for i, (key, w) in enumerate([("a", 1), ("b", 2), ("c", 1), ("a", 1),
                                  ("d", 2), ("e", 1), ("b", 1)]):
        if cache.get(key) is None:
            cache.put(key, i, weight=w)
        out.append((cache.stats(), list(cache.keys())))
    out.append((cache.invalidate("e"), cache.invalidate("zz"), cache.stats()))
    reg = FLT.FaultRegistry([FLT.FaultPlan("cache.admission", mode="evict",
                                           nth=1)])
    with FLT.scope(reg):
        out.append((cache.get("b"), cache.stats()))
    cache.clear()
    out.append((cache.get("a"), cache.stats()))
    return out


def test_faults_match_the_reference_call_for_call():
    from repro.core import faults as RF
    from repro_torch.core import faults as TF

    assert _fault_trace(TF) == _fault_trace(RF)
    for a in range(10):
        assert TF._unit(7, "compile", a) == RF._unit(7, "compile", a)


def test_plan_cache_matches_the_reference_call_for_call():
    from repro.core import faults as RF
    from repro.core import plan_cache as RC
    from repro_torch.core import faults as TF
    from repro_torch.core import plan_cache as TC

    assert _cache_trace(TC, TF) == _cache_trace(RC, RF)


def test_first_run_gate_consults_once_a_call_site():
    """Outside a first run the trace-time sites are never consulted; inside
    one, a per-shard site counts one call in every num_shards."""
    from repro_torch.core import faults as FLT

    reg = FLT.FaultRegistry([FLT.FaultPlan("kernel.dispatch", nth=2),
                             FLT.FaultPlan("shuffle.chunk", nth=1)])
    with FLT.scope(reg):
        assert FLT.check_first_run("kernel.dispatch", per_shard=True) is None
        with FLT.first_run(4):
            fired = [FLT.check_first_run("kernel.dispatch", per_shard=True)
                     is not None for _ in range(12)]
            assert FLT.check_first_run("shuffle.chunk") is not None
    assert fired == [False] * 4 + [True] + [False] * 7
    assert reg.stats() == {"fault_calls": 4, "fault_fires": 2}


# ---------------------------------------------------------------------------
# futures and the ladder's edges (the port alone, 8 shards on the CPU)
# ---------------------------------------------------------------------------


def _mini(**kw):
    from repro_torch.core.context import DistContext
    from repro_torch.core.table import Table

    ctx = DistContext(num_shards=P, device="cpu", **kw)
    t = Table.from_numpy({"k": (np.arange(64) % 5).astype(np.int32),
                          "v": (np.arange(64) % 7).astype(np.float32)},
                         device="cpu")
    return ctx, ctx.scatter(t)


def test_failed_future_resolves_once():
    from repro_torch.core.context import PlanFuture

    fut = PlanFuture.failed(ValueError("nope"))
    assert fut.done and fut.ready()
    for _ in range(2):
        with pytest.raises(ValueError):
            fut.result_with_stats()
    calls = []

    def finalize():
        calls.append(1)
        raise RuntimeError("finalize blew up")

    fut = PlanFuture(finalize)
    assert not fut.done and fut.ready()  # nothing in flight on the CPU
    for _ in range(2):
        with pytest.raises(RuntimeError, match="blew up"):
            fut.result()
    assert calls == [1] and fut.done


def test_dispatch_errors_fail_the_future_not_the_context():
    from repro_torch.core import plan as PL

    ctx, dt = _mini()

    def bad(cols):
        raise TypeError("user predicate bug")

    fut = ctx.submit(PL.Select(PL.Scan(0), bad, key=("bad",)), [dt])
    assert fut.done
    with pytest.raises(TypeError):
        fut.result()
    assert ctx.cache_stats()["failed_queries"] == 1
    assert ctx.cache_stats()["entries"] == 0  # nothing broken admitted
    out, _ = ctx.groupby(dt, "k", (("v", "sum"),))
    assert int(out.global_rows()) == 5


def test_drain_and_out_of_order_resolution():
    from repro_torch.core import plan as PL

    ctx, dt = _mini(validate=True)  # validation keeps futures pending
    plans = [PL.Project(PL.Scan(0), ("k",)),
             PL.GroupBy(PL.Scan(0), ("k",), (("v", "sum"),)),
             PL.Sort(PL.Scan(0), ("v",))]
    futs = [ctx.submit(p, [dt]) for p in plans]
    want = [f.result() for f in futs]
    futs = [ctx.submit(p, [dt]) for p in plans]
    got = [f.result() for f in reversed(futs)][::-1]
    for a, b in zip(got, want):
        assert a.to_table().to_rows() == b.to_table().to_rows()
    futs = [ctx.submit(p, [dt]) for p in plans]
    assert ctx.drain() == []
    assert all(f.done for f in futs)
    assert ctx.cache_stats()["misses"] == 3  # every later submit hit


def test_a_real_kernel_error_rides_no_rung(monkeypatch):
    """Only an injected FaultError reaches the plain versions: an error the
    kernel seam raises itself fails the query, with no degradation."""
    from repro_torch.core import faults as FLT
    from repro_torch.kernels import segment_reduce as seg

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(seg, "segment_reduce_tiles", broken)
    for faults in (None, [FLT.FaultPlan("kernel.dispatch", nth=99)]):
        ctx, dt = _mini(faults=faults)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            ctx.groupby(dt, "k", (("v", "sum"),))
        st = ctx.cache_stats()
        assert st["degraded_kernel"] == 0 and st["quarantines"] == 0
        assert st["failed_queries"] == 1 and st["entries"] == 0


def test_a_kernel_writing_nan_fails_validation_with_no_rung(monkeypatch):
    """Validation that finds NaN a kernel wrote itself, with no fault fired,
    fails the query: no quarantine, no re-run on the plain versions."""
    from repro_torch.core import faults as FLT
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as seg

    def nan_writer(values, seg_ids, num_segments, op="sum", **kw):
        if values.is_floating_point():
            return torch.full((num_segments,), float("nan"),
                              dtype=values.dtype, device=values.device)
        return ref.segment_reduce_ref(values, seg_ids, num_segments, op)

    monkeypatch.setattr(seg, "segment_reduce_tiles", nan_writer)
    # validation on by request, and on because a fault that never fires
    # is armed
    for kw in ({"validate": True},
               {"faults": [FLT.FaultPlan("kernel.dispatch", nth=99)]}):
        ctx, dt = _mini(**kw)
        with pytest.raises(RuntimeError, match="failed validation: NaN"):
            ctx.groupby(dt, "k", (("v", "sum"),))
        st = ctx.cache_stats()
        assert st["degraded_kernel"] == 0 and st["quarantines"] == 0
        assert st["failed_queries"] == 1 and st["fault_fires"] == 0


def test_explain_recovery_annotations():
    ctx, dt = _mini()
    fr = ctx.frame(dt).groupby("k", (("v", "sum"),), strategy="shuffle")
    plain, annotated = fr.explain(), fr.explain(recovery=True)
    assert "recovery=" not in plain
    assert "recovery=mono-alltoall+oracle-kernel" in annotated
    assert fr.explain(verify=True).endswith("verification: clean")


if __name__ == "__main__":
    reference_main(sys.argv[1])
