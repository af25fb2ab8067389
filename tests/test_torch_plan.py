"""The plan layer as a whole: repro_torch's LazyFrame, optimizer, cost model,
explain, plan_report and collect on 8 virtual shards against repro's on 8
host devices.

One subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
in tests/test_torch_dist.py) runs every case on the reference and pickles
what it saw; the port runs the same frames on the CPU. Each case is a frame
built by the same code on both sides, once over plain tables and once over
analyzed ones (the port's ``ctx.analyze``; on the reference the stats of
``repro.core.stats.analyze_table`` on the gathered table with
``max_shard_rows`` the largest shard's count, put on the table with
``dataclasses.replace``: the reference's ``DistContext.analyze`` raises on
the installed jax). Tolerance: none. For every case these must be equal:
the optimized plan (every field of every node but the predicate), the
``explain()`` text of the optimized and of the logical plan, the
``plan_report`` records, and ``collect()``'s rows (every shard's valid
rows, bitwise and in order), per-shard counts, shuffle stats, output
placement and output stats. The port's ``plan_report`` must also equal the
records its own run appended. Inputs: seeded numpy tables of 8 x 256 rows
with integer-valued floats.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 8
CAP = 256
AGGS = {"v": ["sum", "count", "min", "max", "mean", "first"], "w": ["max"]}
WIN = ["rank", "dense_rank", ("lag", "d0"), ("lead", "d1", 2),
       ("cumsum", "d1"), ("cummax", "d0"), ("running_mean", "d0")]
# a module-level value a keyless predicate reads (identity keys hold it)
THRESHOLD = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs() -> dict[str, list[tuple[dict, int]]]:
    """Per-shard (columns, valid rows) of each input table; garbage rows
    past the count on purpose."""
    out = {}
    order = np.random.default_rng(77).permutation(P * CAP).astype(np.int32)
    for ti, name in enumerate(("a", "b", "s1", "s2", "c")):
        parts = []
        for i in range(P):
            r = np.random.default_rng([17, ti, i])
            if name in ("a", "b"):
                cols = {"k": r.integers(0, 300, CAP).astype(np.int32),
                        "v": r.integers(-40, 40, CAP).astype(np.float32),
                        "w": r.integers(0, 5, CAP).astype(np.int32)}
            elif name == "c":
                cols = {"k": r.integers(0, 3, CAP).astype(np.int32),
                        "o": order[i * CAP:(i + 1) * CAP],
                        "d0": r.integers(-50, 50, CAP).astype(np.float32),
                        "d1": r.integers(-9, 9, CAP).astype(np.int32)}
            else:
                cols = {"x": r.integers(0, 6, CAP).astype(np.int32),
                        "y": r.integers(0, 4, CAP).astype(np.float32)}
            parts.append((cols, 200 + 7 * i))
        out[name] = parts
    return out


def unprobeable(c):
    """Reads its column by iterating the dict: the probe records nothing,
    so the Select stays where it is."""
    col = next(iter(c.values()))
    return col == col


def above(t):
    return lambda c: c["v"] > t


# name -> build(ctx, T) -> frame; T holds the inputs plus two eager
# results with placement tags ("a_sorted": range on k, "b_part": hash on k)
CASES = {
    "select_into_join_left": lambda ctx, T: ctx.frame(T["a"]).join(
        ctx.frame(T["b"]), on="k").select(lambda c: c["v"] > 0, key="v>0"),
    "select_into_join_right": lambda ctx, T: ctx.frame(T["a"]).project(
        ["k", "v"]).join(ctx.frame(T["b"]).project(["k", "w"]), on="k"
                         ).select(lambda c: c["w"] > 2, key="w>2"),
    "select_kept_above_left_join": lambda ctx, T: ctx.frame(T["a"]).project(
        ["k", "v"]).join(ctx.frame(T["b"]).project(["k", "w"]), on="k",
                         how="left").select(lambda c: c["w"] > 1),
    "select_below_sort": lambda ctx, T: ctx.frame(T["a"]).sort("k").select(
        lambda c: c["w"] < 3, key="w<3"),
    "select_unprobeable": lambda ctx, T: ctx.frame(T["a"]).join(
        ctx.frame(T["b"]), on="k").select(unprobeable),
    "limit_below_project": lambda ctx, T: ctx.frame(T["a"]).project(
        ["k", "v"]).limit(1000),
    "limit_after_sort": lambda ctx, T: ctx.frame(T["a"]).sort("k").limit(50),
    "join_then_groupby": lambda ctx, T: ctx.frame(T["a"]).join(
        ctx.frame(T["b"]), on="k").groupby("k", {"v": "sum", "w_r": "max"}),
    "pipeline": lambda ctx, T: ctx.frame(T["a"]).select(
        lambda c: c["v"] > 0, key="v>0").join(ctx.frame(T["b"]), on="k"
                                               ).groupby("k", AGGS),
    "groupby_auto": lambda ctx, T: ctx.frame(T["b"]).groupby("k", AGGS),
    "groupby_two_keys": lambda ctx, T: ctx.frame(T["a"]).groupby(
        ["k", "w"], {"v": ["sum", "min"]}),
    "groupby_shuffle_staged": lambda ctx, T: ctx.frame(T["a"]).groupby(
        "k", AGGS, strategy="shuffle", stages=3),
    "groupby_two_phase_ring": lambda ctx, T: ctx.frame(T["a"]).groupby(
        "w", AGGS, strategy="two_phase", shuffle_mode="ring"),
    "sort_then_groupby": lambda ctx, T: ctx.frame(T["a"]).sort("k").groupby(
        "k", AGGS),
    "sort_then_join_aligns": lambda ctx, T: ctx.frame(T["a"]).sort("k").join(
        ctx.frame(T["b"]), on="k"),
    "sorted_input_groupby": lambda ctx, T: ctx.frame(T["a_sorted"]).groupby(
        "k", {"v": "sum"}),
    "partitioned_input_join": lambda ctx, T: ctx.frame(T["b_part"]).join(
        ctx.frame(T["a"]), on="k"),
    "repartition_twice": lambda ctx, T: ctx.frame(T["a"]).partition_by(
        "k").partition_by("k").project(["k", "w"]),
    "join_full_hash": lambda ctx, T: ctx.frame(T["a"]).join(
        ctx.frame(T["b"]), on="k", how="full", algorithm="hash"),
    "self_join": lambda ctx, T: (lambda f: f.join(f.select(
        lambda c: c["w"] == 1, key="w1"), on="k"))(ctx.frame(T["a"])),
    "window_after_sort": lambda ctx, T: ctx.frame(T["c"]).sort(
        ["k", "o"]).window("k", WIN, order_by="o"),
    "window": lambda ctx, T: ctx.frame(T["c"]).window("k", WIN, order_by="o"),
    # explicit capacities, whose output sizes the next shuffle's bucket
    "groupby_capacities_then_sort": lambda ctx, T: ctx.frame(T["a"]).groupby(
        "w", AGGS, strategy="two_phase", bucket_capacity=40,
        partial_capacity=16, out_capacity=8).sort("w"),
    "join_capacities_then_distinct": lambda ctx, T: ctx.frame(T["s1"]).join(
        ctx.frame(T["s2"]), on="x", algorithm="hash", bucket_capacity=300,
        out_capacity=700).distinct(),
    "limit_then_groupby": lambda ctx, T: ctx.frame(T["a"]).limit(100).groupby(
        "k", {"v": "sum"}, strategy="shuffle"),
    "union_distinct": lambda ctx, T: ctx.frame(T["s1"]).union(
        ctx.frame(T["s2"])).distinct(),
    "intersect": lambda ctx, T: ctx.frame(T["s1"]).intersect(
        ctx.frame(T["s2"])),
    "difference_left": lambda ctx, T: ctx.frame(T["s1"]).partition_by(
        ["x", "y"]).difference(ctx.frame(T["s2"]), mode="left"),
}

# frames whose canonical_key / identity_key equality classes must match:
# equal keys and code, one key two codes, keyless equal code, closures over
# different values, a captured array (unkeyable), a module global
KEY_FRAMES = [
    lambda ctx, T, arr: ctx.frame(T["a"]).select(lambda c: c["v"] > 0,
                                                 key="pos"),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(lambda c: c["v"] > 0,
                                                 key="pos"),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(lambda c: c["v"] > 1,
                                                 key="pos"),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(above(3)),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(above(3)),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(above(4)),
    lambda ctx, T, arr: (lambda lim: ctx.frame(T["a"]).select(
        lambda c: c["w"] < lim[0]))(arr([3])),
    lambda ctx, T, arr: ctx.frame(T["a"]).select(
        lambda c: c["w"] < THRESHOLD),
    lambda ctx, T, arr: ctx.frame(T["a"]).groupby("k", {"v": "sum"}),
    lambda ctx, T, arr: ctx.frame(T["a"]).groupby("k", {"v": "sum"}),
    lambda ctx, T, arr: ctx.frame(T["a"]).groupby("k", {"v": "max"}),
    lambda ctx, T, arr: ctx.frame(T["a"]).groupby("k", {"v": "sum"},
                                                  stages=1),
]


def understated(mod, n_keys: int = 2):
    """TableStats that claim 16 rows over 2 keys: every cost-sized bucket
    built from them overflows on the real 200-249 rows a shard."""
    return mod.TableStats(rows=16.0, columns=(
        ("k", mod.ColumnStats(float(n_keys), 0.0, 299.0)),), max_shard_rows=2.0)


OVERFLOW = lambda ctx, T: ctx.frame(T["a_bad"]).groupby(  # noqa: E731
    "k", {"v": "sum"}, strategy="shuffle")


def shape(obj):
    """A plan (or placement tag) as nested plain tuples: every dataclass
    field but the predicate; a materialized table's range fingerprint
    (a process-local counter) as ("table",)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        vals = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "predicate":
                continue
            if f.name == "fingerprint" and isinstance(v, tuple) and v \
                    and v[0] == "table":
                v = ("table",)
            vals.append((f.name, shape(v)))
        return (name, tuple(vals))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return (type(obj).__name__,) + tuple(shape(x) for x in obj)
    if isinstance(obj, (tuple, list)):
        return tuple(shape(x) for x in obj)
    return obj


def _rows(out, stats) -> dict:
    if hasattr(out, "to_numpy"):  # the port's (p, C) layout
        cols, rc = out.to_numpy()
    else:
        cols = {k: np.asarray(v) for k, v in out.columns.items()}
        rc = np.asarray(out.row_counts)
    return {"rc": np.asarray(rc), "cols": cols,
            "stats": [(np.asarray(s.overflow), np.asarray(s.received))
                      for s in stats],
            "part": shape(out.partitioning), "out_stats": repr(out.stats)}


def run_case(ctx, T, build) -> dict:
    frame = build(ctx, T)
    res = {"plan": shape(frame.optimized()), "explain": frame.explain(),
           "explain_logical": frame.explain(optimize=False),
           "report": frame.plan_report()}
    before = ctx.overflow_retries
    out, stats = frame.collect_with_stats()
    res.update(_rows(out, stats), retries=ctx.overflow_retries - before)
    return res


def key_classes(ctx, T, arr) -> list:
    """Pairwise equality of the frames' logical canonical and identity keys
    (None = uncacheable) as comparable plain data."""
    plans = [f(ctx, T, arr).logical_plan() for f in KEY_FRAMES]
    out = []
    for fn in ("canonical_key", "identity_key"):
        mod = sys.modules[type(plans[0]).__module__]
        keys = [getattr(mod, fn)(p) for p in plans]
        out.append([[None if a is None else a == b for b in keys]
                    for a in keys])
    return out


def tables(ctx, make, analyze) -> tuple[dict, dict]:
    """(plain, analyzed) input tables, with the two tagged eager results."""
    plain = {n: make(n) for n in ("a", "b", "s1", "s2", "c")}
    plain["a_sorted"] = ctx.sort(plain["a"], "k")[0]
    plain["b_part"] = ctx.partition_by(plain["b"], "k")[0]
    return plain, {n: analyze(t) for n, t in plain.items()}


def reference_main(out_path: str) -> None:
    """Run every case on the reference (8 host devices) into ``out_path``."""
    import jax.numpy as jnp

    from repro.core import stats as RS
    from repro.core.context import DistContext
    from repro.core.table import Table

    data = inputs()
    ctx = DistContext()

    def make(name):
        return ctx.from_local_parts([
            Table({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(n, jnp.int32)) for cols, n in data[name]])

    def analyze(t):
        st = RS.analyze_table(t.to_table())
        st = dataclasses.replace(
            st, max_shard_rows=float(np.asarray(t.row_counts).max()))
        return dataclasses.replace(t, stats=st)

    plain, analyzed = tables(ctx, make, analyze)
    res = {}
    for case, build in CASES.items():
        res[case] = {"plain": run_case(ctx, plain, build),
                     "stats": run_case(ctx, analyzed, build)}
    res["keys"] = key_classes(ctx, plain, np.asarray)
    bad = dict(plain, a_bad=dataclasses.replace(plain["a"],
                                                stats=understated(RS)))
    res["overflow"] = run_case(ctx, bad, OVERFLOW)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, \
        f"reference run failed:\n{proc.stdout}\n{proc.stderr}"
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    """The port's context and its (plain, analyzed) tables."""
    from repro_torch.core.context import DistContext
    from repro_torch.core.table import Table

    data = inputs()
    ctx = DistContext(num_shards=P, device="cpu")

    def make(name):
        return ctx.from_local_parts([
            Table.from_numpy(cols, row_count=n, device="cpu")
            for cols, n in data[name]])

    return (ctx,) + tables(ctx, make, ctx.analyze)


def assert_same_run(got: dict, want: dict, what: str) -> None:
    """Equal rows (every shard's valid rows, bitwise, in order), per-shard
    counts, shuffle stats, placement and output stats."""
    np.testing.assert_array_equal(got["rc"], want["rc"], err_msg=what)
    assert len(got["stats"]) == len(want["stats"]), what
    for (go, gr), (wo, wr) in zip(got["stats"], want["stats"]):
        np.testing.assert_array_equal(go, wo, err_msg=what)
        np.testing.assert_array_equal(gr, wr, err_msg=what)
    assert got["part"] == want["part"], what
    assert got["out_stats"] == want["out_stats"], what
    assert sorted(got["cols"]) == sorted(want["cols"]), what
    counts = want["rc"]
    for k, w in want["cols"].items():
        g = got["cols"][k]
        assert g.dtype == w.dtype, (what, k)
        g = g.reshape((P, -1) + g.shape[1:])
        w = w.reshape((P, -1) + w.shape[1:])
        for i in range(P):
            a, b = g[i, :counts[i]], w[i, :counts[i]]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k} shard {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_reference(reference, port, case):
    ctx, plain, analyzed = port
    for variant, T in (("plain", plain), ("stats", analyzed)):
        what = f"{case}/{variant}"
        want = reference[case][variant]
        frame = CASES[case](ctx, T)
        assert shape(frame.optimized()) == want["plan"], what
        assert frame.explain() == want["explain"], what
        assert frame.explain(optimize=False) == want["explain_logical"], what
        static = frame.plan_report()
        assert static == want["report"], what
        executed = []
        before = ctx.overflow_retries
        out, stats = frame.collect_with_stats(report=executed)
        assert executed == static, what
        assert ctx.overflow_retries - before == want["retries"], what
        assert_same_run(_rows(out, stats), want, what)


def test_cost_model_changes_the_plan(reference):
    """The analyzed variants really are cost-sized: auto groupby on the
    join table (300 keys over 1796 rows: p * NDV > rows) picks shuffle with
    stats and two_phase without, and buckets are marked cost-sized."""
    assert "strategy=shuffle" in reference["groupby_auto"]["stats"]["explain"]
    assert "strategy=two_phase" in reference["groupby_auto"]["plain"]["explain"]
    assert "cost-sized" in reference["pipeline"]["stats"]["explain"]
    assert "cost-sized" not in reference["pipeline"]["plain"]["explain"]
    assert "~rows=" in reference["pipeline"]["stats"]["explain"]


def test_elision_is_seen(reference):
    plain = {c: reference[c]["plain"]["report"] for c in CASES}
    assert [r["elided"] for r in plain["sort_then_groupby"]] == [False, True]
    assert [r["elided"] for r in plain["partitioned_input_join"]] == \
        [True, False]
    assert [r["elided"] for r in plain["repartition_twice"]] == [False, True]
    assert "align=left('k',)" in \
        reference["sort_then_join_aligns"]["plain"]["explain"]


def test_key_classes_match_reference(reference, port):
    ctx, plain, _ = port
    got = key_classes(ctx, plain, lambda x: torch.tensor(x))
    assert got == reference["keys"]
    canonical, identity = got
    assert canonical[0][1] and not canonical[0][2]  # one key, two codes
    assert canonical[3][3] is None and identity[3][4] and not identity[3][5]
    assert identity[6][6] is None  # a captured tensor is never keyed
    assert identity[7][7] is True


def test_overflow_reruns_once_at_safe_capacity(reference, port):
    from repro_torch.core import stats as PS

    ctx, plain, _ = port
    bad = dict(plain, a_bad=dataclasses.replace(plain["a"],
                                                stats=understated(PS)))
    got = run_case(ctx, bad, OVERFLOW)
    want = reference["overflow"]
    assert got["retries"] == want["retries"] == 1
    assert got["plan"] == want["plan"] and got["explain"] == want["explain"]
    assert got["report"] == want["report"]
    assert_same_run(got, want, "overflow")
    assert got["out_stats"] == "None"  # failed estimates are not propagated
    # the rows are those of the run without stats
    frame = OVERFLOW(ctx, dict(plain, a_bad=plain["a"]))
    out, stats = frame.collect_with_stats()
    plain_run = _rows(out, stats)
    np.testing.assert_array_equal(got["rc"], plain_run["rc"])
    for k, v in plain_run["cols"].items():
        g = got["cols"][k].reshape(P, -1)
        w = v.reshape(P, -1)
        for i in range(P):
            np.testing.assert_array_equal(g[i, :got["rc"][i]],
                                          w[i, :got["rc"][i]])


def test_verify_true_runs_the_verifier(port):
    """verify=True runs the verifier (tests/test_torch_verify.py) over the
    (logical, optimized) pair and returns the same plan as verify=False."""
    from repro_torch.core import plan as PL
    from repro_torch.core import verify as V

    ctx, plain, _ = port
    frame = ctx.frame(plain["a"]).groupby("k", {"v": "sum"})
    runs = V.counter_snapshot()["verify_runs"]
    assert PL.optimize(frame.logical_plan(), [plain["a"].schema], P,
                       verify=True) == frame.optimized()
    assert V.counter_snapshot()["verify_runs"] > runs
    assert PL.optimize(frame.logical_plan(), [plain["a"].schema], P,
                       verify=False) == frame.optimized()


if __name__ == "__main__":
    reference_main(sys.argv[1])
