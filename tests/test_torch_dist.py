"""The slice as a whole: repro_torch's eager DistContext on 8 virtual shards
against repro's eager DistContext on 8 host devices.

One subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the
pattern of tests/test_dist.py) runs every reference case and writes its
results to an ``.npz``; the port runs the same calls on the CPU. Inputs are
seeded numpy tables of 8 x 512 rows with integer-valued floats. Tolerance:
none. Each case must agree on every shard's rows (bitwise, in order), the
per-shard row counts, every shuffle's per-shard overflow and received rows,
and the ``report`` records (bucket, bytes per row, wire bytes, stages).

The same subprocess also runs the relational token pipeline
(``repro.data.pipeline``, ``PIPELINE``) on an 8-device context; the port's
pipeline on 8 virtual shards must give the same batches, tokens and
weights bit for bit and in order, and the same ``last_stats`` (counts,
minima, maxima exact; means and variances within the summation-order
bound stated in tests/test_torch_pipeline.py).

One stated exception: a variance may differ by the rounding of
``mean*mean``, at most 2**-21 * (mean**2 + var). Inside the reference's
jitted shard_map program XLA contracts ``sumsq/n - mean*mean`` into one
fused multiply-add; the port, like the reference run eagerly (see
tests/test_torch_groupby.py, bitwise there), rounds the product first.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 8
CAP = 512
AGGS = {"v": ["sum", "count", "min", "max", "mean", "var", "first"],
        "w": ["max"]}
# window functions over `a` (v float32, w int32) and over `c` (d0 float32,
# d1 int32); the offsets 700 and 900 reach past the ~512 rows a shard holds
WIN_A = ["rank", "dense_rank", "row_number", ("lag", "v"), ("lead", "v", 2),
         ("cumsum", "v"), ("cumsum", "w"), ("cummax", "v"),
         ("running_mean", "v")]
WIN_C = ["rank", "dense_rank", "row_number", ("lag", "d0"), ("lead", "d0"),
         ("lag", "d1", 3), ("lead", "d1", 2), ("lag", "d0", 700),
         ("lead", "d1", 900), ("cumsum", "d0"), ("cumsum", "d1"),
         ("cummax", "d0"), ("cummax", "d1"), ("running_mean", "d0")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the pipeline at 8 shards: ~10 sample rows a shard a round, two refills a
# batch at this threshold, two batches
PIPELINE = dict(seq_len=16, global_batch=48, vocab_size=300,
                quality_threshold=0.4, collect_stats=True, seed=6)
PIPELINE_STEPS = (0, 3)

# name -> (method, input tables, positional args, keyword args)
CASES = {
    "join_sort": ("join", ("a", "b"), ("k",), {"algorithm": "sort"}),
    "join_hash_full": ("join", ("a", "b"), ("k",),
                       {"algorithm": "hash", "how": "full"}),
    "groupby_two_phase": ("groupby", ("a",), ("k", AGGS),
                          {"strategy": "two_phase"}),
    "groupby_shuffle": ("groupby", ("a",), ("k", AGGS), {"strategy": "shuffle"}),
    "sort": ("sort", ("a",), ("k",), {}),
    "union": ("union", ("s1", "s2"), (), {}),
    "intersect": ("intersect", ("s1", "s2"), (), {}),
    "difference": ("difference", ("s1", "s2"), (), {}),
    "repartition_s1": ("partition_by", ("a",), ("k",), {"stages": 1}),
    "repartition_s3": ("partition_by", ("a",), ("k",), {"stages": 3}),
    "repartition_ring": ("partition_by", ("a",), ("k",), {"shuffle_mode": "ring"}),
    # ties on (k, w), many groups
    "window_ties": ("window", ("a",), ("k", WIN_A), {"order_by": "w"}),
    # 3 groups, unique order: groups span shards, whole shards are one group
    "window_spanning": ("window", ("c",), ("k", WIN_C), {"order_by": "o"}),
    "window_ring": ("window", ("c",), ("k", WIN_C),
                    {"order_by": "o", "shuffle_mode": "ring"}),
}


def inputs() -> dict[str, list[tuple[dict, int]]]:
    """Per-shard (columns, valid rows) for each input table; garbage rows
    past the count on purpose."""
    out = {}
    order = np.random.default_rng(99).permutation(P * CAP).astype(np.int32)
    for ti, name in enumerate(("a", "b", "s1", "s2", "c")):
        parts = []
        for i in range(P):
            r = np.random.default_rng([ti, i])
            if name in ("a", "b"):
                cols = {"k": r.integers(0, 600, CAP).astype(np.int32),
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
            parts.append((cols, 400 + 13 * i))
        out[name] = parts
    return out


def _flatten(out, stats, report) -> tuple[dict, list]:
    arrays = {"rc": np.asarray(out.row_counts)}
    cols, _ = (out.to_numpy() if hasattr(out, "shards") else
               ({k: np.asarray(v) for k, v in out.columns.items()}, None))
    for k, v in cols.items():
        arrays[f"col/{k}"] = np.asarray(v)
    for i, s in enumerate(stats):
        arrays[f"st{i}/overflow"] = np.asarray(s.overflow)
        arrays[f"st{i}/received"] = np.asarray(s.received)
    return arrays, report


def _run(ctx, make_table, case):
    method, tabs, pos, kw = CASES[case]
    tables = [make_table(t) for t in tabs]
    report = []
    res = getattr(ctx, method)(*tables, *pos, report=report, **kw)
    out, stats = res if isinstance(res, tuple) else (res, ())
    return _flatten(out, stats, report)


def reference_main(out_path: str) -> None:
    """Run every case on the reference (8 host devices) into ``out_path``."""
    import jax.numpy as jnp

    from repro.core.context import DistContext
    from repro.core.table import Table

    data = inputs()
    arrays, reports = {}, {}
    for case in CASES:
        ctx = DistContext()  # fresh: the report fills at trace time

        def make(name, ctx=ctx):
            return ctx.from_local_parts([
                Table({k: jnp.asarray(v) for k, v in cols.items()},
                      jnp.asarray(n, jnp.int32)) for cols, n in data[name]])

        a, rep = _run(ctx, make, case)
        arrays.update({f"{case}/{k}": v for k, v in a.items()})
        reports[case] = rep
    arrays.update(_pipeline_batches(DistContext(), "repro"))
    np.savez(out_path, **arrays)
    with open(out_path + ".json", "w") as f:
        json.dump(reports, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"reference run failed:\n{proc.stdout}\n{proc.stderr}"
    with np.load(path) as z:
        arrays = dict(z)
    with open(path + ".json") as f:
        reports = json.load(f)
    return arrays, reports


def _pipeline_batches(ctx, package: str) -> dict[str, np.ndarray]:
    """``PIPELINE``'s batches and stats at ``PIPELINE_STEPS`` on ``ctx``,
    through ``package``'s pipeline (``repro`` or ``repro_torch``)."""
    import importlib

    mod = importlib.import_module(f"{package}.data.pipeline")
    pipe = mod.RelationalTokenPipeline(mod.PipelineConfig(**PIPELINE), ctx)
    out = {}
    for step in PIPELINE_STEPS:
        for k, v in pipe.global_batch(step).items():
            out[f"pipeline/{step}/{k}"] = v
        for k, v in pipe.last_stats.items():
            out[f"pipeline/{step}/stats/{k}"] = v
    return out


def _port_case(case):
    from repro_torch.core.context import DistContext
    from repro_torch.core.table import Table

    data = inputs()
    ctx = DistContext(num_shards=P, device="cpu")

    def make(name):
        return ctx.from_local_parts([
            Table.from_numpy(cols, row_count=n, device="cpu")
            for cols, n in data[name]])

    return _run(ctx, make, case)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference(reference, case):
    from repro.testing.compare import tables_bitwise_equal
    from repro_torch.core.context import DistTable

    ref_arrays, ref_reports = reference
    want = {k[len(case) + 1:]: v for k, v in ref_arrays.items()
            if k.startswith(case + "/")}
    got, report = _port_case(case)
    assert report == ref_reports[case]
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["rc"], want["rc"])
    for key in want:
        if key.startswith("st"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # every shard's valid rows, bitwise and in order
    counts = want["rc"]
    for key in want:
        if not key.startswith("col/"):
            continue
        g = got[key].reshape((P, -1) + got[key].shape[1:])
        w = want[key].reshape((P, -1) + want[key].shape[1:])
        assert g.dtype == w.dtype, key
        for i in range(P):
            a, b = g[i, :counts[i]], w[i, :counts[i]]
            if key.endswith("_var"):  # the fused multiply-add, see above
                m = want[key[:-4] + "_mean"].reshape(P, -1)[i, :counts[i]]
                bound = 2.0 ** -21 * (m.astype(np.float64) ** 2 + b)
                assert (np.abs(a.astype(np.float64) - b) <= bound).all(), key
                continue
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} shard {i}")
    if any(k.endswith("_var") for k in want):
        return  # the multiset check below is bitwise
    cols = {k[4:]: v for k, v in want.items() if k.startswith("col/")}
    ref_table = DistTable.from_numpy(cols, want["rc"], P, device="cpu")
    port_cols = {k[4:]: v for k, v in got.items() if k.startswith("col/")}
    port_table = DistTable.from_numpy(port_cols, got["rc"], P, device="cpu")
    assert tables_bitwise_equal(ref_table, port_table)


def test_pipeline_at_8_shards_matches_reference_in_order(reference):
    from repro_torch.core.context import DistContext

    want = {k: v for k, v in reference[0].items() if k.startswith("pipeline/")}
    got = _pipeline_batches(DistContext(num_shards=P, device="cpu"),
                            "repro_torch")
    assert sorted(got) == sorted(want) and want
    u = 2.0 ** -24
    for step in PIPELINE_STEPS:
        w = {k.split("/", 2)[2]: v for k, v in want.items()
             if k.startswith(f"pipeline/{step}/")}
        g = {k: got[f"pipeline/{step}/{k}"] for k in w}
        n = w["stats/quality_count"].astype(np.float64)
        mean = w["stats/quality_mean"].astype(np.float64)
        var = w["stats/quality_var"].astype(np.float64)
        bounds = {"stats/quality_mean": u * (2 * n + 2) * mean,
                  "stats/quality_var": u * (6 * n + 4) * (mean ** 2 + var)}
        for k, v in w.items():
            assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
            if k in bounds:
                assert (np.abs(g[k].astype(np.float64) - v) <= bounds[k]).all(), k
            else:
                np.testing.assert_array_equal(g[k].view(np.int32),
                                              v.view(np.int32), err_msg=k)
    assert len({tuple(r) for r in got["pipeline/0/tokens"].tolist()}) == \
        PIPELINE["global_batch"]


def test_groupby_auto_is_two_phase_without_stats():
    from repro_torch.core.context import DistContext
    from repro_torch.core.table import Table

    ctx = DistContext(num_shards=P, device="cpu")
    t = ctx.from_local_parts([Table.from_numpy(cols, row_count=n, device="cpu")
                              for cols, n in inputs()["b"]])
    (auto, st_a), (two, st_t) = (ctx.groupby(t, ["k", "w"], AGGS, strategy=s)
                                 for s in ("auto", "two_phase"))
    assert auto.partitioning == two.partitioning
    for k in two.columns:
        assert torch.equal(auto.columns[k], two.columns[k]), k
    assert torch.equal(st_a[0].received, st_t[0].received)


def test_virtual_mesh_collectives():
    from repro_torch.core.mesh import VirtualMesh
    from repro_torch.core.repartition import staged_all_to_all

    mesh = VirtualMesh(4)
    buf = torch.arange(4 * 4 * 5).reshape(4, 4, 5)
    recv = mesh.all_to_all(buf)
    assert torch.equal(recv[2, 1], buf[1, 2])  # shard 2 gets what 1 sent it
    for kw in ({"stages": 2}, {"stages": 9}, {"shuffle_mode": "ring"}):
        assert torch.equal(staged_all_to_all(buf, mesh, **kw), recv)
    x = torch.arange(4) * 10
    assert torch.equal(mesh.ppermute(x, [(0, 1), (1, 2)]), torch.tensor([0, 0, 10, 0]))
    assert torch.equal(mesh.all_gather(x), x)
    assert mesh.counts == {"all_to_all": 1 + 2 + 5, "ppermute": 1 + 3,
                           "all_gather": 1}
    with pytest.raises(ValueError):
        mesh.all_to_all(torch.zeros(3, 4, 1))


def test_dist_table_numpy_roundtrip_and_limit():
    from repro_torch.core.context import DistContext, DistTable

    cols = {"k": np.arange(24, dtype=np.int32), "v": np.ones((24, 2), np.float32)}
    dt = DistTable.from_numpy(cols, [3, 0, 6, 1], 4, device="cpu")
    assert dt.columns["v"].shape == (4, 6, 2) and dt.local_capacity == 6
    back, rc = dt.to_numpy()
    np.testing.assert_array_equal(back["k"], cols["k"])
    np.testing.assert_array_equal(rc, [3, 0, 6, 1])
    np.testing.assert_array_equal(dt.to_table().to_numpy()["k"],
                                  [0, 1, 2, 12, 13, 14, 15, 16, 17, 18])
    out = DistContext(num_shards=4, device="cpu").limit(dt, 5)
    assert out.row_counts.tolist() == [3, 0, 2, 0]


def _chip_smoke():
    return subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_chip_smoke_cpu_rehearsal_drives_the_main_path(monkeypatch):
    """chip_smoke.py's main-path calls and its comparison of a run against
    the ``oracle_scope()`` run, at 8 x 1024 rows on the CPU (plain versions
    on both sides, so equal bit for bit). The window's output is also held
    against the one-host window of all rows. Then phase 11 (statistics and
    the lazy plan) on the same tables, each wrapper's call counted as its
    launch, its safe-capacity re-run at 8 x 256 rows, and phases 12-13
    (the verifier on phase 11's frames, the serving open loop, the fault
    cases) at 8 x 1024 rows."""
    import importlib.util

    from repro_torch.core.context import DistContext
    from repro_torch.kernels import ops as kops
    from repro_torch.testing import chaos_cases

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = torch.device("cpu")
    ctx = DistContext(num_shards=P, device=cpu)
    tabs = smoke.make_tables(ctx, 1024, cpu)
    names = []
    for name, call in smoke.main_path_calls(ctx, *tabs):
        got = smoke.summarize(*call())
        with kops.oracle_scope():
            want = smoke.summarize(*call())
        assert smoke.compare_results(name, got, want) == 0.0
        assert sum(got["row_counts"]) > 0
        if name == "window":
            _window_matches_one_host(smoke, tabs[3], got)
        names.append(name)
    assert names == ["join_sort", "join_hash", "groupby_two_phase",
                     "groupby_shuffle", "sort", "window"]
    with pytest.raises(smoke.CheckFailed):
        bad = dict(got, row_counts=got["row_counts"][::-1] + [1])
        smoke.compare_results("sort", bad, want)
    with pytest.raises(smoke.CheckFailed):  # one row's value off
        rows = dict(got["rows"], d0_cumsum=got["rows"]["d0_cumsum"].clone())
        rows["d0_cumsum"][7] += 1
        smoke.compare_results("window", dict(got, rows=rows), got)

    _counted_launches(monkeypatch, smoke)
    # phase 5's second half: submit against the route straight into
    # execute_plan, the same rows from both
    route = smoke.phase_submit_route(ctx, tabs, rounds=1)
    assert list(route) == names
    assert all(r["samples"] == 2 for r in route.values())
    assert "_run_plan" not in vars(ctx)  # the capture was undone
    plan = smoke.phase_plan(ctx, tabs, cpu, 256)
    assert plan["analyze"]["launches"]["hash32_partition"] == 16
    assert plan["groupby_with_stats"]["strategy"] == "shuffle"
    assert plan["groupby_without_stats"]["strategy"] == "two_phase"
    assert {k: v["elided"] for k, v in plan["elided"].items()} == \
        {"sorted_groupby": 1, "partitioned_join": 1}
    assert plan["safe_rerun"]["overflow_retries"] == 1
    assert "cost-sized" in plan["explain"]
    summary = smoke.plan_summary(plan, 1024)
    json.dumps(summary)
    # analyzed shuffles are sized from the stats, not the table capacity
    sized = summary["buckets"]["groupby_cost_sized"][0]["bucket"]
    assert sized < summary["buckets"]["groupby_no_stats"][0]["bucket"]

    # phases 12-13: the verifier on phase 11's frames, the serving open
    # loop and the fault cases, at 8 x 1024 rows
    verified = smoke.phase_verify(ctx, tabs, plan["analyzed"])
    assert verified["audit"]["expected"] == verified["audit"]["actual"]
    serving = smoke.phase_serving(DistContext(num_shards=P, device=cpu), cpu,
                                  1024)
    assert serving["warm_async"]["compiles"] == 0
    assert serving["cold_sequential"]["compiles"] == \
        4 + serving["cold_sequential"]["overflow_retries"]
    assert all(serving[m]["launches"]["segment_reduce_tiles"] > 0
               for m, _ in smoke.SERVE_MODES)
    assert sorted(serving["submit_host_syncs"]) == ["gb", "join", "sel",
                                                    "topn"]
    faults = smoke.phase_faults(cpu, 1024)
    assert faults["kernel_recovery"]["raise_rung"] == 1
    assert faults["stats_overflow_recovery"]["overflow_retries"] == 1
    assert faults["real_kernel_nan"]["quarantines"] == 0
    bad = dict(faults["kernel_recovery"], nan_identical=False)
    assert not chaos_cases.checks({"kernel_recovery": bad})[
        "kernel_recovery: nan identical"]
    json.dumps({"serving": {**serving, "faults": faults,
                            "verify": verified}})
    with pytest.raises(smoke.CheckFailed, match="differs"):
        bad = dict(plan["analyzed"][0].columns)
        smoke.same_rows("x", plan["analyzed"][0], dataclasses.replace(
            plan["analyzed"][0], columns={**bad, "d0": bad["d0"] + 1}))


def test_chip_smoke_cpu_rehearsal_drives_the_pipeline_and_harnesses(
        monkeypatch):
    """chip_smoke.py's phases 14 and 15 on the CPU, each wrapper's call
    counted as its launch: the pipeline at 1 and 8 shards at a small width
    (its host oracles, the plain run, no plan prepared after step 0, the
    kernels of ``PIPE_KERNELS`` launched), then the plan fuzzer over a few
    plans and every dist case against its checks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _counted_launches(monkeypatch, smoke)
    cpu = torch.device("cpu")
    for shards in (1, P):
        r = smoke.phase_pipeline(cpu, shards, seq_len=64, batch=32, steps=3)
        assert r["plans_prepared"] == 1 and r["plans_prepared_after_step_0"] == 0
        assert r["rounds_per_batch"] >= 1 and r["read_back_bytes"] > 0
        assert (r["launches"]["hash32_partition"] > 0) == (shards > 1)
        json.dumps(r)
    cfg = smoke.pipeline_config(16, 8)
    pipe_oracle = smoke.pipeline_oracle(cfg, 13, 0)
    batch = {"tokens": np.ones((8, 16), np.int32),
             "weight": np.ones(8, np.float32)}
    with pytest.raises(smoke.CheckFailed, match="no survivor"):
        smoke.check_pipeline_batch("x", batch, cfg, pipe_oracle)
    # one survivor repeated through the batch, with its label's weight
    assert pipe_oracle["rounds"][0][1] >= 2
    tokens, weight = next(iter(pipe_oracle["rounds"][0][0].items()))
    batch = {"tokens": np.tile(np.frombuffer(tokens, np.int32), (8, 1)),
             "weight": np.full(8, weight, np.int32).view(np.float32)}
    with pytest.raises(smoke.CheckFailed, match="appears twice"):
        smoke.check_pipeline_batch("x", batch, cfg, pipe_oracle)
    h = smoke.phase_harnesses(cpu, plans=6)
    assert h["fuzz"]["plans"] == 6 and len(h["dist_cases_seconds"]) == 21
    json.dumps(h)


def _counted_launches(monkeypatch, smoke):
    """Make each kernel wrapper count its call as the card's launch would,
    though a CPU tensor takes the plain version, and stub the CUDA memory
    and sync calls chip_smoke's phases make."""
    from repro_torch.kernels import bitonic, hash64, histogram
    from repro_torch.kernels import segment_reduce as seg
    from repro_torch.kernels import segment_scan as scan

    modules = {"hash32": hash64, "hash32_partition": hash64,
               "bucket_histogram": histogram, "bitonic_sort_tiles": bitonic,
               "bitonic_sort_permutation": bitonic,
               "segment_reduce_tiles": seg, "segment_scan_tiles": scan}
    for name, module in modules.items():
        real = smoke.KERNELS[name][0]

        def launch(*a, _real=real, **kw):
            _real.launches += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, launch)
    for name in ("synchronize", "reset_peak_memory_stats",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_chip_smoke_main_path_launch_counts_rehearse_on_the_cpu(monkeypatch):
    """Phase 3's exact launch counts (``MAIN_PATH_LAUNCHES``) hold for the
    main path's calls at 8 x 4096 rows on the CPU, each wrapper's call
    counted as its launch: 48 partition entries, 16 column hashes, 64
    histograms (none thrown away by ``_row_pid``), 8 fused sort
    permutations and no tile sort; and a count off by one fails them."""
    import importlib.util

    from repro_torch.core.context import DistContext

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _counted_launches(monkeypatch, smoke)
    cpu = torch.device("cpu")
    ctx = DistContext(num_shards=P, device=cpu)
    # 4096 rows a shard: every local sort but the combine's is wider than
    # one 2048-row tile, as at the path's 2**22 rows
    tabs = smoke.make_tables(ctx, 4096, cpu)
    _, _, counts, _ = smoke.phase_main_path(ctx, tabs)
    assert counts == {**smoke.MAIN_PATH_LAUNCHES,
                      **{name: 0 for name in smoke.LM_KERNELS}}
    assert counts["bucket_histogram"] == 64 and counts["hash32_partition"] == 48
    monkeypatch.setitem(smoke.MAIN_PATH_LAUNCHES, "bucket_histogram", 112)
    with pytest.raises(smoke.CheckFailed, match="bucket_histogram"):
        smoke.phase_main_path(ctx, tabs)


def _window_matches_one_host(smoke, w, got):
    """The 8-shard window's rows, in shard order, equal the local window
    of all the rows, and groups span shards."""
    from repro_torch.core import ops_agg as TA

    whole = TA.window(w.to_table(), "k", smoke.WINDOW_FUNCS, order_by="o")
    want = whole.to_numpy()
    assert sorted(got["rows"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["rows"][k].numpy(), v, err_msg=k)
    counts = np.asarray(got["row_counts"])
    starts = (np.cumsum(counts) - counts)[counts > 0]
    assert (want["row_number"][starts] > 1).sum() >= 3  # shards start mid-group


def _count_lm_calls(monkeypatch, smoke):
    """The LM kernels' and the histogram's wrappers counted as launches (a
    CPU tensor launches nothing), flash through ``FlashAttentionFn`` in
    training as on the card, and the CUDA-only calls stubbed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import histogram
    from repro_torch.kernels import ops as tops

    modules = {n: fa for n in smoke.LM_KERNELS}
    modules["bucket_histogram"] = histogram
    real = {n: getattr(m, n) for n, m in modules.items()}
    for name, module in modules.items():
        def launch(*a, _name=name, **kw):
            smoke.KERNELS[_name][0].launches += 1
            return real[_name](*a, **kw)
        monkeypatch.setattr(module, name, launch)
    real_attention = tops.attention

    def attention(q, k, v, *, causal=True):
        if tops.oracle_only():
            return real_attention(q, k, v, causal=causal)
        if torch.is_grad_enabled() and q.requires_grad:
            return fa.FlashAttentionFn.apply(q, k, v, causal)
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(tops, "attention", attention)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    return real


def test_chip_smoke_cpu_rehearsal_drives_the_mesh_phase(monkeypatch):
    """chip_smoke.py's phase 25 at TINY widths on the CPU, the wrappers'
    calls counted as launches: (a) llama3-8b's decode over an 8-way
    ``model`` axis at a prompt and a longer one, (b) minicpm3-4b's
    ``mla_seq_shard`` decode, both against the one-device decode; (c) pod
    compression and (d) ``remat="dots"`` against ``"full"`` on granite-3-2b
    at 2 layers over (pod 2, data 2, model 2); (e) the launchers' mesh
    flags, the 'card' side resolved to the CPU. A wrong merge count fails
    (a), a wrong launch count (c)."""
    from repro_torch.configs import get_tiny
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.factory import build_model

    smoke = _load_chip_smoke()
    real = _count_lm_calls(monkeypatch, smoke)
    cpu = torch.device("cpu")
    monkeypatch.setattr(smoke, "get_config", get_tiny)
    for name, value in (("LM_BATCH", 2), ("LM_PROMPT", 12), ("LM_GEN", 4),
                        ("TRAIN_SEQ", 32), ("TINY_TRAIN_STEPS", 2)):
        monkeypatch.setattr(smoke, name, value)
    cfg = get_tiny("llama3-8b")
    model = build_model(cfg, cpu)
    tokens, _ = smoke.serve_inputs(cfg, cpu)
    a = smoke.phase_seq_shard_gqa(model, tokens, long_prompt=28,
                                  profile=False)
    for r, s in ((a["prompt"], 12), (a["long_prompt"], 28)):
        assert r["prompt_len"] == s and r["shards"] == 8
        assert r["merges_per_step"] == {"psum": 2 * 2, "pmax": 2}
        assert r["launches"]["flash_attention"] == 2
        assert r["max_abs_err"] <= smoke.LM_TOL and r["err_by_step"][0] == 0
    b = smoke.phase_seq_shard_mla(cpu, profile=False)
    assert b["merges_per_step"] == {"psum": 2 * 2, "pmax": 2}
    assert b["max_abs_err"] <= smoke.LM_TOL
    cd = smoke.phase_pod_and_dots(cpu, layers=2)
    k = cd["microbatches"]
    assert cd["mesh"] == {"pod": 2, "data": 2, "model": 2} and k == 4
    pod, dots = cd["compress_pod"], cd["remat_dots"]
    assert pod["compressed"]["launches_per_step"]["flash_attention_lse"] == \
        2 * 2 * k * 2
    assert pod["exact"]["launches_per_step"]["flash_attention_lse"] == 2 * 2 * k
    assert pod["max_param_diff"] < smoke.POD_PARAM_TOL
    assert dots["bitwise_leaves"] == dots["leaves"]
    assert dots["dots"]["mm_calls"] < dots["full"]["mm_calls"]
    assert dots["dots"]["launches"]["flash_attention_lse"] == 2 * 2 * k
    json.dumps({"a": a, "b": b, "cd": cd})

    for mod in (serve_cli, train_cli):
        monkeypatch.setattr(mod, "resolve_device", lambda d: cpu)
    real_main = train_cli.main
    monkeypatch.setattr(train_cli, "main", lambda argv: real_main(
        argv + ["--batch", "8", "--seq", "32"]))
    e = smoke.phase_mesh_launchers(cpu)
    assert e["serve"]["qwen2-moe-a2.7b"]["launches"]["bucket_histogram"] == \
        2 * 8 * 16
    assert all(r["max_abs_err"] == 0.0 for r in e["serve"].values())
    assert e["train"]["granite-3-2b"]["max_loss_diff"] == 0.0
    json.dumps(e)

    mesh = smoke.make_local_mesh(8, model=8)
    real_view = mesh.view
    mesh.view = lambda axes: _tamper(real_view(axes))
    with pytest.raises(smoke.CheckFailed, match="merged"):
        smoke.sharded_decode(model, tokens, mesh, profile=False)
    monkeypatch.setattr(fa, "flash_attention_lse", real["flash_attention_lse"])
    granite = get_tiny("granite-3-2b")
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.pod_train_check(
            build_model(granite.replace(num_layers=1), cpu,
                        mesh=smoke.make_local_mesh(8, model=2, pod=2)),
            smoke.train_batches(cpu, granite, 3)[0], 4)


def _tamper(view):
    """A view whose psum is counted twice: a merge count the check rejects."""
    real = view.psum

    def psum(x):
        view.counts["psum"] += 1
        return real(x)

    view.psum = psum
    return view


def _load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the chip run is the real test")
    out = _chip_smoke()
    assert out.returncode == 2 and '"ok"' not in out.stdout


if __name__ == "__main__":
    reference_main(sys.argv[1])
