"""The slice as a whole: repro_torch's eager DistContext on 8 virtual shards
against repro's eager DistContext on 8 host devices.

One subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the
pattern of tests/test_dist.py) runs every reference case and writes its
results to an ``.npz``; the port runs the same calls on the CPU. Inputs are
seeded numpy tables of 8 x 512 rows with integer-valued floats. Tolerance:
none. Each case must agree on every shard's rows (bitwise, in order), the
per-shard row counts, every shuffle's per-shard overflow and received rows,
and the ``report`` records (bucket, bytes per row, wire bytes, stages).

One stated exception: a variance may differ by the rounding of
``mean*mean``, at most 2**-21 * (mean**2 + var). Inside the reference's
jitted shard_map program XLA contracts ``sumsq/n - mean*mean`` into one
fused multiply-add; the port, like the reference run eagerly (see
tests/test_torch_groupby.py, bitwise there), rounds the product first.
"""
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
}


def inputs() -> dict[str, list[tuple[dict, int]]]:
    """Per-shard (columns, valid rows) for each input table; garbage rows
    past the count on purpose."""
    out = {}
    for ti, name in enumerate(("a", "b", "s1", "s2")):
        parts = []
        for i in range(P):
            r = np.random.default_rng([ti, i])
            if name in ("a", "b"):
                cols = {"k": r.integers(0, 600, CAP).astype(np.int32),
                        "v": r.integers(-40, 40, CAP).astype(np.float32),
                        "w": r.integers(0, 5, CAP).astype(np.int32)}
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


def test_chip_smoke_cpu_rehearsal_drives_the_main_path():
    """chip_smoke.py's main-path calls and its comparison of a run against
    the ``oracle_scope()`` run, at 8 x 1024 rows on the CPU (plain versions
    on both sides, so equal bit for bit)."""
    import importlib.util

    from repro_torch.core.context import DistContext
    from repro_torch.kernels import ops as kops

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = torch.device("cpu")
    ctx = DistContext(num_shards=P, device=cpu)
    a, b, g = smoke.make_tables(ctx, 1024, cpu)
    names = []
    for name, call in smoke.main_path_calls(ctx, a, b, g):
        got = smoke.summarize(*call())
        with kops.oracle_scope():
            want = smoke.summarize(*call())
        assert smoke.compare_results(name, got, want) == 0.0
        assert sum(got["row_counts"]) > 0
        names.append(name)
    assert names == ["join_sort", "join_hash", "groupby_two_phase",
                     "groupby_shuffle", "sort"]
    with pytest.raises(smoke.CheckFailed):
        bad = dict(got, row_counts=got["row_counts"][::-1] + [1])
        smoke.compare_results("sort", bad, want)


def test_chip_smoke_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the chip run is the real test")
    out = _chip_smoke()
    assert out.returncode == 2 and '"ok"' not in out.stdout


if __name__ == "__main__":
    reference_main(sys.argv[1])
