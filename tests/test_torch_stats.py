"""repro_torch.core.stats and DistContext.analyze against repro.core.stats.

The sizing math and the containers are held against the JAX package on the
same values; the sketch against ``repro.core.stats.analyze_table``, on a
local table and on the global table a sharded one gathers to (with
``max_shard_rows`` the largest shard's count, as the reference's
``DistContext.analyze`` sets it; that method itself is not called: it
raises on the installed jax). Tolerance: none. Stats compare by ``repr``,
so -0.0 differs from 0.0 and NaN equals NaN.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import stats as RS  # noqa: E402
from repro.core.table import Table as RTable  # noqa: E402
from repro_torch.core import stats as PS  # noqa: E402
from repro_torch.core.context import DistContext  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402

P = 8

MEANS = [0.0, 1e-3, 0.5, 1.0, 7.3, 100.0, 2.0 ** 19, 2.0 ** 22 / 8, 3e9]


def test_constants_match():
    for name in ("FALLBACK_SLACK", "SORT_SLACK_FACTOR", "JOIN_OUT_FACTOR",
                 "DEFAULT_SELECTIVITY", "RANGE_SIZING_FACTOR",
                 "JOIN_OUT_SIZING_FACTOR", "SKETCH_BUCKETS",
                 "STAGE_WIRE_THRESHOLD", "MAX_SHUFFLE_STAGES"):
        assert getattr(PS, name) == getattr(RS, name), name


@pytest.mark.parametrize("fn", ["with_skew_margin", "size_bucket",
                                "size_output"])
def test_sizing_matches(fn):
    for m in MEANS:
        if fn == "with_skew_margin":
            assert PS.with_skew_margin(m) == RS.with_skew_margin(m), m
            continue
        for p in (1, 3, 8):
            for factor in (1.0, 1.5, 2.0):
                got = getattr(PS, fn)(m, p, factor)
                assert got == getattr(RS, fn)(m, p, factor), (m, p, factor)
    # the full-width prediction: a 2**22-row shard hashed over 8
    assert PS.size_bucket(2 ** 22, 8) == 527_189


def test_linear_count_and_pick_stages_match():
    for rows in (0.0, 1.0, 10.0, 5000.0, 2.0 ** 25):
        for filled in (0, 1, 7, 2048, 4095, 4096, 5000):
            for buckets in (4096, 64):
                assert PS.linear_count(filled, rows, buckets) == \
                    RS.linear_count(filled, rows, buckets)
    for wire in (0, 1 << 20, (1 << 20) + 1, 4 << 20, 1 << 30):
        for bucket in (1, 2, 3, 1000):
            assert PS.pick_stages(wire, bucket) == RS.pick_stages(wire, bucket)


def _pair(rows, cols, msr=None):
    """The same TableStats built in both packages."""
    return tuple(
        mod.TableStats(rows, tuple((k, mod.ColumnStats(*v)) for k, v in cols),
                       msr) for mod in (RS, PS))


def test_containers_and_cap_rows_match():
    cols = [("a", (10.0, -1.0, 5.0)), ("b", (3.0, 0.0, 2.0)),
            ("c", (5000.0, None, None))]
    for rows, msr in ((100.0, None), (100.0, 40.0), (0.0, 0.0), (1e6, None)):
        r, p = _pair(rows, cols, msr)
        for keys in ((), ("a",), ("a", "b"), ("c", "a"), ("a", "zz")):
            assert p.ndv(keys) == r.ndv(keys), keys
        for shards in (1, 3, 8):
            assert p.shard_rows(shards) == r.shard_rows(shards)
        assert repr(p.col("b")) == repr(r.col("b")) and p.col("zz") is None
        for new_rows, keep in ((50.0, None), (2.0, ("a", "c")), (-3.0, ())):
            assert repr(PS.cap_rows(p, new_rows, keep)) == \
                repr(RS.cap_rows(r, new_rows, keep))


def _edge_columns(n: int, rng) -> dict[str, np.ndarray]:
    """int32, uint32 and float32 keys with the edge values (+-0.0, NaN,
    +-inf, the integer extremes), an N-D float column (not a key)."""
    f = rng.integers(-50, 50, n).astype(np.float32)
    f[rng.integers(0, n, max(1, n // 20))] = -0.0
    f[rng.integers(0, n, max(1, n // 20))] = 0.0
    g = rng.standard_normal(n).astype(np.float32)
    g[rng.integers(0, n, 3)] = np.nan
    g[rng.integers(0, n, 2)] = np.inf
    g[rng.integers(0, n, 2)] = -np.inf
    k = rng.integers(-1000, 1000, n).astype(np.int32)
    k[:2] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    u[:2] = [0, 2 ** 32 - 1]
    return {"f": f, "g": g, "k": k, "u": u,
            "m": rng.standard_normal((n, 2)).astype(np.float32)}


def _ref_stats(cols: dict[str, np.ndarray], rows: int):
    return RS.analyze_table(RTable.from_arrays(
        {k: jnp.asarray(v) for k, v in cols.items()}, row_count=rows))


@pytest.mark.parametrize("rows", [0, 1, 37, 300, 512])
def test_analyze_table_matches(rows):
    cols = _edge_columns(512, np.random.default_rng(rows))
    got = PS.analyze_table(Table.from_numpy(cols, row_count=rows, device="cpu"))
    assert repr(got) == repr(_ref_stats(cols, rows))
    assert [k for k, _ in got.columns] == ["f", "g", "k", "u"]


def _sharded(counts, make, cap):
    ctx = DistContext(num_shards=P, device="cpu")
    parts = [Table.from_numpy(make(i, cap), row_count=n, device="cpu")
             for i, n in enumerate(counts)]
    return ctx, ctx.from_local_parts(parts)


def _held_against_reference(ctx, t):
    got = ctx.analyze(t)
    whole = got.to_table()
    cols = {k: v.numpy() for k, v in whole.columns.items()}
    if whole.capacity == 0:  # jnp.min of no elements raises: one invalid row
        cols = {k: np.zeros((1,) + v.shape[1:], v.dtype)
                for k, v in cols.items()}
    want = _ref_stats(cols, int(whole.row_count))
    want = dataclasses.replace(
        want, max_shard_rows=float(t.row_counts.max()))
    assert repr(got.stats) == repr(want)
    return got


@pytest.mark.parametrize("case", ["edges", "empty", "saturated", "one_shard"])
def test_dist_analyze_matches_gathered_reference(case, monkeypatch):
    if case == "edges":
        counts = [400 + 13 * i for i in range(P)]
        ctx, t = _sharded(counts, lambda i, c: _edge_columns(
            c, np.random.default_rng([3, i])), 512)
    elif case == "empty":
        counts = [0] * P
        ctx, t = _sharded(counts, lambda i, c: _edge_columns(
            c, np.random.default_rng([4, i])), 64)
    elif case == "saturated":  # 65536 distinct keys: every bitmap slot set
        counts = [8192] * P
        ctx, t = _sharded(counts, lambda i, c: {
            "k": np.arange(i * c, (i + 1) * c, dtype=np.int32)}, 8192)
    else:
        counts = [0] * (P - 1) + [70]
        ctx, t = _sharded(counts, lambda i, c: _edge_columns(
            c, np.random.default_rng([5, i])), 96)
    from repro_torch.kernels import ops as kops

    calls = []
    real = kops.hash_partition_ids

    def counted(cols, row_count, num_partitions, seed=0):
        calls.append((len(cols), num_partitions, seed))
        return real(cols, row_count, num_partitions, seed)

    monkeypatch.setattr(kops, "hash_partition_ids", counted)
    got = _held_against_reference(ctx, t)
    keys = [k for k, _ in got.stats.columns]
    # one sketch launch a key column over the whole (p, C) layout
    assert calls == [(1, PS.SKETCH_BUCKETS, PS.SKETCH_SEED)] * len(keys)
    assert got.stats.max_shard_rows == max(counts)
    assert got.stats.rows == sum(counts)
    if case == "saturated":
        assert got.stats.col("k").ndv == sum(counts)
    if case == "empty":
        assert all(math.isinf(cs.lo) or cs.lo == np.iinfo(np.int32).max
                   or cs.lo == 2 ** 32 - 1 for _, cs in got.stats.columns)


def test_analyze_is_idempotent_and_skips_non_keys():
    ctx, t = _sharded([5] * P, lambda i, c: _edge_columns(
        c, np.random.default_rng([6, i])), 8)
    once = ctx.analyze(t)
    assert t.stats is None and once.stats is not None
    assert ctx.analyze(once) is once
    assert "m" not in dict(once.stats.columns)
    for k in once.columns:
        assert once.columns[k] is t.columns[k]
