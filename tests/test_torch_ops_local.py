"""repro_torch's Table and local operators against repro.core.ops_local.

The same numpy inputs (seeded; garbage past ``row_count`` on purpose) go to
both packages on the CPU. Tolerance: none. Float columns hold integer
values and results are compared bit for bit, in the reference's row order,
and as row multisets with ``tables_bitwise_equal``. Capacities <= 2048 take
the bitonic sort path, larger ones the general sort.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ops_local as JL  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.core.table import concat_tables as j_concat  # noqa: E402
from repro.testing.compare import tables_bitwise_equal  # noqa: E402
from repro_torch.core import ops_local as TL  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.core.table import concat_tables as t_concat  # noqa: E402


def both(cols: dict, n_valid: int):
    j = JTable({k: jnp.asarray(v) for k, v in cols.items()},
               jnp.asarray(n_valid, jnp.int32))
    t = TTable.from_numpy(cols, row_count=n_valid, device="cpu")
    return j, t


def relation(seed: int, capacity: int, n_valid: int, key_range: int = 20):
    """k int32, v float32 (integer-valued), w int32; garbage past n_valid."""
    r = np.random.default_rng(seed)
    return both({"k": r.integers(0, key_range, capacity).astype(np.int32),
                 "v": r.integers(-50, 50, capacity).astype(np.float32),
                 "w": r.integers(0, 4, capacity).astype(np.int32)}, n_valid)


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same(j, t, multiset: bool = True):
    """Same columns, same row count, same rows in the same order, bitwise
    (``tables_bitwise_equal`` too, unless the rows hold NaN, which never
    equals itself there)."""
    dj, dt = j.to_numpy(), t.to_numpy()
    assert sorted(dj) == sorted(dt)
    for k in dj:
        assert dt[k].dtype == dj[k].dtype, k
        np.testing.assert_array_equal(bits(dt[k]), bits(dj[k]), err_msg=k)
    assert t.capacity == j.capacity
    assert t.row_count.dtype == torch.int32
    assert not multiset or tables_bitwise_equal(j, t)


def test_table_helpers_match_reference():
    j, t = relation(0, 50, 30)
    assert t.capacity == 50 and t.column_names == j.column_names
    assert t.key_column_names == j.key_column_names
    idx = np.array([3, -1, 0, 49, -1, 7])
    assert_same(j.gather(jnp.asarray(idx), 4), t.gather(torch.from_numpy(idx), 4))
    assert_same(j.gather(jnp.asarray(idx), 6, fill_invalid=False),
                t.gather(torch.from_numpy(idx), 6, fill_invalid=False))
    j2, t2 = relation(1, 20, 11)
    assert_same(j_concat(j, j2), t_concat(t, t2))
    padded = TTable.from_numpy({"k": np.arange(5, dtype=np.int32)}, capacity=8,
                               device="cpu")
    assert padded.capacity == 8 and int(padded.row_count) == 5
    np.testing.assert_array_equal(padded.to_numpy()["k"], np.arange(5))
    e = TTable.empty({"a": torch.int32, "tok": (torch.int32, (4,))}, 6,
                     device="cpu")
    assert e.columns["tok"].shape == (6, 4) and int(e.row_count) == 0


@pytest.mark.parametrize("capacity,n_valid", [(40, 33), (3000, 2500)])
def test_compact_select_project_head(capacity, n_valid):
    j, t = relation(capacity, capacity, n_valid)
    assert_same(JL.select(j, lambda c: c["k"] % 3 == 0),
                TL.select(t, lambda c: c["k"] % 3 == 0))
    assert_same(JL.project(j, ["v", "k"]), TL.project(t, ["v", "k"]))
    assert_same(JL.head(j, 17), TL.head(t, 17))


def test_ordered_u32_matches_reference():
    r = np.random.default_rng(4)
    f = r.standard_normal(64).astype(np.float32)
    f[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, -np.nan]
    for x in (r.integers(-2**31, 2**31 - 1, 64).astype(np.int32), f,
              r.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)):
        want = np.asarray(JL.ordered_u32(jnp.asarray(x))).astype(np.int64)
        np.testing.assert_array_equal(TL.ordered_u32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("capacity,n_valid", [(300, 280), (2048, 2000), (3000, 2990)])
@pytest.mark.parametrize("by", [["k"], ["v"], ["w", "k"]])
def test_sort_by_matches_reference(capacity, n_valid, by):
    j, t = relation(capacity + len(by), capacity, n_valid, key_range=200)
    assert_same(JL.sort_by(j, by), TL.sort_by(t, by))


def test_sort_float_keys_with_signed_zero_and_nan():
    v = np.array([1.0, -0.0, 0.0, np.nan, -1.0, 0.0, -0.0, 2.0] * 5, np.float32)
    for cap in (40, 2600):  # bitonic path, general path
        vals = np.resize(v, cap)
        j, t = both({"v": vals, "i": np.arange(cap, dtype=np.int32)}, cap - 3)
        assert_same(JL.sort_by(j, "v"), TL.sort_by(t, "v"), multiset=False)


def test_merge_matches_reference():
    j1, t1 = relation(5, 100, 90)
    j2, t2 = relation(6, 100, 70)
    assert_same(JL.merge(JL.sort_by(j1, "k"), JL.sort_by(j2, "k"), "k"),
                TL.merge(TL.sort_by(t1, "k"), TL.sort_by(t2, "k"), "k"))


@pytest.mark.parametrize("keys", [["k"], ["k", "v", "w"]])
def test_hash_partition_matches_reference(keys):
    j, t = relation(7, 500, 431, key_range=1000)
    jp, jh = JL.hash_partition(j, keys, 8, seed=7)
    tp, th = TL.hash_partition(t, keys, 8, seed=7)
    assert tp.dtype == torch.int32 and th.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_distinct_and_set_ops_match_reference():
    def small(seed, n_valid):
        rr = np.random.default_rng(seed)
        return both({"a": rr.integers(0, 4, 120).astype(np.int32),
                     "b": rr.integers(0, 3, 120).astype(np.float32)}, n_valid)

    ja, ta = small(1, 100)
    jb, tb = small(2, 80)
    assert_same(JL.distinct(ja), TL.distinct(ta))
    assert_same(JL.union(ja, jb), TL.union(ta, tb))
    assert_same(JL.intersect(ja, jb), TL.intersect(ta, tb))
    assert_same(JL.difference(ja, jb), TL.difference(ta, tb))
    assert_same(JL.difference(ja, jb, mode="left"), TL.difference(ta, tb, mode="left"))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("algorithm", ["sort", "hash"])
def test_join_matches_reference(how, algorithm):
    jl, tl = relation(10, 150, 140, key_range=60)
    jr, tr = relation(11, 130, 101, key_range=60)
    for out_cap in (None, 90):
        kw = dict(how=how, algorithm=algorithm, out_capacity=out_cap, seed=3,
                  with_overflow=True)
        (jo, jov), (to, tov) = JL.join(jl, jr, "k", **kw), TL.join(tl, tr, "k", **kw)
        assert_same(jo, to)
        assert tov.dtype == torch.int32 and int(tov) == int(jov)


def test_hash_join_multi_key_matches_reference():
    jl, tl = relation(12, 200, 180, key_range=8)
    jr, tr = relation(13, 200, 150, key_range=8)
    assert_same(JL.join(jl, jr, ["k", "w"], algorithm="hash", how="full"),
                TL.join(tl, tr, ["k", "w"], algorithm="hash", how="full"))


def test_port_sort_keeps_a_max_key_row_at_capacity_300():
    """The port's bitonic path holds a valid INT32_MAX key at a capacity
    that is not a power of two (its padding sorts after every real pair)."""
    k = np.zeros(300, np.int32)
    k[5] = np.iinfo(np.int32).max
    _, t = both({"k": k}, 300)
    perm = TL.sort_permutation(t, ["k"]).numpy()
    np.testing.assert_array_equal(perm, np.argsort(k, kind="stable"))


@pytest.mark.xfail(strict=True, reason=(
    "reference fault: repro/kernels/ops.py sort_pairs pads the bitonic tile "
    "with (key_max, payload 0), which sorts ahead of a valid max-key row "
    "(ROADMAP queue 3)"))
def test_reference_sort_keeps_a_max_key_row_at_capacity_300():
    k = np.zeros(300, np.int32)
    k[5] = np.iinfo(np.int32).max
    j, _ = both({"k": k}, 300)
    perm = np.asarray(JL.sort_permutation(j, ["k"]))
    np.testing.assert_array_equal(perm, np.argsort(k, kind="stable"))


@pytest.mark.parametrize("make", ["random_table", "zipf_table"])
def test_synthetic_tables_match_reference(make):
    from repro.data import synthetic as JS
    from repro_torch.data import synthetic as TS

    kw = dict(key_range=97, seed=3, step=2, shard=5)
    want = getattr(JS, make)(300, **kw)
    got = getattr(TS, make)(300, device="cpu", **kw)
    assert_same(want, got)
