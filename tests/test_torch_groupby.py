"""repro_torch's groupby (ops_agg, groupby half) against repro.core.ops_agg.

Seeded numpy inputs go to both packages on the CPU. Tolerance: none. Float
payloads hold integer values, so sums, mean and var agree bit for bit; rows
are compared in the reference's order and as multisets. Capacities <= 2048
sort on the bitonic path.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ops_agg as JA  # noqa: E402
from repro.core import ops_local as JL  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.testing.compare import tables_bitwise_equal  # noqa: E402
from repro_torch.core import ops_agg as TA  # noqa: E402
from repro_torch.core import ops_local as TL  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AGGS = {"v": ["sum", "count", "min", "max", "mean", "var", "first"],
        "w": ["sum", "min", "max"]}


def both(cols: dict, n_valid: int):
    j = JTable({k: jnp.asarray(v) for k, v in cols.items()},
               jnp.asarray(n_valid, jnp.int32))
    t = TTable.from_numpy(cols, row_count=n_valid, device="cpu")
    return j, t


def relation(seed, capacity, n_valid, key_range):
    r = np.random.default_rng(seed)
    return both({"k": r.integers(0, key_range, capacity).astype(np.int32),
                 "g": r.integers(0, 3, capacity).astype(np.int32),
                 "v": r.integers(-30, 30, capacity).astype(np.float32),
                 "w": r.integers(-5, 5, capacity).astype(np.int32)}, n_valid)


def assert_same(j, t):
    dj, dt = j.to_numpy(), t.to_numpy()
    assert sorted(dj) == sorted(dt)
    for k in dj:
        a, b = dj[k], dt[k]
        assert a.dtype == b.dtype, k
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert t.capacity == j.capacity and t.row_count.dtype == torch.int32
    assert tables_bitwise_equal(j, t)


@pytest.mark.parametrize("capacity,n_valid,key_range", [
    (200, 170, 12),      # bitonic sort, segment count = capacity
    (2048, 1999, 300),   # one full bitonic tile
    (3000, 2900, 700),   # general sort
])
@pytest.mark.parametrize("keys", [["k"], ["k", "g"]])
def test_groupby_matches_reference(capacity, n_valid, key_range, keys):
    j, t = relation(capacity, capacity, n_valid, key_range)
    assert_same(JA.groupby(j, keys, AGGS), TA.groupby(t, keys, AGGS))


def test_groupby_plain_scatter_and_out_capacity_match_reference():
    j, t = relation(1, 300, 260, 40)
    assert_same(JA.groupby(j, "k", AGGS, use_kernel=False),
                TA.groupby(t, "k", AGGS, use_kernel=False))
    assert_same(JA.groupby(j, "k", AGGS, out_capacity=16),
                TA.groupby(t, "k", AGGS, out_capacity=16))


def test_partial_and_combine_match_reference():
    j1, t1 = relation(2, 256, 250, 30)
    j2, t2 = relation(3, 256, 199, 30)
    jp1, tp1 = JA.partial_groupby(j1, "k", AGGS), TA.partial_groupby(t1, "k", AGGS)
    jp2, tp2 = JA.partial_groupby(j2, "k", AGGS), TA.partial_groupby(t2, "k", AGGS)
    assert_same(jp1, tp1)
    jc = JA.combine_groupby(JL.merge(jp1, jp2, "k"), "k", AGGS)
    tc = TA.combine_groupby(TL.merge(tp1, tp2, "k"), "k", AGGS)
    assert_same(jc, tc)
    # the combine of shard partials is the groupby of the concatenation
    assert_same(JA.combine_groupby(jp1, "k", AGGS), TA.groupby(t1, "k", AGGS))


def test_groupby_nd_payload_matches_reference():
    r = np.random.default_rng(4)
    cols = {"k": r.integers(0, 9, 120).astype(np.int32),
            "e": r.integers(-4, 4, (120, 3)).astype(np.float32)}
    j, t = both(cols, 111)
    aggs = {"e": ["sum", "min", "max", "mean", "first"]}
    assert_same(JA.groupby(j, "k", aggs), TA.groupby(t, "k", aggs))


def test_normalize_aggs_matches_reference():
    assert TA.normalize_aggs(AGGS) == JA.normalize_aggs(AGGS)
    assert TA.normalize_aggs([("v", "sum")]) == (("v", "sum"),)
    with pytest.raises(ValueError):
        TA.normalize_aggs({"v": "median"})
