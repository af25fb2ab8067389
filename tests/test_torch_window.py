"""repro_torch's window functions (ops_agg window half, ops_dist.dist_window)
against repro.core.ops_agg.window and tests/oracle.py::window_oracle.

Seeded numpy inputs go to both packages on the CPU, where the port's scans
take their plain version. Tolerance: none. Float payloads hold integer
values, so running sums and means agree bit for bit; rows are compared in
order (the window's output is sorted by (by, order_by)).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from oracle import window_oracle  # noqa: E402
from repro.core import ops_agg as JA  # noqa: E402
from repro.core import ops_local as JL  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro_torch.core import ops_agg as TA  # noqa: E402
from repro_torch.core import ops_dist as TD  # noqa: E402
from repro_torch.core import ops_local as TL  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
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


ALL_FUNCS = ["rank", "dense_rank", "row_number",
             ("lag", "d0"), ("lead", "d0"), ("lag", "d1", 3),
             ("lead", "d1", 2), ("cumsum", "d0"), ("cumsum", "d1"),
             ("cummax", "d1"), ("running_mean", "d0")]


def _cols(n, key_range, order_range=None, seed=0):
    rng = np.random.default_rng(seed)
    order = (rng.permutation(n).astype(np.int32) if order_range is None
             else rng.integers(0, order_range, n).astype(np.int32))
    return {"k": rng.integers(0, key_range, n).astype(np.int32),
            "o": order,
            "d0": rng.integers(-30, 30, n).astype(np.float32),
            "d1": rng.integers(-9, 9, n).astype(np.int32)}


def _jt(cols, capacity=None, n_valid=None):
    return JTable.from_arrays(cols, capacity=capacity) if n_valid is None else \
        JTable({k: jnp.asarray(v) for k, v in cols.items()},
               jnp.asarray(n_valid, jnp.int32))


def _tt(cols, capacity=None, n_valid=None):
    return TTable.from_numpy(cols, row_count=n_valid, capacity=capacity,
                             device="cpu")


def _same(got: dict, want: dict, names=None) -> None:
    """Bitwise equality of host column dicts, dtype included."""
    names = sorted(want) if names is None else names
    for k in names:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _check(cols, by, order_by, funcs, *, capacity=None, use_kernel=None):
    by_l = [by] if isinstance(by, str) else list(by)
    order_l = [order_by] if isinstance(order_by, str) else list(order_by)
    got = TA.window(_tt(cols, capacity), by, funcs, order_by=order_by,
                    use_kernel=use_kernel)
    want = JA.window(_jt(cols, capacity), by, funcs, order_by=order_by)
    assert got.capacity == want.capacity
    g, w = got.to_numpy(), want.to_numpy()
    assert sorted(g) == sorted(w)
    _same(g, w)
    oracle = window_oracle(cols, by_l, order_l, JA.normalize_funcs(funcs))
    _same(g, oracle)
    return g


@pytest.mark.parametrize("n,key_range", [(1, 1), (7, 3), (200, 10),
                                         (500, 1), (300, 300), (3000, 40)])
def test_window_all_funcs_unique_order(n, key_range):
    _check(_cols(n, key_range, seed=n), "k", "o", ALL_FUNCS)


def test_window_ties_share_rank():
    _check(_cols(300, 4, order_range=5, seed=9), "k", "o", ALL_FUNCS)


def test_window_multikey_no_order():
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, 4, 250).astype(np.int32),
            "b": rng.integers(0, 3, 250).astype(np.int32),
            "d0": rng.integers(-20, 20, 250).astype(np.float32),
            "d1": rng.integers(-5, 5, 250).astype(np.int32)}
    g = _check(cols, ["a", "b"], (), ["rank", "dense_rank", "row_number",
                                      ("cumsum", "d0"), ("lag", "d1")])
    assert (g["rank"] == 1).all() and (g["dense_rank"] == 1).all()


def test_window_float_order_keys_nan_and_signed_zero():
    # NaN order values each start their own value run; -0.0 and +0.0 share one
    cols = {"k": np.array([0, 0, 0, 0, 0, 1, 1, 1], np.int32),
            "o": np.array([1.0, np.nan, -0.0, 0.0, np.nan, 0.0, -0.0, 2.0],
                          np.float32),
            "d1": np.arange(8, dtype=np.int32)}
    funcs = ["rank", "dense_rank", ("cumsum", "d1"), ("lag", "d1")]
    got = TA.window(_tt(cols), "k", funcs, order_by="o").to_numpy()
    want = JA.window(_jt(cols), "k", funcs, order_by="o").to_numpy()
    _same(got, want)


def test_window_empty_and_capacity_padding():
    empty = {"k": np.zeros(0, np.int32), "d0": np.zeros(0, np.float32)}
    out = TA.window(_tt(empty), "k", [("cumsum", "d0"), "rank"])
    ref = JA.window(_jt(empty), "k", [("cumsum", "d0"), "rank"])
    assert int(out.row_count) == 0 and out.capacity == ref.capacity == 1
    _check(_cols(40, 3, seed=1), "k", "o", ALL_FUNCS, capacity=128)


def test_window_garbage_rows_past_the_count():
    # valid rows then nonzero garbage: nothing past row_count leaks in
    cols = _cols(256, 5, order_range=7, seed=4)
    got = TA.window(_tt(cols, n_valid=200), "k", ALL_FUNCS, order_by="o")
    want = JA.window(_jt(cols, n_valid=200), "k", ALL_FUNCS, order_by="o")
    _same(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("use_kernel", [None, False])
def test_window_use_kernel_paths_agree(use_kernel):
    _check(_cols(400, 6, seed=8), "k", "o",
           ["rank", "dense_rank", ("cumsum", "d0"), ("cummax", "d1"),
            ("running_mean", "d0")], use_kernel=use_kernel)


def test_normalize_funcs_canonical_and_validating():
    spec = ["rank", ("lag", "d0"), ("lag", "d0", 2), ("cumsum", "d0")]
    assert TA.normalize_funcs(spec) == JA.normalize_funcs(spec)
    assert TA.normalize_funcs("rank") == (("rank", None, 0),)
    for fn, col, off in TA.normalize_funcs(spec):
        assert TA.window_output_name(fn, col, off) == \
            JA.window_output_name(fn, col, off)
    for bad in (["median"], [("rank", "d0")], [("cumsum", None)],
                [("lag", "d0", -1)], [("cumsum", "d0", 2)]):
        with pytest.raises(ValueError):
            TA.normalize_funcs(bad)
        with pytest.raises(AssertionError):
            JA.normalize_funcs(bad)


def test_window_output_collision_and_uint32_scan_rejected():
    t = _tt({"k": np.zeros(4, np.int32), "rank": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="collides"):
        TA.window(t, "k", ["rank"])
    cols = {"k": np.zeros(4, np.int32),
            "u": np.array([5, 0xFFFFFFFF, 7, 1], np.uint32)}
    with pytest.raises(ValueError, match="f32/i32"):
        TA.window(_tt(cols), "k", [("cumsum", "u")])
    # lag/lead are gathers: uint32 keeps its dtype
    got = TA.window(_tt(cols), "k", [("lag", "u"), ("lead", "u", 2)]).to_numpy()
    want = JA.window(_jt(cols), "k", [("lag", "u"), ("lead", "u", 2)]).to_numpy()
    assert got["u_lag"].dtype == np.uint32
    _same(got, want)


# --- the building blocks, leaf for leaf ---------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_window_state_and_summaries_match_reference():
    cols = _cols(300, 6, order_range=9, seed=21)
    by, order = ["k"], ["o"]
    pairs = JA.normalize_funcs(ALL_FUNCS + [("cummax", "d0"), ("lag", "d0", 5),
                                            ("lead", "d1", 4)])
    js = JL.sort_by(_jt(cols, n_valid=260), by + order)
    ts = TL.sort_by(_tt(cols, n_valid=260), by + order)
    _same(ts.to_numpy(), js.to_numpy())
    jstate, tstate = JA.window_state(js, by, order), TA.window_state(ts, by, order)
    _same(_leaves(tstate), _leaves(jstate))
    _same(_leaves(TA.window_summary(ts, tstate, by, order, pairs)),
          _leaves(JA.window_summary(js, jstate, by, order, pairs)))
    _same(_leaves(TA.window_lead_summary(ts, tstate, by, pairs)),
          _leaves(JA.window_lead_summary(js, jstate, by, pairs)))
    _same(TA.window_sorted(ts, tstate, by, order, pairs),
          {k: np.asarray(v) for k, v in
           JA.window_sorted(js, jstate, by, order, pairs).items()})


# --- the boundary carry: hand-placed shards against the one-host window --------

# shard sizes over one globally sorted frame: a group running through whole
# shards, empty shards (first, middle, last), one-row shards, and shards
# thinner than the lag/lead offsets
LAYOUTS = {
    "even": [40, 40, 40, 40],
    "empty_and_thin": [0, 3, 0, 1, 50, 0, 2, 24],
    "one_row_each": [1] * 8,
    "all_on_one": [0, 0, 80, 0],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("groups,order_range", [(1, 4), (3, None), (2, 3)])
def test_dist_window_carry_matches_one_host(layout, groups, order_range):
    sizes = LAYOUTS[layout]
    n = sum(sizes)
    cols = _cols(n, groups, order_range=order_range, seed=n + groups)
    funcs = ALL_FUNCS + [("lag", "d0", 5), ("lead", "d0", 6), ("cummax", "d0")]
    whole = TA.window(_tt(cols), "k", funcs, order_by="o")
    # the frame in global order, then cut into shards of one capacity
    frame = TL.sort_by(_tt(cols), ["k", "o"]).to_numpy()
    cap = max(sizes) + 2
    shards, at = [], 0
    for m in sizes:
        part = {k: v[at:at + m] for k, v in frame.items()}
        shards.append(_tt(part, capacity=cap))
        at += m
    mesh = VirtualMesh(len(sizes))
    outs, (st,) = TD.dist_window(shards, "k", funcs, order_by="o", mesh=mesh,
                                 bucket_capacity=cap, skip_shuffle=True)
    assert [int(t.row_count) for t in outs] == sizes
    got = {k: np.concatenate([t.to_numpy()[k] for t in outs])
           for k in whole.columns}
    _same(got, whole.to_numpy())
    assert mesh.counts["all_to_all"] == 0 and mesh.counts["all_gather"] > 0
