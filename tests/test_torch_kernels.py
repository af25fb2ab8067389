"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU every wrapper takes its plain PyTorch version; those are held
against the Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them) and against ``repro.kernels.ref``. Inputs come from numpy with a
seed. Tolerance: exact everywhere (integer kernels, and float sums on
integer-valued data) but in flash attention, which holds the reference's
own tolerances (``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in bf16; the
softmax sums run in another order). The cases marked ``cuda`` hold each
CUDA kernel against its plain version on the card and skip without one.
"""
import pathlib
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_tiles as j_bitonic  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.hash64 import hash32 as j_hash32  # noqa: E402
from repro.kernels.histogram import bucket_histogram as j_hist  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce_tiles as j_seg  # noqa: E402
from repro.kernels.segment_scan import segment_scan_tiles as j_scan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.bitonic import (bitonic_sort_permutation,  # noqa: E402
                                         bitonic_sort_tiles)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_HEAD_DIMS, flash_attention)
from repro_torch.kernels.hash64 import hash32, hash32_partition  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402
from repro_torch.kernels.segment_scan import segment_scan_tiles  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _cu_constant(source, name):
    """A ``constexpr int`` of a CUDA source in repro_torch/kernels/csrc."""
    text = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
            "kernels" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# the CUDA kernels' edges, read from their sources: segment_scan's rows per
# tile, and the ids one block of bucket_histogram's register path reads in
# one unrolled step (16-byte loads of 4 ids)
SCAN_TILE = (_cu_constant("segment_scan.cu", "kRowThreads")
             * _cu_constant("segment_scan.cu", "kItems"))
HIST_STEP = (_cu_constant("histogram.cu", "kRegThreads")
             * _cu_constant("histogram.cu", "kUnroll") * 4)


def _column(dtype, n, seed):
    r = _rng(seed)
    if dtype == np.float32:
        x = r.standard_normal(n).astype(np.float32)
        x[: min(n, 5)] = np.array([0.0, -0.0, np.nan, np.inf, -np.inf],
                                  np.float32)[: min(n, 5)]
        return x
    return r.integers(-2**31, 2**31 - 1, n).astype(np.int64).astype(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


# --- hash32 -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8193])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("seed", [0, 17])
def test_hash32_plain_matches_pallas_and_ref(n, dtype, seed):
    x = _column(dtype, n, seed=n)
    got = hash32(torch.from_numpy(x), seed=seed).numpy()
    pallas = np.asarray(j_hash32(jnp.asarray(x), seed=seed)).astype(np.int64)
    oracle = np.asarray(jref.hash32_ref(jnp.asarray(x), seed)).astype(np.int64)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


def test_hash_columns_matches_reference():
    r = _rng(3)
    cols = [r.integers(0, 100, 300).astype(np.int32),
            r.standard_normal(300).astype(np.float32),
            r.integers(0, 2**32 - 1, 300).astype(np.uint32)]
    got = tops.hash_columns([torch.from_numpy(c) for c in cols], seed=5).numpy()
    want = np.asarray(jops.hash_columns([jnp.asarray(c) for c in cols], seed=5))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    h1, h2 = (np.asarray(jref.hash32_ref(jnp.asarray(c), 1)) for c in cols[:2])
    comb = tref.hash_combine_ref(torch.from_numpy(h1.astype(np.int64)),
                                 torch.from_numpy(h2.astype(np.int64))).numpy()
    np.testing.assert_array_equal(
        comb, np.asarray(jref.hash_combine_ref(h1, h2)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 8193])
@pytest.mark.parametrize("ncols", [1, 3])
def test_hash32_partition_plain_matches_pallas(n, ncols):
    """The partition entry (its plain version on the CPU) against the
    reference's chain around the Pallas kernel in interpret mode:
    ``hash_columns`` ``% P`` as int32, -1 at rows past the count."""
    cols = [_column(dt, n, seed=n + i)
            for i, dt in enumerate((np.int32, np.uint32, np.float32)[:ncols])]
    h = np.asarray(jops.hash_columns([jnp.asarray(c) for c in cols], seed=9))
    for p in (1, 8, 4096):
        for rc in (0, n // 2, n):
            got = hash32_partition([torch.from_numpy(c) for c in cols],
                                   torch.tensor(rc, dtype=torch.int32), p, 9)
            want = np.where(np.arange(n) < rc, (h % np.uint32(p)).astype(np.int32),
                            -1)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad,err", [
    ("no columns", ValueError), ("int64 column", TypeError),
    ("2-D column", TypeError), ("lengths differ", TypeError),
    ("int64 row_count", TypeError), ("1-D row_count", TypeError),
    ("P 0", ValueError)])
def test_hash32_partition_rejects_bad_inputs(bad, err):
    c = torch.zeros(8, dtype=torch.int32)
    rc = torch.tensor(3, dtype=torch.int32)
    args = {"no columns": ([], rc, 4), "int64 column": ([c.long()], rc, 4),
            "2-D column": ([c.view(2, 4)], rc, 4),
            "lengths differ": ([c, c[:7]], rc, 4),
            "int64 row_count": ([c], rc.long(), 4),
            "1-D row_count": ([c], rc.view(1), 4), "P 0": ([c], rc, 0)}[bad]
    with pytest.raises(err):
        hash32_partition(*args)


@pytest.mark.parametrize("bad,err", [
    ("int64 keys", TypeError), ("2-D keys", TypeError),
    ("2049 rows", ValueError), ("int64 row_count", TypeError)])
def test_bitonic_sort_permutation_rejects_bad_inputs(bad, err):
    k = torch.zeros(8, dtype=torch.int32)
    rc = torch.tensor(3, dtype=torch.int32)
    args = {"int64 keys": (k.long(), rc), "2-D keys": (k.view(2, 4), rc),
            "2049 rows": (torch.zeros(2049, dtype=torch.int32), rc),
            "int64 row_count": (k, rc.long())}[bad]
    with pytest.raises(err):
        bitonic_sort_permutation(*args)


@pytest.mark.parametrize("entry", ["hash32_partition", "bitonic_sort_permutation"])
def test_new_entries_on_cpu_launch_nothing(entry):
    """A CPU tensor takes the plain version through the wrapper and the seam,
    inside ``oracle_scope()`` or not; no launch is counted."""
    fn = {"hash32_partition": hash32_partition,
          "bitonic_sort_permutation": bitonic_sort_permutation}[entry]
    before = fn.launches
    x = torch.arange(300, dtype=torch.int32)
    rc = torch.tensor(200, dtype=torch.int32)
    if entry == "hash32_partition":
        outs = [fn([x], rc, 8, 3), tops.hash_partition_ids([x], rc, 8, 3)]
        with tops.oracle_scope():
            outs.append(tops.hash_partition_ids([x], rc, 8, 3))
        want = tref.hash_partition_ids_ref([x], rc, 8, 3)
    else:
        outs = [fn(x, rc), tops.bitonic_sort_permutation(x, rc)]
        with tops.oracle_scope():
            outs.append(tops.bitonic_sort_permutation(x, rc))
        want = tref.sort_permutation_ref(x, rc)
    assert all(torch.equal(o, want) for o in outs)
    assert fn.launches == before


# --- histogram ----------------------------------------------------------------


@pytest.mark.parametrize("n,buckets", [
    (1, 2), (100, 7), (5000, 8), (4096, 256),
    # P around the register path's 8 buckets and beyond; n of 1, 3, 4, 5
    # and around one block's unrolled step
    (1, 1), (3, 9), (4, 17), (5, 64), (HIST_STEP - 1, 1), (HIST_STEP, 9),
    (HIST_STEP + 1, 17), (HIST_STEP + 5, 64)])
def test_histogram_plain_matches_pallas_and_ref(n, buckets):
    ids = _rng(n).integers(-3, buckets + 3, n).astype(np.int32)
    got = bucket_histogram(torch.from_numpy(ids), buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_hist(jnp.asarray(ids), buckets)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.histogram_ref(jnp.asarray(ids), buckets)))


# --- bitonic / sort_pairs -------------------------------------------------------


@pytest.mark.parametrize("tile,n,kind", [(256, 768, "int32"),
                                         (512, 512, "float32"),
                                         (256, 256, "u32")])
def test_bitonic_plain_matches_pallas(tile, n, kind):
    r = _rng(tile + n)
    if kind == "float32":
        k = r.integers(-20, 20, n).astype(np.float32)  # duplicates
        k[:2] = [0.0, -0.0]
    elif kind == "int32":
        k = r.integers(-20, 20, n).astype(np.int32)
        k[0] = np.iinfo(np.int32).max
    else:
        k = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        k[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 0]
    v = r.permutation(n).astype(np.int32)  # distinct payloads
    if kind == "u32":  # the path's keys, in the int64 holder: the wrapper
        ko, vo = bitonic_sort_tiles(torch.from_numpy(k.astype(np.int64)),
                                    torch.from_numpy(v), tile=tile)
    else:  # the kernel takes int64 keys only; the plain version any dtype
        ko, vo = tref.sort_tiles_ref(torch.from_numpy(k), torch.from_numpy(v), tile)
    jk, jv = j_bitonic(jnp.asarray(k), jnp.asarray(v), tile=tile)
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ko.numpy(), np.asarray(jk).astype(ko.numpy().dtype))


@pytest.mark.parametrize("n", [100, 3000])
def test_sort_pairs_matches_reference(n):
    r = _rng(n)
    k = r.integers(0, 50, n).astype(np.uint32)  # no max key: see ops_local tests
    v = np.arange(n, dtype=np.int32)
    ko, vo = tops.sort_pairs(torch.from_numpy(k.astype(np.int64)), torch.from_numpy(v))
    jk, jv = jops.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ko.numpy(), np.asarray(jk).astype(np.int64))


def test_sort_pairs_keeps_a_max_key_row():
    # the padding sorts after every real pair, even one holding the key max
    k = np.full(300, 5, np.int64)
    k[5] = 0xFFFFFFFF
    ko, vo = tops.sort_pairs(torch.from_numpy(k), torch.arange(300, dtype=torch.int32))
    np.testing.assert_array_equal(vo.numpy(), np.argsort(k, kind="stable"))
    assert ko[-1].item() == 0xFFFFFFFF


def test_bitonic_rejects_bad_tiles():
    v = torch.zeros(300, dtype=torch.int32)
    with pytest.raises(ValueError):
        bitonic_sort_tiles(torch.zeros(300, dtype=torch.int64), v, tile=300)
    with pytest.raises(ValueError):
        bitonic_sort_tiles(torch.zeros(128, dtype=torch.int64),
                           torch.zeros(128, dtype=torch.int32), tile=128)
    with pytest.raises(TypeError):  # int64 keys only
        bitonic_sort_tiles(torch.zeros(256, dtype=torch.int32),
                           torch.zeros(256, dtype=torch.int32), tile=256)


# --- segment_reduce -------------------------------------------------------------


@pytest.mark.parametrize("n,g", [(1, 1), (700, 37), (3000, 1025)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_reduce_plain_matches_pallas(n, g, op, dtype, sorted_ids):
    r = _rng(n + g)
    vals = r.integers(-1000, 1000, n).astype(dtype)  # integer-valued: exact
    seg = r.integers(-2, g + 2, n).astype(np.int32)  # some out of range
    if sorted_ids:
        seg = np.sort(seg)
    got = segment_reduce_tiles(torch.from_numpy(vals), torch.from_numpy(seg), g, op)
    pallas = j_seg(jnp.asarray(vals), jnp.asarray(seg), g, op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    via_ops = tops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), g, op)
    np.testing.assert_array_equal(
        via_ops.numpy(),
        np.asarray(jops.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), g, op,
                                       use_kernel=False)))


# groupby's layout (sorted runs, then a -1 tail) around the CUDA kernel's
# 4096-row tiles: the tail starting mid-tile, just before and just after a
# tile edge, exactly on one, or absent
@pytest.mark.parametrize("n,tail", [(4096 + 700, 4096 - 300), (4097, 4095),
                                    (2 * 4096 + 5, 4096 + 1), (8192, 4096),
                                    (300, 120), (4096, 4096)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_reduce_plain_matches_pallas_on_groupby_layout(n, tail, op, dtype):
    r = _rng(n + tail)
    g = 37
    vals = r.integers(-1000, 1000, n).astype(dtype)
    seg = np.concatenate([np.sort(r.integers(0, g, tail)),
                          np.full(n - tail, -1)]).astype(np.int32)
    got = segment_reduce_tiles(torch.from_numpy(vals), torch.from_numpy(seg), g, op,
                               contiguous_runs=True)
    pallas = j_seg(jnp.asarray(vals), jnp.asarray(seg), g, op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_segment_reduce_nd_payload_takes_plain_scatter():
    r = _rng(9)
    vals = r.integers(-9, 9, (200, 3)).astype(np.float32)
    seg = np.sort(r.integers(-1, 20, 200)).astype(np.int32)
    for op in ("sum", "min", "max"):
        got = tops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), 20, op)
        want = jops.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 20, op)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), 20,
                            use_kernel=True)


def _seam_recorder(monkeypatch):
    """Replace the kernel wrapper the seam calls by one that records each
    call's values dtype and run promise and returns the plain version."""
    from repro_torch.kernels import segment_reduce as seg

    calls = []

    def record(values, seg_ids, num_segments, op="sum", *, contiguous_runs=False):
        calls.append((values.dtype, values.device.type, contiguous_runs))
        return tref.segment_reduce_ref(values, seg_ids, num_segments, op)

    monkeypatch.setattr(seg, "segment_reduce_tiles", record)
    return calls


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_seam_sends_1d_float64_to_the_kernel(monkeypatch,
                                                            use_kernel, op):
    calls = _seam_recorder(monkeypatch)
    r = _rng(12)
    seg = torch.from_numpy(np.sort(r.integers(-1, 30, 500)).astype(np.int32))
    for dtype in (torch.float64, torch.float32, torch.int32):
        vals = torch.from_numpy(r.integers(-50, 50, 500)).to(dtype)
        got = tops.segment_reduce(vals, seg, 30, op, use_kernel=use_kernel,
                                  contiguous_runs=True)
        assert torch.equal(got, tref.segment_reduce_ref(vals, seg, 30, op))
    assert calls == [(torch.float64, "cpu", True), (torch.float32, "cpu", True),
                     (torch.int32, "cpu", True)]
    with tops.oracle_scope():
        tops.segment_reduce(vals.double(), seg, 30, op, use_kernel=use_kernel)
    assert len(calls) == 3


def test_segment_reduce_use_kernel_takes_1d_float64():
    r = _rng(13)
    vals = torch.from_numpy(r.standard_normal(700))
    seg = torch.from_numpy(r.integers(-2, 40, 700).astype(np.int32))
    for op in ("sum", "min", "max"):
        got = tops.segment_reduce(vals, seg, 40, op, use_kernel=True)
        assert got.dtype == torch.float64
        assert torch.equal(got, tref.segment_reduce_ref(vals, seg, 40, op))
        assert torch.equal(segment_reduce_tiles(vals, seg, 40, op), got)


@pytest.mark.parametrize("shape,dtype", [((300, 2), torch.float64),
                                         ((300,), torch.int64),
                                         ((300, 3), torch.float32)])
def test_segment_reduce_nd_and_int64_stay_plain(monkeypatch, shape, dtype):
    calls = _seam_recorder(monkeypatch)
    r = _rng(14)
    vals = torch.from_numpy(r.integers(-9, 9, shape)).to(dtype)
    seg = torch.from_numpy(np.sort(r.integers(-1, 25, 300)).astype(np.int32))
    for op in ("sum", "min", "max"):
        with pytest.raises(ValueError, match="f32/i32/f64"):
            tops.segment_reduce(vals, seg, 25, op, use_kernel=True)
        got = tops.segment_reduce(vals, seg, 25, op)
        assert torch.equal(got, tref.segment_reduce_ref(vals, seg, 25, op))
    assert calls == []
    with pytest.raises(TypeError, match="f32/i32/f64"):
        segment_reduce_tiles(vals, seg, 25)


def test_segment_reduce_plain_calls_counts_the_plain_route(monkeypatch):
    # meta tensors stand for a card's here: the count skips the CPU, whose
    # kernel route is the plain version too
    calls = _seam_recorder(monkeypatch)
    seg = torch.zeros(64, dtype=torch.int32, device="meta")
    before = tops.segment_reduce.plain_calls
    for dtype in (torch.float64, torch.float32, torch.int32):
        tops.segment_reduce(torch.zeros(64, dtype=dtype, device="meta"), seg, 8)
    assert len(calls) == 3 and tops.segment_reduce.plain_calls == before
    tops.segment_reduce(torch.zeros(64, 2, dtype=torch.float64, device="meta"),
                        seg, 8)
    tops.segment_reduce(torch.zeros(64, dtype=torch.int64, device="meta"), seg,
                        8, "max")
    tops.segment_reduce(torch.zeros(64, dtype=torch.float64, device="meta"), seg,
                        8, use_kernel=False)
    assert tops.segment_reduce.plain_calls == before + 3
    with tops.oracle_scope():  # the recovery rung is a request, not a miss
        tops.segment_reduce(torch.zeros(64, dtype=torch.int64, device="meta"),
                            seg, 8)
    tops.segment_reduce(torch.zeros(64, dtype=torch.int64),
                        torch.zeros(64, dtype=torch.int32), 8)
    assert tops.segment_reduce.plain_calls == before + 3
    assert len(calls) == 3


def test_seg_init_matches_reference():
    for op in ("sum", "min", "max"):
        for t, j in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
            assert tref.seg_init(op, t) == jref.seg_init(op, j).item()


# --- segment_scan ---------------------------------------------------------------


def _scan_ids(n, seed, tail=True):
    """Sorted segment ids (runs of random length), then a -1 tail."""
    r = _rng(seed)
    ids = np.sort(r.integers(0, max(1, n // 9), n)).astype(np.int32)
    if tail:
        ids[n - n // 4:] = -1
    return ids


# n around the CUDA kernel's tile (SCAN_TILE rows)
@pytest.mark.parametrize("n", [1, 1000, 3000, SCAN_TILE - 1, SCAN_TILE + 1])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("inclusive", [True, False])
def test_segment_scan_plain_matches_pallas_and_ref(n, op, dtype, inclusive):
    vals = _rng(n).integers(-1000, 1000, n).astype(dtype)  # integer-valued
    if dtype == np.float32 and op != "sum" and n > 10:
        vals[[3, n // 2]] = np.nan  # min/max propagate NaN
    seg = _scan_ids(n, seed=n + 1)
    got = segment_scan_tiles(torch.from_numpy(vals), torch.from_numpy(seg), op,
                             inclusive=inclusive)
    assert got.dtype == torch.from_numpy(vals).dtype
    pallas = j_scan(jnp.asarray(vals), jnp.asarray(seg), op, inclusive=inclusive,
                    interpret=True)
    oracle = jref.segment_scan_ref(jnp.asarray(vals), jnp.asarray(seg), op,
                                   inclusive)
    bits = np.int32 if dtype == np.float32 else dtype
    for want in (pallas, oracle):
        np.testing.assert_array_equal(got.numpy().view(bits),
                                      np.asarray(want).view(bits))
    via_ops = tops.segment_scan(torch.from_numpy(vals), torch.from_numpy(seg), op,
                                inclusive=inclusive, use_kernel=False)
    np.testing.assert_array_equal(via_ops.numpy().view(bits), got.numpy().view(bits))


def test_segment_scan_int32_sum_wraps_like_the_reference():
    vals = np.full(64, 2**30, np.int32)
    seg = np.zeros(64, np.int32)
    got = tops.segment_scan(torch.from_numpy(vals), torch.from_numpy(seg), "sum")
    want = jref.segment_scan_ref(jnp.asarray(vals), jnp.asarray(seg), "sum")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_scan_seam_checks():
    v = torch.zeros(8, 2)
    seg = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # N-D values: no kernel
        tops.segment_scan(v, seg, "sum", use_kernel=True)
    with pytest.raises(ValueError):
        tops.segment_scan(v[:, 0], seg[:4], "sum")
    with pytest.raises(ValueError):
        tops.segment_scan(v[:, 0], seg, "prod")
    with pytest.raises(TypeError):  # the kernel takes f32/i32 only
        segment_scan_tiles(torch.zeros(8, dtype=torch.int64), seg)
    with pytest.raises(TypeError):  # int32 ids of the values' shape
        segment_scan_tiles(v[:, 0], seg.to(torch.int64))
    # the plain scan takes any dtype
    got = tops.segment_scan(torch.arange(6, dtype=torch.int64),
                            torch.tensor([0, 0, 1, 1, 1, -1], dtype=torch.int32),
                            "sum")
    assert got.tolist() == [0, 1, 2, 5, 9, 5]


# --- flash attention -------------------------------------------------------------


def _qkv(b, s, h, kv, hd, seed, scale=1.0):
    r = _rng(seed)
    return (r.standard_normal((b, s, h, hd)) * scale,
            r.standard_normal((b, s, kv, hd)) * scale,
            r.standard_normal((b, s, kv, hd)))


@pytest.mark.parametrize("shape", [
    # (B, S, H, KV, hd, bq, bk): tests/test_kernels.py's sweep
    (2, 256, 4, 2, 64, 128, 128),
    (1, 512, 8, 8, 32, 256, 128),
    (1, 256, 4, 1, 128, 128, 256),
    # S around the CUDA kernel's 128-row tiles (one block of S rows here)
    (1, 127, 4, 2, 64, 128, 128),
    (1, 129, 4, 1, 128, 512, 512),
    # the other head dims the CUDA kernels take: the TINY configs' 16 and
    # stablelm-12b's 160, at S a multiple of the Pallas kernel's blocks
    (2, 128, 4, 2, 16, 128, 128),
    (1, 256, 4, 1, 160, 128, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref(shape, causal):
    b, s, h, kv, hd, bq, bk = shape
    q, k, v = (x.astype(np.float32) for x in _qkv(b, s, h, kv, hd, seed=s + hd))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    pallas = j_flash(*map(jnp.asarray, (q, k, v)), causal=causal, bq=bq, bk=bk)
    oracle = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv(1, 256, 4, 2, 64, seed=9)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    got = flash_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                            .to(torch.bfloat16) for x in bf), causal=True)
    assert got.dtype == torch.bfloat16
    want = j_flash(*bf, causal=True, bq=128, bk=128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_flash_wrapper_checks_and_seam():
    q = torch.zeros(1, 5, 4, 16)
    k = torch.zeros(1, 5, 3, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)  # 4 query heads over 3 KV heads
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :4], q[:, :4])  # not self-attention
    # the CPU takes the plain version at any head dim (the tiny configs' 16)
    q, k, v = (torch.from_numpy(x.astype(np.float32))
               for x in _qkv(2, 7, 4, 2, 16, seed=3))
    before = flash_attention.launches
    want = tref.attention_ref(q, k, v, causal=True)
    assert torch.equal(flash_attention(q, k, v), want)
    assert torch.equal(tops.attention(q, k, v), want)
    with tops.oracle_scope():
        assert torch.equal(tops.attention(q, k, v, causal=False),
                           tref.attention_ref(q, k, v, causal=False))
    assert flash_attention.launches == before
    # S == 1, causal: the one key's value
    assert torch.allclose(flash_attention(q[:, :1], k[:, :1], v[:, :1]),
                          v[:, :1].repeat_interleave(2, dim=2))


# --- devices, counters, oracle scope ------------------------------------------


def test_cpu_tensors_launch_nothing_and_oracle_scope_nests():
    before = (hash32.launches, bucket_histogram.launches,
              bitonic_sort_tiles.launches, segment_reduce_tiles.launches,
              segment_scan_tiles.launches, flash_attention.launches)
    x = torch.arange(10, dtype=torch.int32)
    assert not tops.oracle_only()
    with tops.oracle_scope():
        with tops.oracle_scope():
            assert tops.oracle_only()
        assert tops.oracle_only()
        tops.hash_columns([x])
    assert not tops.oracle_only()
    tops.bucket_histogram(x, 4)
    tops.segment_scan(x, torch.zeros(10, dtype=torch.int32), "max")
    tops.attention(torch.zeros(1, 3, 2, 8), torch.zeros(1, 3, 1, 8),
                   torch.zeros(1, 3, 1, 8))
    assert before == (hash32.launches, bucket_histogram.launches,
                      bitonic_sort_tiles.launches, segment_reduce_tiles.launches,
                      segment_scan_tiles.launches, flash_attention.launches)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so 'cuda' resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# --- on the card: kernel against plain -----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_cuda_hash32_matches_plain(cuda, dtype):
    x = torch.from_numpy(_column(dtype, 100_003, seed=1)).to(cuda)
    for seed in (0, 7):
        torch.testing.assert_close(hash32(x, seed), tref.hash32_ref(x, seed),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_histogram_matches_plain(cuda):
    r = _rng(2)
    ids = torch.from_numpy(r.integers(-1, 8, 1 << 20).astype(np.int32)).to(cuda)
    for p in (8, 1000, 20000):
        assert torch.equal(bucket_histogram(ids, p), tref.histogram_ref(ids, p))
    # P on both sides of the register path's 8 buckets (ids over [-1, P]);
    # n of 1, 3, 4, 5 and around one block's unrolled step and the grid's;
    # views at offsets 1-3; every id out of range; three calls in a row,
    # of changing n and P (the last-block ticket is back at 0 after each)
    grid = (HIST_STEP * _cu_constant("histogram.cu", "kRegBlocksPerSM")
            * torch.cuda.get_device_properties(cuda).multi_processor_count)
    for p in (1, 7, 8, 9, 16, 17, 64, 1000, 20000):
        for n in (1, 3, 4, 5, HIST_STEP - 1, HIST_STEP, HIST_STEP + 1, grid - 1,
                  grid + 1, 2 * grid + 5):
            x = torch.from_numpy(r.integers(-1, p + 1, n).astype(np.int32)).to(cuda)
            want = tref.histogram_ref(x, p)
            for _ in range(3):
                assert torch.equal(bucket_histogram(x, p), want), (p, n)
    base = torch.from_numpy(r.integers(-1, 9, 100_008).astype(np.int32)).to(cuda)
    for off in (1, 2, 3):
        for n in (100_000, 99_995, 2, 7):
            x = base[off:off + n]
            for p in (8, 17):
                assert torch.equal(bucket_histogram(x, p), tref.histogram_ref(x, p))
    for fill in (-1, 8):
        x = torch.full((100_001,), fill, dtype=torch.int32, device=cuda)
        assert torch.equal(bucket_histogram(x, 8), tref.histogram_ref(x, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_cuda_bitonic_matches_plain(cuda, tile):
    r = _rng(tile)
    n = 4 * tile
    for keys in (r.integers(0, 9, n).astype(np.int64),
                 r.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)):
        k = torch.from_numpy(keys).to(cuda)
        v = torch.from_numpy(r.permutation(n).astype(np.int32)).to(cuda)
        ko, vo = bitonic_sort_tiles(k, v, tile=tile)
        rk, rv = tref.sort_tiles_ref(k, v, tile)
        assert torch.equal(vo, rv) and torch.equal(ko, rk)


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 3])
def test_cuda_hash32_partition_matches_plain(cuda, ncols):
    n = 100_003
    cols = [torch.from_numpy(_column(dt, n + 3, seed=i)).to(cuda)
            for i, dt in enumerate((np.float32, np.int32, np.uint32)[:ncols])]
    for off in (0, 1, 3):  # aligned, and views that take the scalar path
        cs = [c[off:off + n] for c in cols]
        for p in (1, 7, 8, 4096):
            for rc in (0, 1, n // 2, n):
                r = torch.tensor(rc, dtype=torch.int32, device=cuda)
                assert torch.equal(hash32_partition(cs, r, p, 7),
                                   tref.hash_partition_ids_ref(cs, r, p, 7)), \
                    (off, p, rc)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 255, 256, 300, 2047, 2048])
def test_cuda_bitonic_sort_permutation_matches_plain(cuda, c):
    r = _rng(c)
    f = r.integers(-9, 9, c).astype(np.float32)
    f[:min(3, c)] = np.array([0.0, -0.0, np.nan], np.float32)[:min(3, c)]
    i = r.integers(-9, 9, c).astype(np.int32)
    i[c // 2] = np.iinfo(np.int32).max  # the u32 max key
    u = r.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    for x in (f, i, u):
        k = torch.from_numpy(x).to(cuda)
        for rc in sorted({0, 1, c // 2, c}):
            row_count = torch.tensor(rc, dtype=torch.int32, device=cuda)
            assert torch.equal(bitonic_sort_permutation(k, row_count),
                               tref.sort_permutation_ref(k, row_count)), (x.dtype, rc)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [256, 512, 1024, 2048, 4096])
def test_cuda_bitonic_tile_edges_match_plain(cuda, tile):
    """Keys above the u32 range, all keys equal, keys descending, and
    repeated payloads, at every tile size."""
    r = _rng(tile + 1)
    n = 3 * tile
    for keys in (r.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                 np.full(n, 2**40, np.int64),
                 np.arange(n, 0, -1, dtype=np.int64) * 2**33):
        k = torch.from_numpy(keys).to(cuda)
        for pay in (r.integers(0, 5, n), r.permutation(n)):
            v = torch.from_numpy(pay.astype(np.int32)).to(cuda)
            ko, vo = bitonic_sort_tiles(k, v, tile=tile)
            rk, rv = tref.sort_tiles_ref(k, v, tile)
            assert torch.equal(ko, rk) and torch.equal(vo, rv)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 1024, 1025, 1 << 20])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_segment_reduce_matches_plain(cuda, g, op):
    r = _rng(g)
    n = 1 << 20
    for dtype in (np.float32, np.int32, np.float64):
        vals = torch.from_numpy(r.integers(-99, 99, n).astype(dtype)).to(cuda)
        for ids in (np.sort(r.integers(-1, g + 1, n)), r.integers(-1, g + 1, n)):
            seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
            assert torch.equal(segment_reduce_tiles(vals, seg, g, op),
                               tref.segment_reduce_ref(vals, seg, g, op))
        # groupby's layout: sorted runs, then a -1 tail, passed as runs
        ids = np.concatenate([np.sort(r.integers(0, g, n - n // 8)),
                              np.full(n // 8, -1)])
        seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
        assert torch.equal(
            segment_reduce_tiles(vals, seg, g, op, contiguous_runs=True),
            tref.segment_reduce_ref(vals, seg, g, op))
    # around the kernel's 4096-row tiles: runs that end exactly at tile
    # edges, one row before and one after; a -1 tail from mid-tile; one run
    # over every row; every row out of range
    tile = 4096
    for m in (tile - 1, tile, tile + 1, 5 * tile + 3):
        layouts = [np.zeros(m), np.full(m, -1),
                   np.where(np.arange(m) < m - m // 3 - 5,
                            np.sort(r.integers(0, g, m)), -1)]
        for shift in (-1, 0, 1):
            layouts.append(np.minimum((np.arange(m) - shift) // tile, g - 1)
                           .clip(0))
        for dtype in (np.float32, np.int32, np.float64):
            vals = torch.from_numpy(r.integers(-99, 99, m).astype(dtype)).to(cuda)
            for ids in layouts:
                seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
                got = segment_reduce_tiles(vals, seg, g, op, contiguous_runs=True)
                assert torch.equal(got, tref.segment_reduce_ref(vals, seg, g, op))
                assert torch.equal(got, segment_reduce_tiles(vals, seg, g, op,
                                                             contiguous_runs=True))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_segment_reduce_float64(cuda, op):
    """The float64 instance on non-integer data: sums within 1e-12 of the
    plain version relative to the sum of |values| (both fold in float64, in
    other orders), the same bits on a second run; NaN and +-inf through min
    and max as the float32 instance treats them; the fill at segment counts
    that no 16-byte store of two doubles divides."""
    r = _rng(21)
    tile = 4096
    n = 5 * tile + 3
    ids = np.concatenate([np.sort(r.integers(0, 700, n - n // 3)),
                          np.full(n // 3, -1)]).astype(np.int32)
    seg = torch.from_numpy(ids).to(cuda)
    vals = r.standard_normal(n) * 10.0 ** r.integers(-3, 4, n)
    if op != "sum":
        vals[[5, tile - 1, tile, 2 * tile + 900]] = np.nan
        vals[[17, 3 * tile + 1]] = np.inf
        vals[[40, 4 * tile + 2]] = -np.inf
    v = torch.from_numpy(vals).to(cuda)
    got = segment_reduce_tiles(v, seg, 700, op, contiguous_runs=True)
    assert got.dtype == torch.float64
    assert torch.equal(got.view(torch.int64),
                       segment_reduce_tiles(v, seg, 700, op,
                                            contiguous_runs=True).view(torch.int64))
    want = tref.segment_reduce_ref(v, seg, 700, op)
    if op == "sum":
        scale = tref.segment_reduce_ref(v.abs(), seg, 700, "sum").clamp(min=1e-300)
        assert float(((got - want).abs() / scale).max()) <= 1e-12
    else:
        nan_seg = tref.segment_reduce_ref(torch.isnan(v).to(torch.int32), seg,
                                          700, "sum") > 0
        assert torch.equal(torch.isnan(got), nan_seg)
        assert torch.equal(got[~nan_seg], want[~nan_seg])
    # the fill alone (no rows) and with a few rows, at G = 2k + 1, 4k + 1..3
    for g in (1, 2, 3, 5, 6, 7, 1025, 4099):
        empty = torch.zeros(0, dtype=torch.float64, device=cuda)
        got = segment_reduce_tiles(empty, seg[:0], g, op)
        assert torch.equal(got, tref.segment_reduce_ref(empty, seg[:0], g, op))
        few = torch.arange(g, 0, -1, dtype=torch.int32, device=cuda) - 1
        fv = torch.from_numpy(r.integers(-99, 99, g).astype(np.float64)).to(cuda)
        assert torch.equal(segment_reduce_tiles(fv, few, g, op),
                           tref.segment_reduce_ref(fv, few, g, op))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_segment_scan_matches_plain(cuda, op):
    r = _rng(5)
    # block edges (4096 rows a block), one run across many blocks, all
    # singletons, random runs with a -1 tail starting mid-block
    for n in (4095, 4096, 4097, (1 << 22) + 3):
        for ids in (np.zeros(n), np.arange(n), _scan_ids(n, seed=n)):
            seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
            for dtype in (np.float32, np.int32):
                vals = r.integers(-99, 99, n).astype(dtype)
                if dtype == np.float32 and op != "sum":
                    vals[r.integers(0, n, 3)] = np.nan
                v = torch.from_numpy(vals).to(cuda)
                for inclusive in (True, False):
                    got = segment_scan_tiles(v, seg, op, inclusive=inclusive)
                    want = tref.segment_scan_ref(v, seg, op, inclusive)
                    bits = torch.int32
                    assert torch.equal(got.view(bits), want.view(bits)), \
                        (n, dtype, inclusive)
    # the single-pass kernel's edges: n around its tile and runs that end at
    # tile edges, one row before and one after; views at offsets 1-3 of ids
    # and values (and at different offsets); two calls in a row on
    # different n; n = 1
    tile = SCAN_TILE

    def exact(v, seg):
        for inclusive in (True, False):
            got = segment_scan_tiles(v, seg, op, inclusive=inclusive)
            want = tref.segment_scan_ref(v, seg, op, inclusive)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    for n in (1, tile - 1, tile, tile + 1, 5 * tile + 3):
        for shift in (-1, 0, 1):
            seg = torch.from_numpy(np.clip((np.arange(n) - shift) // tile, 0, None)
                                   .astype(np.int32)).to(cuda)
            for dtype in (np.float32, np.int32):
                exact(torch.from_numpy(r.integers(-99, 99, n).astype(dtype)).to(cuda),
                      seg)
    n = 3 * tile + 50
    ids = torch.from_numpy(_scan_ids(n + 8, seed=7)).to(cuda)
    for dtype in (np.float32, np.int32):
        vals = torch.from_numpy(r.integers(-99, 99, n + 8).astype(dtype)).to(cuda)
        for oi, ov in ((1, 1), (2, 2), (3, 3), (1, 2), (0, 3)):
            for m in (n, 6, 1):
                exact(vals[ov:ov + m], ids[oi:oi + m])
        for m in (n, tile + 1, n):
            exact(vals[:m], ids[:m])


@pytest.mark.cuda
def test_cuda_segment_scan_float_sums_same_bits(cuda):
    # standard-normal f32 sums over one run through more than 4096 tiles and
    # a sorted layout with a -1 tail: the same bits on 5 runs (the carry is
    # the left fold of the tile aggregates, wherever a look-back stops), and
    # within 0.5 of the plain version in float64 (chip_smoke's SCAN_F32_TOL)
    r = _rng(8)
    n = 4097 * SCAN_TILE + 5
    for ids in (np.zeros(n, np.int32), _scan_ids(n, seed=9)):
        seg = torch.from_numpy(ids).to(cuda)
        v = torch.from_numpy(r.standard_normal(n).astype(np.float32)).to(cuda)
        runs = [segment_scan_tiles(v, seg, "sum").view(torch.int32) for _ in range(5)]
        assert all(torch.equal(runs[0], x) for x in runs[1:])
        err = (runs[0].view(torch.float32).double()
               - tref.segment_scan_ref(v.double(), seg, "sum")).abs().max()
        assert float(err) <= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [hd for hd, dv in KERNEL_HEAD_DIMS if hd == dv])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol, hd):
    # S at and around the bf16 kernel's 128-row tiles and the fp32 one's
    # 64-row tiles, group sizes 1 and 4, causal or not
    for s in (1, 63, 64, 65, 127, 128, 129, 255, 1023, 1024):
        for h, kv in ((4, 4), (8, 2)):
            q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda, dtype)
                       for x in _qkv(2, s, h, kv, hd, seed=s))
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = tref.attention_ref(q, k, v, causal=causal)
                torch.testing.assert_close(got, want, atol=tol, rtol=tol)
                assert torch.equal(got, flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,dv", [(96, 64), (24, 16)])
def test_cuda_flash_mla_width_pairs_match_plain(cuda, dtype, tol, hd, dv):
    # MLA's (q k, p v) width pairs: the serving and LSE entries against the
    # plain version (the LSE's out bit-equal to the serving entry's), the
    # backward against autograd through it by chip_smoke.py's per-tile
    # check, at S around the tiles, group sizes 1 and 4, causal or not
    import importlib.util

    from repro_torch.kernels import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for s in (1, 63, 64, 65, 127, 128, 129, 1025):
        for h, kv in ((4, 4), (8, 2)):
            r = _rng(s + hd)
            q, k, v, do = (torch.from_numpy(r.standard_normal(shape).astype(
                np.float32)).to(cuda, dtype) for shape in (
                (2, s, h, hd), (2, s, kv, hd), (2, s, kv, dv), (2, s, h, dv)))
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = tref.attention_ref(q, k, v, causal=causal)
                assert got.shape == (2, s, h, dv)
                torch.testing.assert_close(got, want, atol=tol, rtol=tol)
                o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
                assert torch.equal(o, got)
                grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                errs = smoke.bwd_errors(grads, tref.attention_bwd_ref(
                    q, k, v, do, causal=causal), dtype)
                assert all(e["excess"] <= 1.0 for e in errs.values()), errs


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    # the library is named by a hash of the sources and of the headers they
    # include, so an edit to a header alone builds a new one; nvcc compiles
    # the *.cu sources only
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.headers()] == ["sm90.cuh"]
    assert _build.sources() and all(p.suffix == ".cu" for p in _build.sources())
    before = _build.library_path()
    header = csrc / "sm90.cuh"
    text = header.read_bytes()
    header.write_bytes(text + b"\n")
    edited = _build.library_path()
    assert edited != before and edited.parent == before.parent
    header.write_bytes(text)
    assert _build.library_path() == before
