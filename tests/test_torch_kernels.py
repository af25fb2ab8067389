"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU every wrapper takes its plain PyTorch version; those are held
against the Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them) and against ``repro.kernels.ref``. Inputs come from numpy with a
seed. Tolerance: exact everywhere (integer kernels, and float sums on
integer-valued data). The cases marked ``cuda`` hold each CUDA kernel
against its plain version on the card and skip without one.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_tiles as j_bitonic  # noqa: E402
from repro.kernels.hash64 import hash32 as j_hash32  # noqa: E402
from repro.kernels.histogram import bucket_histogram as j_hist  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce_tiles as j_seg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.bitonic import bitonic_sort_tiles  # noqa: E402
from repro_torch.kernels.hash64 import hash32  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


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


# --- histogram ----------------------------------------------------------------


@pytest.mark.parametrize("n,buckets", [(1, 2), (100, 7), (5000, 8), (4096, 256)])
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


def test_seg_init_matches_reference():
    for op in ("sum", "min", "max"):
        for t, j in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
            assert tref.seg_init(op, t) == jref.seg_init(op, j).item()


# --- devices, counters, oracle scope ------------------------------------------


def test_cpu_tensors_launch_nothing_and_oracle_scope_nests():
    before = (hash32.launches, bucket_histogram.launches,
              bitonic_sort_tiles.launches, segment_reduce_tiles.launches)
    x = torch.arange(10, dtype=torch.int32)
    assert not tops.oracle_only()
    with tops.oracle_scope():
        with tops.oracle_scope():
            assert tops.oracle_only()
        assert tops.oracle_only()
        tops.hash_columns([x])
    assert not tops.oracle_only()
    tops.bucket_histogram(x, 4)
    assert before == (hash32.launches, bucket_histogram.launches,
                      bitonic_sort_tiles.launches, segment_reduce_tiles.launches)


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
    ids = torch.from_numpy(_rng(2).integers(-1, 8, 1 << 20).astype(np.int32)).to(cuda)
    for p in (8, 1000, 20000):
        assert torch.equal(bucket_histogram(ids, p), tref.histogram_ref(ids, p))


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
@pytest.mark.parametrize("g", [1, 1024, 1025, 1 << 20])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_segment_reduce_matches_plain(cuda, g, op):
    r = _rng(g)
    n = 1 << 20
    for dtype in (np.float32, np.int32):
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
