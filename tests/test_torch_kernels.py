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
from repro_torch.kernels.bitonic import bitonic_sort_tiles  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.hash64 import hash32  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402
from repro_torch.kernels.segment_scan import segment_scan_tiles  # noqa: E402
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


@pytest.mark.parametrize("n", [1, 1000, 3000])
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
        for dtype in (np.float32, np.int32):
            vals = torch.from_numpy(r.integers(-99, 99, m).astype(dtype)).to(cuda)
            for ids in layouts:
                seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
                got = segment_reduce_tiles(vals, seg, g, op, contiguous_runs=True)
                assert torch.equal(got, tref.segment_reduce_ref(vals, seg, g, op))
                assert torch.equal(got, segment_reduce_tiles(vals, seg, g, op,
                                                             contiguous_runs=True))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [64, 128])
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
