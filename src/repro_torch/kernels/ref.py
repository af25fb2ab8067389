"""Plain PyTorch versions of every kernel in this package.

These are the semantics contract, the port's counterpart of
``repro/kernels/ref.py``: the CPU path of each kernel wrapper, the oracle the
CUDA kernels are held against on the card, and exactly equal to the JAX
package's oracles on every input the tests use.

32-bit unsigned values (hashes, ``ordered_u32`` sort keys) are held in
**int64 tensors with values in [0, 2**32)**: torch has no ``>>`` or ``%`` for
uint32 on the CPU, and int64 orders them as unsigned 32-bit numbers, so
``torch.sort``/``torch.searchsorted`` work on them unchanged.
"""
from __future__ import annotations

import math

import torch

U32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

# ---------------------------------------------------------------------------
# murmur3 fmix32 column hash
# ---------------------------------------------------------------------------


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of an int32/uint32/float32 column as int64 in
    [0, 2**32)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & U32
    if x.dtype in (torch.int32, torch.uint32):
        return x.to(torch.int64) & U32
    raise TypeError(f"unsupported hash input dtype {x.dtype}")


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for a in [0, 2**32), without int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on u32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash32_ref(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash a column of int32/uint32/float32 to u32 (int64 holder).
    Floats hash by bit pattern, so -0.0 != 0.0."""
    return fmix32(as_u32(x) ^ (seed & U32))


def hash_combine_ref(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """boost::hash_combine on u32 values held in int64."""
    s = (h2 + _GOLDEN + ((h1 << 6) & U32) + (h1 >> 2)) & U32
    return h1 ^ s


def hash_partition_ids_ref(columns: list[torch.Tensor], row_count: torch.Tensor,
                           num_partitions: int, seed: int = 0) -> torch.Tensor:
    """Hash partition's per-row destination, (n,) int32: the columns'
    combined u32 hash ``% num_partitions``, -1 at rows ``>= row_count``
    (``repro.core.ops_local.hash_partition``'s pid)."""
    h = hash32_ref(columns[0], seed)
    for c in columns[1:]:
        h = hash_combine_ref(h, hash32_ref(c, seed))
    pid = (h % num_partitions).to(torch.int32)
    valid = torch.arange(h.shape[0], device=h.device) < row_count
    return torch.where(valid, pid, -1)


# ---------------------------------------------------------------------------
# bucket histogram
# ---------------------------------------------------------------------------


def histogram_ref(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Count of ids per bucket; ids outside [0, num_buckets) are ignored."""
    valid = (ids >= 0) & (ids < num_buckets)
    slot = torch.where(valid, ids.to(torch.int64), num_buckets)
    out = torch.zeros(num_buckets + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return out[:num_buckets]


# ---------------------------------------------------------------------------
# key + payload sorts
# ---------------------------------------------------------------------------


def sort_pairs_ref(keys: torch.Tensor, payload: torch.Tensor):
    """Ascending stable sort of (keys, payload) by key alone (the
    ``lax.sort(num_keys=1)`` oracle)."""
    k, perm = torch.sort(keys, stable=True)
    return k, payload[perm]


def ordered_u32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of int32/uint32/float32 to unsigned 32-bit
    (int64 holder)."""
    if x.dtype == torch.uint32:
        return x.to(torch.int64)
    if x.dtype == torch.int32:
        return x.to(torch.int64) + 0x80000000
    if x.dtype == torch.float32:
        u = x.view(torch.int32).to(torch.int64) & U32
        flip = torch.where((u >> 31) == 1, U32, 0x80000000)
        return u ^ flip
    raise TypeError(f"unsupported sort key dtype {x.dtype}")


def sort_permutation_ref(x: torch.Tensor, row_count: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts one key column's rows ``< row_count``
    ascending by :func:`ordered_u32`, ties in row order, the rest after
    them in row order: (C,) int64. Rows past ``row_count`` take the u32
    max, and the (key, row index) order puts them after valid rows with
    that key (front compaction gives them larger indices). Up to one
    2048-row tile, (key, row) pairs padded to a power of two (>= 256) with
    (int64 max, int32 max) sort lexicographically (``sort_tiles_ref``, what
    the bitonic tile computes); beyond it, a stable sort on the key."""
    c = x.shape[0]
    ku = ordered_u32(x)
    ku = torch.where(torch.arange(c, device=x.device) < row_count, ku, U32)
    iota = torch.arange(c, dtype=torch.int32, device=x.device)
    if c > 1 << 11:
        return torch.sort(ku, stable=True).indices
    n_pad = max(1 << max(c - 1, 0).bit_length(), 256)
    kp = torch.full((n_pad,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                    device=x.device)
    kp[:c] = ku
    vp = torch.full((n_pad,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=x.device)
    vp[:c] = iota
    _, vo = sort_tiles_ref(kp, vp, n_pad)
    return vo[:c].to(torch.int64)


def sort_tiles_ref(keys: torch.Tensor, payload: torch.Tensor, tile: int):
    """Sort each contiguous ``tile`` of (keys, payload) ascending,
    lexicographically on (key, payload): the function the bitonic network
    computes (floats compare as floats, so -0.0 and +0.0 tie on the key)."""
    n = keys.shape[0]
    k = keys.reshape(n // tile, tile)
    v = payload.reshape(n // tile, tile)
    v, p1 = torch.sort(v, dim=1, stable=True)
    k = torch.gather(k, 1, p1)
    k, p2 = torch.sort(k, dim=1, stable=True)
    v = torch.gather(v, 1, p2)
    return k.reshape(n), v.reshape(n)


# ---------------------------------------------------------------------------
# segmented reduction
# ---------------------------------------------------------------------------


def seg_init(op: str, dtype: torch.dtype):
    """Identity element of ``op`` for ``dtype`` (the empty-segment fill)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    if op == "min":
        return hi
    if op == "max":
        return lo
    raise ValueError(op)


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """``out[g] = op(values[i] : seg_ids[i] == g)`` along the leading axis.

    Ids outside [0, num_segments) contribute nothing; empty segments hold
    :func:`seg_init`. Rows fold into an extra dump slot that is cut off, so
    no index is ever out of range.
    """
    rest = tuple(values.shape[1:])
    out = torch.full((num_segments + 1,) + rest, seg_init(op, values.dtype),
                     dtype=values.dtype, device=values.device)
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(ok, seg_ids.to(torch.int64), num_segments)
    if op == "sum":
        out.index_add_(0, idx, values)
    elif op in ("min", "max"):
        out.index_reduce_(0, idx, values, "a" + op, include_self=True)
    else:
        raise ValueError(op)
    return out[:num_segments]


# ---------------------------------------------------------------------------
# segmented prefix scan
# ---------------------------------------------------------------------------


def _select_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if it is NaN or below ``b``, else ``b``: NaN-propagating, and
    always one of the two inputs' bit patterns (torch.minimum on the CPU
    may hand back another NaN)."""
    return torch.where(torch.isnan(a) | (a < b), a, b)


def _select_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(a) | (a > b), a, b)


_SCAN_OPS = {"sum": torch.add, "min": _select_min, "max": _select_max}


def segment_scan_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                     op: str = "sum", inclusive: bool = True) -> torch.Tensor:
    """Segmented running sum/min/max over contiguous segment runs.

    ``out[i] = op(values[j] for j <= i with seg_ids[j] == seg_ids[i])``
    (strict ``j < i`` when ``inclusive=False``; a row with no in-segment
    predecessor holds :func:`seg_init`). A segment is a maximal run of
    equal ids, -1 included; min/max propagate NaN, and keep the bits of
    the first NaN in row order.

    A log-step (Hillis-Steele) scan: for d = 1, 2, 4, ... row i folds in
    row i-d when both lie in one segment. The runs are contiguous, so that
    test is exact. Equal to ``repro.kernels.ref.segment_scan_ref`` bit for
    bit on integer-valued data (float sums there are exact in any order).
    """
    f = _SCAN_OPS[op]
    (n,) = values.shape
    v = values
    d = 1
    while d < n:
        same = seg_ids[d:] == seg_ids[:-d]
        v = torch.cat([v[:d], torch.where(same, f(v[:-d], v[d:]), v[d:])])
        d *= 2
    if inclusive:
        return v
    same_prev = torch.zeros(n, dtype=torch.bool, device=values.device)
    same_prev[1:] = seg_ids[1:] == seg_ids[:-1]
    init = torch.full((), seg_init(op, values.dtype), dtype=values.dtype,
                      device=values.device)
    return torch.where(same_prev, torch.roll(v, 1, 0), init)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Materialized-softmax GQA attention. q (B,S,H,hd); k (B,T,KV,hd); v
    (B,T,KV,dv), dv = hd but for MLA's (q k over nope + rope, p v over the
    value width); H % KV == 0; query head h reads KV head ``h // (H //
    KV)``. Scores scaled by 1/sqrt(hd), q's width, as the reference's
    ``_sdpa`` takes it. fp32 inside, output (B,S,H,dv) in q's dtype
    (``repro.kernels.ref.attention_ref``)."""
    b, s, h, hd = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = scores / math.sqrt(hd)
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


def attention_rounding_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block: int = 128
                         ) -> torch.Tensor:
    """The plain attention with the bf16 flash kernel's one extra rounding:
    its probabilities rounded to bf16 before p v, which the tensor cores
    take (the plain version keeps them fp32), at the points where the
    kernel rounds them. The kernel's online softmax walks the keys in
    ``block``-column tiles (``csrc/flash_attention.cu``): per tile the
    running max m (log2 units) takes the tile's, p = exp2(s log2(e) scale -
    m) in fp32, the row sum and the accumulator are rescaled by exp2(m_old
    - m) and take p's fp32 sum and bf16(p) v. So each P is rounded relative
    to the max so far, not the row's. Masked scores are -1e30, as there.
    Self-attention (S == T). For comparisons (the tests and
    ``chip_smoke.py``): no model path calls it."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kr, vr = (x.repeat_interleave(h // k.shape[2], 2).float() for x in (k, v))
    sl2 = (1.0 / math.sqrt(hd)) * 1.4426950408889634
    sc = torch.einsum("bshd,bthd->bhst", q.float(), kr)
    if causal:
        sc = sc.masked_fill(torch.ones(s, t, dtype=torch.bool,
                                       device=q.device).triu(1), -1e30)
    m = torch.full((b, h, s), -1e30, dtype=torch.float32, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, v.shape[3]), dtype=torch.float32,
                      device=q.device)
    for j in range(0, t, block):
        sb = sc[..., j:j + block] * sl2
        mn = torch.maximum(m, sb.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(sb - mn[..., None])
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(torch.bfloat16).float(), vr[:, j:j + block])
        m = mn
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref`'s output and each row's log-sum-exp of the
    scaled, masked scores, (B, H, S) in fp32 (fp64 for fp64 inputs): the
    training forward's function. v may be narrower than q and k (MLA)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bskgh,btkh->bkgst", q.reshape(b, s, kv, h // kv, hd)
                          .to(dt), k.to(dt)) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return attention_ref(q, k, v, causal=causal), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): autograd through :func:`attention_ref` (fp32 inside)
    for the output gradient ``dout`` (B, S, H, dv), in the inputs' dtypes
    and shapes (dv's last dim v's)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = attention_ref(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)
