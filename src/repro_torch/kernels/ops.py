"""The dispatch seam between the operators and the kernels (the port of
``repro/kernels/ops.py``).

The core library calls these, never the kernels directly, so the
kernel-or-plain choice, padding and multi-column combination live in one
place. Each kernel wrapper itself takes its plain version for a CPU tensor
and launches its kernel for a CUDA tensor. :func:`oracle_scope` (the
reference's recovery rung) makes every function here call the plain
versions instead, on whatever device the tensors are: a caller's request,
never a fallback. The recovery ladder enters it only after an injected
``FaultError`` at the ``kernel.dispatch`` site (:func:`_kernel_fault`, at
the segment kernels' seams, as in the reference); an error the kernel
itself raises propagates.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.core import faults as FLT
from repro_torch.kernels import bitonic, flash_attention, hash64, histogram, ref
from repro_torch.kernels import segment_reduce as seg
from repro_torch.kernels import segment_scan as scan
from repro_torch.kernels.bitonic import DEFAULT_TILE
from repro_torch.utils import next_pow2

__all__ = [
    "hash32",
    "hash_columns",
    "hash_partition_ids",
    "bucket_histogram",
    "sort_pairs",
    "bitonic_sort_permutation",
    "segment_reduce",
    "segment_scan",
    "attention",
    "key_max",
    "oracle_scope",
    "oracle_only",
]

_oracle = threading.local()


def oracle_only() -> bool:
    """True while the calling thread is inside :func:`oracle_scope`."""
    return getattr(_oracle, "depth", 0) > 0


@contextmanager
def oracle_scope():
    """Run every kernel's plain version on this thread (bit-identical on
    the integer-valued inputs the engine produces)."""
    _oracle.depth = getattr(_oracle, "depth", 0) + 1
    try:
        yield
    finally:
        _oracle.depth -= 1


def _kernel_fault(out: torch.Tensor) -> torch.Tensor:
    """Apply an armed ``kernel.dispatch`` fault to a kernel's output: raise,
    or return it NaN-poisoned (floats only; result validation finds the
    NaNs and quarantines the run). Consulted on a plan's first run only,
    once a call site (``faults.check_first_run``); no-op otherwise."""
    fp = FLT.check_first_run("kernel.dispatch", per_shard=True)
    if fp is None:
        return out
    mode = fp.effective_mode
    if mode == "nan" and out.dtype.is_floating_point:
        return torch.full_like(out, float("nan"))
    raise FLT.FaultError("kernel.dispatch", f"mode={mode}")


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    if oracle_only():
        return ref.hash32_ref(x, seed)
    return hash64.hash32(x, seed)


def hash_columns(columns: list[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Row-wise u32 hash (int64 holder) over one or more columns,
    order-sensitive: the paper's multi-column record hash."""
    if not columns:
        raise ValueError("hash_columns needs at least one column")
    h = hash32(columns[0], seed=seed)
    for c in columns[1:]:
        h = ref.hash_combine_ref(h, hash32(c, seed=seed))
    return h


def hash_partition_ids(columns: list[torch.Tensor], row_count: torch.Tensor,
                       num_partitions: int, seed: int = 0) -> torch.Tensor:
    """Hash partition's per-row destination, (n,) int32: the columns'
    :func:`hash_columns` ``% num_partitions``, -1 at rows ``>= row_count``.
    One launch of the fused partition kernel (``hash64.hash32_partition``),
    or its plain version under :func:`oracle_scope` and on the CPU."""
    if oracle_only():
        return ref.hash_partition_ids_ref(columns, row_count, num_partitions,
                                          seed)
    return hash64.hash32_partition(columns, row_count, num_partitions, seed)


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    if oracle_only():
        return ref.histogram_ref(ids, num_buckets)
    return histogram.bucket_histogram(ids, num_buckets)


def key_max(dtype: torch.dtype):
    """Sentinel that sorts after every real key of ``dtype`` (a Python
    scalar). The int64 holder of u32 keys gets the int64 max, which sorts
    after every u32 value too."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


_SHORT = {torch.float32: "f32", torch.int32: "i32", torch.float64: "f64"}


def _kernel_route(seam: str, values: torch.Tensor, dtypes: tuple,
                  use_kernel: bool | None, plain: str) -> bool:
    """Resolve a segment seam's ``use_kernel``: ``None`` takes the kernel
    for 1-D values of ``dtypes`` and the plain version otherwise; ``True``
    with another shape or dtype raises."""
    shape_ok = values.ndim == 1 and values.dtype in dtypes
    if use_kernel is None:
        return shape_ok
    if use_kernel and not shape_ok:
        kinds = "/".join(v for d, v in _SHORT.items() if d in dtypes)
        raise ValueError(
            f"{seam} kernel needs 1-D {kinds} values; got "
            f"shape={tuple(values.shape)} dtype={values.dtype}. Use "
            f"use_kernel=None for the {plain}.")
    return use_kernel


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, op: str = "sum", *,
                   use_kernel: bool | None = None,
                   contiguous_runs: bool = False) -> torch.Tensor:
    """Segmented sum/min/max: ``out[g] = op(values[i] where seg_ids[i] == g)``.

    values: (n, ...), reduced along the leading axis; seg_ids: (n,) int32,
    entries outside [0, num_segments) ignored; empty segments hold
    ``ref.seg_init``. 1-D f32/i32/f64 values go to the kernel; N-D values
    and other dtypes (int64 among them) take the plain scatter;
    ``use_kernel=False`` and :func:`oracle_scope` force the plain version.
    ``contiguous_runs=True`` is the caller's promise that each in-range id's
    rows form one contiguous run; the kernel wrapper then skips its check.
    ``segment_reduce.plain_calls`` counts the calls on a device tensor (not
    the CPU's, whose kernel route is the plain version too) that took the
    plain version outside :func:`oracle_scope`.
    """
    if op not in ("sum", "min", "max"):
        raise ValueError(op)
    if seg_ids.ndim != 1 or values.shape[0] != seg_ids.shape[0]:
        raise ValueError(f"shape mismatch {tuple(values.shape)} vs "
                         f"{tuple(seg_ids.shape)}")
    use_kernel = _kernel_route("segment_reduce", values, seg.DTYPES,
                               use_kernel, "plain scatter")
    if oracle_only():
        return ref.segment_reduce_ref(values, seg_ids, num_segments, op)
    if use_kernel:
        return _kernel_fault(seg.segment_reduce_tiles(
            values, seg_ids.to(torch.int32), num_segments, op,
            contiguous_runs=contiguous_runs))
    if values.device.type != "cpu":
        segment_reduce.plain_calls += 1
    return ref.segment_reduce_ref(values, seg_ids, num_segments, op)


segment_reduce.plain_calls = 0


def segment_scan(values: torch.Tensor, seg_ids: torch.Tensor, op: str = "sum",
                 *, inclusive: bool = True,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Segmented running sum/min/max along the rows (the window hot path).

    ``out[i] = op(values[j] for j <= i with seg_ids[j] == seg_ids[i])``
    (strict ``j < i`` when ``inclusive=False``; rows without an in-segment
    predecessor hold ``ref.seg_init``). seg_ids: (n,) int32 contiguous runs,
    the sorted-segment layout ``core/ops_agg`` produces, with trailing -1
    padding allowed. 1-D f32/i32 values go to the kernel;
    ``use_kernel=False`` and :func:`oracle_scope` take the plain version
    on whatever device the tensors are; ``use_kernel=True`` with another
    shape or dtype raises.
    """
    if op not in ("sum", "min", "max"):
        raise ValueError(op)
    if seg_ids.ndim != 1 or values.shape != seg_ids.shape:
        raise ValueError(f"shape mismatch {tuple(values.shape)} vs "
                         f"{tuple(seg_ids.shape)}")
    use_kernel = _kernel_route("segment_scan", values,
                               (torch.float32, torch.int32), use_kernel,
                               "plain scan")
    if use_kernel and not oracle_only():
        return _kernel_fault(scan.segment_scan_tiles(
            values, seg_ids.to(torch.int32), op, inclusive=inclusive))
    return ref.segment_scan_ref(values, seg_ids, op, inclusive)


def sort_pairs(keys: torch.Tensor, payload: torch.Tensor, *,
               tile: int = DEFAULT_TILE, use_kernel: bool | None = None):
    """Full ascending (keys, payload) sort, stable on the key.

    keys: (n,) int64 (the port's holder of u32 keys); payload: (n,) int32.
    Up to one tile the bitonic kernel sorts (keys, payload) padded to a
    power of two (>= 256); beyond it, or with ``use_kernel=False``, a
    stable ``torch.sort`` on the key. The padding is (key max, payload
    int32 max): it sorts after every real pair, so a real row whose key is
    the key max is never cut off (the reference pads with payload 0 and
    loses such a row at non-power-of-two sizes).
    """
    if use_kernel is None:
        use_kernel = True
    (n,) = keys.shape
    if not use_kernel or n > tile:
        return ref.sort_pairs_ref(keys, payload)
    n_pad = max(next_pow2(n), 256)
    kp = torch.full((n_pad,), key_max(keys.dtype), dtype=keys.dtype,
                    device=keys.device)
    kp[:n] = keys
    vp = torch.full((n_pad,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=keys.device)
    vp[:n] = payload
    if oracle_only():
        ko, vo = ref.sort_tiles_ref(kp, vp, n_pad)
    else:
        ko, vo = bitonic.bitonic_sort_tiles(kp, vp, tile=n_pad)
    return ko[:n], vo[:n]


def bitonic_sort_permutation(keys: torch.Tensor,
                             row_count: torch.Tensor) -> torch.Tensor:
    """The (C,) int64 permutation sorting rows ``< row_count`` ascending by
    ``ordered_u32(keys)`` (ties in row order), the other rows after them in
    row order. Up to one tile (2048 rows) the fused bitonic kernel sorts in
    one launch; beyond it, a stable ``torch.sort`` on the key (as
    :func:`sort_pairs` leaves larger inputs); :func:`oracle_scope` takes
    the plain version."""
    if oracle_only() or keys.shape[0] > bitonic.MAX_PERMUTATION_ROWS:
        return ref.sort_permutation_ref(keys, row_count)
    return bitonic.bitonic_sort_permutation(keys, row_count)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Self-attention (S == T) for the models' prefill and training: the
    flash kernel, or its plain version under :func:`oracle_scope` on
    whatever device the tensors are. q, k (B, S, H or KV, hd); v (B, S, KV,
    dv), dv = hd but for MLA's; the card takes the (hd, dv) pairs of
    ``flash_attention.KERNEL_HEAD_DIMS`` and raises ``TypeError`` on any
    other, with no fallback to the plain version.

    When autograd records through an input (training), a CUDA tensor goes
    through :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`
    (the LSE-writing forward, the hand-written backward); the plain version
    and a CPU tensor go through ``attention_ref``, differentiated by
    autograd. Otherwise (serving) the serving forward. Meta tensors (the
    dry run) take the same entries, whose meta route records the kernel's
    work and computes nothing."""
    if oracle_only():
        return ref.attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cpu":
            return ref.attention_ref(q, k, v, causal=causal)
        return flash_attention.FlashAttentionFn.apply(q, k, v, causal)
    return flash_attention.flash_attention(q, k, v, causal=causal)
