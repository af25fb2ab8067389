"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Phases (any failed check raises, and the script exits nonzero):

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel from ``src/repro_torch/kernels/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge shapes: exact equality (float sums on
   integer-valued data). segment_reduce also around its 4096-row tiles
   (runs that end at a tile edge, one row before, one after), over one
   run of every row, over rows all out of range, with NaN in min/max, and
   at phase 7's shape on standard-normal data (``SEG_F32_TOL``). Also
   torch.sort's float order on the card and the shuffle's counts carrier
   in a float32 column.
3. The main path at a size users run: tables of the paper's relation
   (int32 key + 3 float32, 16 B a row), 8 virtual shards x 2**22 rows each
   (512 MiB a table), through ``DistContext``: the sort join, the hash join,
   groupby two_phase (bucket 256, so the combine sorts 2048 rows on the
   bitonic kernel) and groupby shuffle (segment counts of 8 M) on
   ``key_range=1000``, the global sort, and the window functions (every
   one of them) over a fourth table of 16 B rows with 12 groups, so most
   groups span shards (range bucket 2**21, 2**24 slots a shard). Launch
   counts are zeroed just before and read just after; every kernel must
   have launched, segment_scan_tiles 6 times a shard and
   segment_reduce_tiles ``SEG_REDUCE_LAUNCHES`` times.
4. The same calls under ``oracle_scope()`` (every plain version, on the
   card, no launches): the same rows, per-shard row counts and shuffle
   stats, bit for bit (the window's rows in order); groupby's float sums
   and what derives from them (sum, mean, var) within the tolerance stated
   in ``compare_groupby``.
5. Each operator's median wall time through the kernels and through the
   plain versions, run in turns.
6. One ``torch.profiler`` trace of each operator through the kernels (GPU
   busy share, the device time of the port's own kernels, the kernels
   that took the most device time).
7. Each kernel's median time at the path's shape beside its plain
   version's, one PyTorch library call's where one computes the same
   function (none computes a segmented scan: ``torch.cumsum`` of the same
   column is printed beside it instead), and the least time the card
   could take (``bound_ms``). Before them, each instance of the kernels
   redesigned last (flash_fwd_bf16, seg_fill, seg_pass1, seg_pass2) as
   the build's ``-Xptxas -v`` reported it: registers, spill bytes, static
   shared memory (flash's dynamic shared memory from the library), and
   each source's nvcc seconds.

Then, with the relational tables freed, the serving path (the LM slice):

8. llama3-8b at full width and depth (random bf16 weights from a
   ``torch.Generator`` seeded 0) serves 4 prompts of 1024 token ids (a
   seeded numpy rng, as the launcher makes them) and 32 greedy tokens each
   through ``launch.serve.generate``. The counts are zeroed just before
   and read just after: flash_attention launched once a layer (32), by the
   prefill; a decode step launches it never. Every logit finite.
9. The same prompts under ``oracle_scope()`` (the plain attention on the
   card), the kernel run's tokens teacher-forced: prefill's and every
   decode step's logits within ``LM_TOL`` of the kernel run's, and the
   greedy token (the first and every step's) equal wherever the kernel
   run's top-2 margin exceeds it. Then the serving invariant of
   ``tests/test_serve.py``: prefill + decode logits against one causal
   forward over prompt + generated tokens (1055 rows, through the
   kernel), within ``LM_TOL``.
10. Serving times: prefill median ms, decode ms a token, tokens/s, peak
   device memory, and one ``torch.profiler`` trace of a prefill and of
   decode steps (busy share, flash's device ms, the largest kernels, the
   torch ops the host dispatched).
Phase 2 also holds flash_attention against its plain version (S 1 to
4096, around the 64-row fp32 and 128-row bf16 tiles, causal or not, group
size 1 and 4, hd 64 and 128, fp32 and bf16, scores up to +-1e4); phase 7
times it at the path's shape beside
``F.scaled_dot_product_attention`` (``library_ms``).

It prints one JSON line with the main path's numbers, one with the serving
path's, one with every kernel's, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Without a card it exits
2 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops_local as L  # noqa: E402
from repro_torch.core.context import DistContext, DistTable  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.repartition import repartition  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.data.synthetic import random_table  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.bitonic import bitonic_sort_tiles  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.hash64 import hash32  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402
from repro_torch.kernels.segment_scan import segment_scan_tiles  # noqa: E402
from repro_torch.launch.serve import generate, prompts  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

P = 8
ROWS = 1 << 22  # rows per shard: 8 x 4 Mi rows, 512 MiB a table
WINDOW_GROUPS = 12
WINDOW_FUNCS = ["rank", "dense_rank", "row_number", ("lag", "d0"),
                ("lead", "d0"), ("lag", "d1", 3), ("lead", "d1", 2),
                ("cumsum", "d0"), ("cummax", "d0"), ("cummax", "d1"),
                ("running_mean", "d0")]
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32 rate
# outside the tensor cores (32-bit scalar integer/float ops), and the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TENSOR_BF16_OPS_PER_S = 989e12
# the serving path: llama3-8b, 4 prompts of 1024 tokens, 32 greedy tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3-8b", 4, 1024, 32
# Logits of two runs of the serving path that differ only in how prefill
# attention rounds (the kernel rounds its probabilities to bf16 for the
# tensor-core p v, the plain version keeps fp32, the decode einsums round
# scores and probabilities to bf16) are held within 0.05 absolute: the
# logits have std ~0.18 and reach ~1, where a bf16 ulp is 2^-8 = 0.0039,
# and 32 layers carry the rounding of each attention output forward. A
# wrong mask or a wrong head moves logits by their own scale (~0.2), four
# times this.
LM_TOL = 0.05
# segment_reduce's pass-1 tile (csrc/segment_reduce.cu), whose edges phase 2
# probes
SEG_TILE = 4096
# A float32 segment sum of ~33,500 standard-normal rows (phase 7's shape)
# through the plain version's index_add_ drifts by up to ~0.0025 from the
# exact sum (its atomics add one row at a time; the earlier bound of
# 0.00244 against it was that drift), while the kernel's binary-tree sums
# stay much closer. So at that shape the kernel is held against the plain
# version run in float64, ten times tighter than 0.00244.
SEG_F32_TOL = 2.44e-4
# groupby two_phase and shuffle's segment_reduce launches over the main path
# (every aggregate's partial on every shard)
SEG_REDUCE_LAUNCHES = 120

KERNELS = {
    "hash32": (hash32, "src/repro_torch/kernels/csrc/hash32.cu",
               "src/repro/kernels/hash64.py:41"),
    "bucket_histogram": (bucket_histogram,
                         "src/repro_torch/kernels/csrc/histogram.cu",
                         "src/repro/kernels/histogram.py:42"),
    "bitonic_sort_tiles": (bitonic_sort_tiles,
                           "src/repro_torch/kernels/csrc/bitonic.cu",
                           "src/repro/kernels/bitonic.py:71"),
    "segment_reduce_tiles": (segment_reduce_tiles,
                             "src/repro_torch/kernels/csrc/segment_reduce.cu",
                             "src/repro/kernels/segment_reduce.py:79"),
    "segment_scan_tiles": (segment_scan_tiles,
                           "src/repro_torch/kernels/csrc/segment_scan.cu",
                           "src/repro/kernels/segment_scan.py:101"),
    "flash_attention": (flash_attention,
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
}
# the relational main path's kernels; flash_attention is the serving path's
RELATIONAL = ("hash32", "bucket_histogram", "bitonic_sort_tiles",
              "segment_reduce_tiles", "segment_scan_tiles")


# the __global__ functions of src/repro_torch/kernels/csrc/*.cu, as the
# profiler names them
PORTED_KERNELS = ("hash32_kernel", "hist_global", "hist_shared", "bitonic_tile",
                  "seg_fill", "seg_pass1", "seg_pass2", "scan_reduce",
                  "scan_carry", "scan_apply", "flash_fwd_bf16", "flash_fwd_f32")


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def say(*a) -> None:
    print(*a, flush=True)


def set_launches(value: int = 0) -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = value


def launches() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the kernels whose build report phase 7 prints, and segment_reduce's op codes
REPORTED_KERNELS = ("flash_fwd_bf16", "seg_fill", "seg_pass1", "seg_pass2")
_OPS = {"0": "sum", "1": "min", "2": "max"}


def ptxas_report() -> list[dict]:
    """Every instance of ``REPORTED_KERNELS`` as the build's ``-Xptxas -v``
    output (``_build.LOGS``) reports it: registers a thread, spill bytes
    (stores, loads) and static shared memory."""
    found = []
    pat = re.compile(r"\d+(%s)I(\w*?)EE" % "|".join(REPORTED_KERNELS))
    for _, log in _build.LOGS.values():
        cur = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = pat.search(line)
                cur = None
                if m:  # template arguments: Li128 (hd), fLi0 (float, sum)
                    args = m.group(2)
                    t = {"f": "float", "i": "int"}.get(args[:1])
                    n = re.findall(r"Li(\d+)", args)
                    label = (f"<{n[0]}>" if t is None else
                             f"<{t}, {_OPS.get(n[0], n[0])}>")
                    cur = {"kernel": m.group(1) + label}
                    found.append(cur)
            elif cur is not None and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                cur["spill_store_bytes"], cur["spill_load_bytes"] = int(st), int(ld)
            elif cur is not None and "Used" in line and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return found


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median per-call device time with CUDA events, each call after an L2
    flush (a 256 MiB write, outside the timed window)."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def __call__(self, fn, reps: int = 15, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def phase_kernels(dev) -> None:
    rng = np.random.default_rng(1)
    n = 1 << 22

    # hash32: 2**22 int32 / uint32 / float32 (with +-0 and NaN), two seeds
    f = rng.standard_normal(n).astype(np.float32)
    f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    cols = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), f]
    for c in cols:
        x = torch.from_numpy(c).to(dev)
        for seed in (7, 8):
            got, want = hash32(x, seed), ref.hash32_ref(x, seed)
            check(torch.equal(got, want), f"hash32 {c.dtype} seed {seed}")
        # an unaligned view takes the scalar path
        check(torch.equal(hash32(x[1:], 7), ref.hash32_ref(x[1:], 7)),
              f"hash32 unaligned {c.dtype}")

    # histogram: P = 8 with -1 padding, and large P
    ids = torch.from_numpy(rng.integers(-1, 8, n).astype(np.int32)).to(dev)
    for p in (8, 1, 1000, 20000):
        check(torch.equal(bucket_histogram(ids, p), ref.histogram_ref(ids, p)),
              f"histogram P={p}")
    odd = torch.from_numpy(rng.integers(-5, 40, 1001).astype(np.int32)).to(dev)
    check(torch.equal(bucket_histogram(odd, 37), ref.histogram_ref(odd, 37)),
          "histogram odd")

    # bitonic: every tile size, u32 keys in int64 (wide and with many
    # duplicates), the u32 max key, repeated payloads
    for tile in (256, 512, 1024, 2048, 4096):
        m = 3 * tile
        for hi in (2**32, 9):
            keys = rng.integers(0, hi, m, dtype=np.uint64).astype(np.int64)
            keys[::89] = 0xFFFFFFFF
            k = torch.from_numpy(keys).to(dev)
            v = torch.from_numpy(rng.integers(0, m // 2, m).astype(np.int32)).to(dev)
            ko, vo = bitonic_sort_tiles(k, v, tile=tile)
            rk, rv = ref.sort_tiles_ref(k, v, tile)
            check(torch.equal(ko, rk) and torch.equal(vo, rv),
                  f"bitonic tile={tile} keys < {hi}")
    # through sort_pairs, n not a power of two, with the u32 max key
    for m in (1, 300, 1000, 2047):
        keys = rng.integers(0, 20, m).astype(np.int64)
        keys[m // 2] = 0xFFFFFFFF
        k = torch.from_numpy(keys).to(dev)
        v = torch.arange(m, dtype=torch.int32, device=dev)
        ko, vo = kops.sort_pairs(k, v)
        rk, rv = ref.sort_pairs_ref(k, v)
        check(torch.equal(ko, rk) and torch.equal(vo, rv), f"sort_pairs n={m}")

    # segment_reduce: sum/min/max x f32/i32 x G, sorted and unsorted ids,
    # ids out of range; integer-valued floats, so sums are exact. Sorted
    # ids (out-of-range ones at both ends) also go in as contiguous runs,
    # as groupby passes them.
    for g in (1, 1024, 1025, 1 << 22):
        for sort_ids in (True, False):
            s = rng.integers(-2, g + 2, n)
            if sort_ids:
                s = np.sort(s)
            seg = torch.from_numpy(s.astype(np.int32)).to(dev)
            for dt in (np.float32, np.int32):
                vals = torch.from_numpy(rng.integers(-99, 99, n).astype(dt)).to(dev)
                for op in ("sum", "min", "max"):
                    want = ref.segment_reduce_ref(vals, seg, g, op)
                    for runs in (False, True) if sort_ids else (False,):
                        got = segment_reduce_tiles(vals, seg, g, op,
                                                   contiguous_runs=runs)
                        check(torch.equal(got, want),
                              f"segment_reduce G={g} sorted={sort_ids} "
                              f"contiguous_runs={runs} {dt} {op}")
    # one long run crossing many blocks, and empty input
    vals = torch.ones(3 << 20, dtype=torch.float32, device=dev)
    seg = torch.zeros(3 << 20, dtype=torch.int32, device=dev)
    check(segment_reduce_tiles(vals, seg, 2, "sum").tolist() == [3 << 20, 0.0],
          "segment_reduce long run")
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    check(torch.equal(segment_reduce_tiles(empty, seg[:0], 3, "min"),
                      ref.segment_reduce_ref(empty, seg[:0], 3, "min")),
          "segment_reduce empty")
    seg_err = check_segment_reduce_edges(dev, rng)
    say(f"[2] segment_reduce at phase 7's shape, standard-normal f32 sums: "
        f"within {seg_err['f64']:.3g} of the plain version in float64 "
        f"(tolerance {SEG_F32_TOL:g}), {seg_err['f32']:.3g} of it in float32; "
        f"the same bits on a second run")
    check_segment_scan(dev, rng)
    check_flash(dev, rng)
    torch.cuda.synchronize()


def _bits(c: torch.Tensor) -> torch.Tensor:
    return c.view(torch.int32) if c.dtype == torch.float32 else c


def check_segment_reduce_edges(dev, rng) -> dict[str, float]:
    """segment_reduce where its design has edges, as groupby passes ids
    (``contiguous_runs=True``): runs that end exactly at the 4096-row tile
    edges, one row before and one after (5 tiles + 3 rows); one run over
    2**22 + 3 rows; every row out of range (-1, and G); sum/min/max x
    f32/i32 on integer values, bit for bit, and the same bits on a second
    run. NaN in f32 min/max: the segments that hold a NaN come out NaN,
    the others equal the plain version (whose atomics on the card need not
    keep NaN). Then phase 7's shape on standard-normal data (f32 sum, 2**23
    rows, 125 sorted groups over the first half, a -1 tail): within
    ``SEG_F32_TOL`` of the plain version in float64, the same bits twice.
    Returns the largest differences there (float64 and float32 plain)."""
    def exact(name, vals, ids, g):
        v = torch.from_numpy(vals).to(dev)
        seg = torch.from_numpy(ids.astype(np.int32)).to(dev)
        for op in ("sum", "min", "max"):
            got = segment_reduce_tiles(v, seg, g, op, contiguous_runs=True)
            check(torch.equal(got, ref.segment_reduce_ref(v, seg, g, op)),
                  f"segment_reduce {name} {vals.dtype} {op}")
            again = segment_reduce_tiles(v, seg, g, op, contiguous_runs=True)
            check(torch.equal(_bits(got), _bits(again)),
                  f"segment_reduce {name} {vals.dtype} {op}: bits differ "
                  f"between two runs")

    n = 5 * SEG_TILE + 3
    for shift in (-1, 0, 1):
        ids = np.clip((np.arange(n) - shift) // SEG_TILE, 0, None)
        for dt in (np.float32, np.int32):
            exact(f"runs ending at tile edges {shift:+d}",
                  rng.integers(-99, 99, n).astype(dt), ids, 10)
    n = (1 << 22) + 3
    for dt in (np.float32, np.int32):
        vals = rng.integers(-99, 99, n).astype(dt)
        exact("one run over all rows", vals, np.zeros(n), 3)
        exact("all rows out of range (-1)", vals, np.full(n, -1), 3)
        exact("all rows out of range (G)", vals, np.full(n, 3), 3)

    n = 3 * SEG_TILE + 11
    vals = rng.integers(-99, 99, n).astype(np.float32)
    vals[[5, SEG_TILE + 4, 2 * SEG_TILE + 900]] = np.nan
    v = torch.from_numpy(vals).to(dev)
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, n)).astype(np.int32)).to(dev)
    nan_seg = ref.segment_reduce_ref(torch.isnan(v).to(torch.int32), seg, 40,
                                     "sum") > 0
    for op in ("min", "max"):
        got = segment_reduce_tiles(v, seg, 40, op, contiguous_runs=True)
        want = ref.segment_reduce_ref(v, seg, 40, op)
        check(torch.equal(torch.isnan(got), nan_seg) and
              torch.equal(got[~nan_seg], want[~nan_seg]),
              f"segment_reduce NaN {op}")

    n = 2 * ROWS
    ids = np.full(n, -1, np.int32)
    ids[:n // 2] = np.sort(rng.integers(0, 125, n // 2))
    seg = torch.from_numpy(ids).to(dev)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    got = segment_reduce_tiles(v, seg, n, "sum", contiguous_runs=True)
    check(torch.equal(_bits(got), _bits(segment_reduce_tiles(
        v, seg, n, "sum", contiguous_runs=True))),
        "segment_reduce standard-normal sums: bits differ between two runs")
    err64 = float((got.double() - ref.segment_reduce_ref(
        v.double(), seg, n, "sum")).abs().max())
    err32 = float((got - ref.segment_reduce_ref(v, seg, n, "sum")).abs().max())
    check(err64 <= SEG_F32_TOL,
          f"segment_reduce standard-normal sums differ from the float64 plain "
          f"version by {err64}")
    return {"f64": err64, "f32": err32}


def check_segment_scan(dev, rng) -> None:
    """segment_scan: sum/min/max x f32/i32 x inclusive/exclusive over block
    edges (4096 rows a block), 2**22 + 3 and 2**24 + 5 rows (a carry chain
    through 4097 blocks); one run through every block, every row its own
    segment, random runs with a -1 tail that starts mid-block; NaN in f32
    min/max; int32 sums that wrap. Bit for bit (NaN keeps the first NaN's
    bits on both sides), and the same bits on a second run."""
    def scan_ids(n):
        ids = np.sort(rng.integers(0, max(1, n // 37), n)).astype(np.int32)
        ids[n - n // 3 - 5:] = -1
        return ids

    for n in (1, 33, 4095, 4096, 4097, 3 * 4096 + 1, (1 << 22) + 3,
              (1 << 24) + 5):
        for layout, ids in (("one run", np.zeros(n, np.int32)),
                            ("singletons", np.arange(n, dtype=np.int32)),
                            ("random runs", scan_ids(n))):
            seg = torch.from_numpy(ids).to(dev)
            for dt in (np.float32, np.int32):
                for op in ("sum", "min", "max"):
                    vals = rng.integers(-99, 99, n).astype(dt)
                    if dt == np.float32 and op != "sum":
                        vals[rng.integers(0, n, 3)] = np.nan
                    v = torch.from_numpy(vals).to(dev)
                    for inclusive in (True, False):
                        got = segment_scan_tiles(v, seg, op, inclusive=inclusive)
                        want = ref.segment_scan_ref(v, seg, op, inclusive)
                        check(torch.equal(_bits(got), _bits(want)),
                              f"segment_scan n={n} {layout} {dt} {op} "
                              f"inclusive={inclusive}")
                    once, again = (segment_scan_tiles(v, seg, op)
                                   for _ in range(2))
                    check(torch.equal(_bits(once), _bits(again)),
                          f"segment_scan n={n} {layout} {dt} {op}: bits "
                          f"differ between two runs")
    # int32 sums that wrap: 2**30 a row in one run
    n = 3 * 4096 + 7
    v = torch.full((n,), 1 << 30, dtype=torch.int32, device=dev)
    seg = torch.zeros(n, dtype=torch.int32, device=dev)
    for inclusive in (True, False):
        check(torch.equal(segment_scan_tiles(v, seg, "sum", inclusive=inclusive),
                          ref.segment_scan_ref(v, seg, "sum", inclusive)),
              f"segment_scan int32 wrap inclusive={inclusive}")


def check_flash(dev, rng) -> None:
    """flash_attention against attention_ref on the card: S at and around
    the fp32 kernel's 64-row tiles and the bf16 kernel's 128-row tiles, and
    long (1, 63, 64, 65, 127, 128, 129, 255, 1023, 1024, 4096), causal or not,
    group size 1 and 4, hd 64 and 128, B up to 4, fp32 within 2e-5 and
    bf16 within 2e-2 (``tests/test_kernels.py``'s tolerances: the softmax
    sums run in another order, and bf16 outputs of ~[2, 4) round one ulp,
    2^-6, apart); one case with scores scaled to +-1e4 (the online
    softmax's rescaling); the same bits on a second run."""
    def qkv(b, s, h, kv, hd, dtype, scale=1.0):
        def x(*shape, sc=1.0):
            a = rng.standard_normal(shape).astype(np.float32) * sc
            return torch.from_numpy(a).to(dev, dtype)
        return x(b, s, h, hd, sc=scale), x(b, s, kv, hd), x(b, s, kv, hd)

    cases = [(b, s, h, kv, hd, causal, 1.0)
             for hd in (64, 128) for causal in (True, False)
             for s, b in ((1, 4), (63, 3), (64, 2), (65, 4), (127, 3),
                          (128, 2), (129, 4), (255, 2), (1023, 2), (1024, 2),
                          (4096, 1))
             for h, kv in ((8, 8), (8, 2))]
    # q ~ N(0, 1e8), k ~ N(0, 1): scores q.k / sqrt(hd) ~ N(0, 1e8)
    cases.append((1, 130, 8, 2, 128, True, 1e4))
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, s, h, kv, hd, causal, scale in cases:
            q, k, v = qkv(b, s, h, kv, hd, dtype, scale)
            got = flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            name = (f"flash {dtype} B={b} S={s} H={h} KV={kv} hd={hd} "
                    f"causal={causal} q scale {scale:g}")
            check(torch.allclose(got, want, atol=tol, rtol=tol),
                  f"{name}: differs by {float((got - want).abs().max())}")
            check(torch.equal(got, flash_attention(q, k, v, causal=causal)),
                  f"{name}: bits differ between two runs")
    # the scores of the last case reach past +-1e4
    top = torch.einsum("bsd,btd->bst", q[:, :, 0].float(), k[:, :, 0].float())
    check(float(top.abs().max()) / math.sqrt(128) > 1e4, "flash: scores < 1e4")


def phase_semantics(dev) -> None:
    """torch.sort's float order on the card, and the counts carrier."""
    x = torch.tensor([1.0, -0.0, 0.0, float("nan"), -1.0, 0.0, -0.0,
                      float("-inf"), float("nan"), 2.0] * 300)
    cpu = torch.sort(x, stable=True)
    gpu = torch.sort(x.to(dev), stable=True)
    check(torch.equal(gpu.indices.cpu(), cpu.indices),
          "torch.sort float order differs between CPU and CUDA")
    zeros = (x == 0).nonzero().flatten()
    check(torch.equal(gpu.indices.cpu()[(gpu.values.cpu() == 0)], zeros),
          "torch.sort: +-0 not tied")
    check(torch.isnan(gpu.values[-600:]).all().item(), "torch.sort: NaN not last")

    # counts carrier: the only 4-byte column is float32, so the int32 send
    # counts travel as (denormal) float32 bit patterns
    rng = np.random.default_rng(5)
    mesh = VirtualMesh(P)
    cap, cb = 4096, 1500
    tables, pids, want = [], [], np.zeros(P, np.int64)
    for i in range(P):
        rows = 3000 + 100 * i
        col = torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).to(dev)
        tables.append(Table({"x": col}, torch.tensor(rows, dtype=torch.int32,
                                                    device=dev)))
        pid = rng.integers(0, P, cap).astype(np.int32)
        pids.append(torch.from_numpy(pid).to(dev))
        np.add.at(want, pid[:rows], 1)
    for kw in ({"stages": 1}, {"stages": 3}, {"shuffle_mode": "ring"}):
        outs, st = repartition(tables, pids, mesh=mesh, bucket_capacity=cb, **kw)
        check(st.received.cpu().tolist() == want.tolist(),
              f"counts carrier {kw}: received {st.received.tolist()} "
              f"want {want.tolist()}")
        check(int(st.overflow.sum()) == 0, "counts carrier overflow")
        check([int(t.row_count) for t in outs] == want.tolist(),
              "counts carrier row counts")


# ---------------------------------------------------------------------------
# phases 3-4: the main path, through the kernels and through plain versions
# ---------------------------------------------------------------------------


def main_path_calls(ctx: DistContext, a: DistTable, b: DistTable,
                    g: DistTable, w: DistTable):
    aggs = {"d0": ["sum", "count", "mean", "var", "min", "max"]}
    return [
        ("join_sort", lambda: ctx.join(a, b, "k", algorithm="sort")),
        ("join_hash", lambda: ctx.join(a, b, "k", algorithm="hash")),
        ("groupby_two_phase", lambda: ctx.groupby(
            g, "k", aggs, strategy="two_phase", bucket_capacity=256)),
        ("groupby_shuffle", lambda: ctx.groupby(g, "k", aggs, strategy="shuffle")),
        ("sort", lambda: ctx.sort(a, "k")),
        ("window", lambda: ctx.window(w, "k", WINDOW_FUNCS, order_by="o")),
    ]


def summarize(out: DistTable, stats) -> dict:
    """What phase 4 compares: valid rows (trimmed, on the device),
    per-shard row counts and every shuffle's stats."""
    return {"rows": out.to_table().columns,
            "row_counts": out.row_counts.cpu().tolist(),
            "overflow": [s.overflow.cpu().tolist() for s in stats],
            "received": [s.received.cpu().tolist() for s in stats]}


def canonical(cols: dict[str, torch.Tensor], keys) -> dict[str, torch.Tensor]:
    """Rows sorted lexicographically by ``keys`` (bit patterns for floats)."""
    perm = L.lex_sort_perm([_bits(cols[n]) for n in keys])
    return {n: v[perm] for n, v in cols.items()}


def compare_rows(name: str, got: dict, want: dict) -> None:
    """Bitwise equality of the row multisets."""
    names = sorted(want)
    check(sorted(got) == names, f"{name}: columns {sorted(got)} vs {names}")
    a, b = canonical(got, names), canonical(want, names)
    for n in names:
        check(torch.equal(_bits(a[n]), _bits(b[n])), f"{name}: column {n} differs")


def compare_groupby(name: str, got: dict, want: dict) -> float:
    """One row per key: keys, counts, min, max exact; float sums and what
    derives from them (sum, mean, var) within rtol 1e-4 + atol 5e-2 (sum)
    or 1e-4 (mean, var): the plain scatter adds in another order (atomics
    on the card), and a group sums ~4000-33000 standard-normal values.
    Returns the largest difference seen."""
    a, b = canonical(got, ["k"]), canonical(want, ["k"])
    worst = 0.0
    for n in sorted(want):
        x, y = a[n], b[n]
        if n.endswith(("_sum", "_mean", "_var")):
            atol = 5e-2 if n.endswith("_sum") else 1e-4
            check(torch.allclose(x, y, rtol=1e-4, atol=atol),
                  f"{name}: {n} differs by {float((x - y).abs().max())}")
            worst = max(worst, float((x - y).abs().max()) if x.numel() else 0.0)
        else:
            check(torch.equal(x, y), f"{name}: column {n} differs")
    return worst


def window_table(ctx: DistContext, rows: int, device, seed: int = 4):
    """The window input, 16 B a row, 8 shards of ``rows``: ``k`` int32 over
    12 groups (most groups span shards), ``o`` int32 a permutation of the
    global row ids (a unique order), ``d0`` float32 integer-valued over
    [-50, 50], ``d1`` int32 over [-9, 9]. Zero-mean integer data keeps
    every running sum far below 2**24, so float sums are exact."""
    rng = np.random.default_rng(seed)
    n = P * rows
    cols = {"k": rng.integers(0, WINDOW_GROUPS, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "d0": rng.integers(-50, 50, n, endpoint=True).astype(np.float32),
            "d1": rng.integers(-9, 9, n, endpoint=True).astype(np.int32)}
    return ctx.from_local_parts([
        Table.from_numpy({k: v[i * rows:(i + 1) * rows] for k, v in cols.items()},
                         device=device) for i in range(P)])


def make_tables(ctx: DistContext, rows: int, device):
    """Four tables, 8 shards each: two join sides of the paper's relation
    (keys uniform over [0, 8 * rows)), a groupby input (1000 keys) and the
    window input (:func:`window_table`)."""
    def dist(seed, key_range):
        return ctx.from_local_parts([
            random_table(rows, key_range=key_range, seed=seed, shard=i,
                         device=device) for i in range(P)])
    return (dist(1, P * rows), dist(2, P * rows), dist(3, 1000),
            window_table(ctx, rows, device))


def compare_results(name: str, got: dict, want: dict) -> float:
    """One operator's ``summarize`` through the kernels against the plain
    run's; returns the largest float-sum difference (0 outside groupby)."""
    for key in ("row_counts", "overflow", "received"):
        check(got[key] == want[key], f"{name}: {key} {got[key]} vs plain {want[key]}")
    if name.startswith("groupby"):
        return compare_groupby(name, got["rows"], want["rows"])
    if name == "window":  # sorted output: every row, in order
        check(sorted(got["rows"]) == sorted(want["rows"]),
              f"window: columns {sorted(got['rows'])}")
        for n, col in want["rows"].items():
            check(torch.equal(_bits(got["rows"][n]), _bits(col)),
                  f"window: column {n} differs")
        return 0.0
    compare_rows(name, got["rows"], want["rows"])
    return 0.0


def phase_main_path(ctx, tabs):
    """Each call once through the kernels, the launch counts zeroed just
    before the first and read just after the last. Returns the results,
    wall ms and peak device memory per call, and the counts."""
    results, walls, peaks = {}, {}, {}
    torch.cuda.synchronize()
    set_launches(0)
    for name, call in main_path_calls(ctx, *tabs):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, stats = call()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated()
        results[name] = summarize(out, stats)
        del out, stats
    counts = launches()
    for k in RELATIONAL:
        check(counts[k] > 0, f"kernel {k} was not launched on the main path")
    # the window's six scans a shard (dense_rank, rank, cumsum,
    # running_mean, two cummax) are the only segment_scan launches
    check(counts["segment_scan_tiles"] == 6 * P,
          f"segment_scan launched {counts['segment_scan_tiles']} times, "
          f"want {6 * P}")
    check(counts["segment_reduce_tiles"] == SEG_REDUCE_LAUNCHES,
          f"segment_reduce launched {counts['segment_reduce_tiles']} times, "
          f"want {SEG_REDUCE_LAUNCHES}")
    return results, walls, counts, peaks


def phase_plain_path(ctx, tabs, kernel_results) -> dict:
    walls, worst = {}, 0.0
    set_launches(0)
    with kops.oracle_scope():
        for name, call in main_path_calls(ctx, *tabs):
            t0 = time.perf_counter()
            out, stats = call()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
            got = kernel_results[name]
            worst = max(worst, compare_results(name, got, summarize(out, stats)))
            del out, stats
            say(f"  {name}: rows {int(sum(got['row_counts']))}, row_counts, "
                f"overflow {got['overflow']}, received equal to the plain run")
    check(all(v == 0 for v in launches().values()),
          f"plain run launched kernels: {launches()}")
    return {"walls": walls, "worst_float_diff": worst}


def phase_operator_times(ctx, tabs, rounds: int = 2) -> dict[str, dict]:
    """Wall ms per operator through the kernels and through the plain
    versions, in turns (plain, kernels, kernels, plain) x ``rounds``;
    medians of the host clock around each synchronised call."""
    out = {}
    for name, call in main_path_calls(ctx, *tabs):
        samples = {"kernels": [], "plain": []}
        for _ in range(rounds):
            for mode in ("plain", "kernels", "kernels", "plain"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "plain":
                    with kops.oracle_scope():
                        res = call()
                else:
                    res = call()
                torch.cuda.synchronize()
                samples[mode].append((time.perf_counter() - t0) * 1e3)
                del res
        out[name] = {m: statistics.median(v) for m, v in samples.items()}
        out[name]["samples"] = len(samples["kernels"])
    return out


def phase_profile(ctx, tabs, top: int = 8) -> dict[str, dict]:
    """One :func:`profiled` run of each operator through the kernels."""
    return {name: profiled(name, call, top)
            for name, call in main_path_calls(ctx, *tabs)}


def profiled(name: str, call, top: int = 8) -> dict:
    """One ``torch.profiler`` run of ``call``: wall ms (with the profiler's
    overhead), the summed device time of its GPU kernels, their ratio (the
    device's busy share; the port uses one stream), the device time of the
    port's own CUDA kernels (``PORTED_KERNELS``) and the kernels that took
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del res
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    check(busy > 0, f"profile of {name}: no device time recorded")
    ported = sum(ms for kname, ms in by_name.items()
                 if any(k in kname for k in PORTED_KERNELS))
    # torch ops the host dispatched (top-level: not those inside another op)
    host_ops = sum(1 for ev in prof.events() if ev.device_type ==
                   DeviceType.CPU and ev.cpu_parent is None and
                   ev.name.startswith("aten::"))
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "ported_kernels_ms": ported, "host_ops": host_ops,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


# ---------------------------------------------------------------------------
# phase 7: per-kernel times at the path's shapes
# ---------------------------------------------------------------------------


def phase_timing(dev, rows: int) -> dict[str, dict]:
    timer = Timer(dev)
    rng = np.random.default_rng(11)
    out = {}

    # hash32: one shard's int32 key column (hash_partition)
    x = torch.from_numpy(rng.integers(0, P * rows, rows).astype(np.int32)).to(dev)
    ms = timer(lambda: hash32(x, 7))
    plain = timer(lambda: ref.hash32_ref(x, 7))
    # the function's bytes: a 4-byte value in and a u32 hash out a row (the
    # port's int64 holder writes 4 B more; that is the port's cost, not the
    # bound's)
    bms, by = bound_ms(rows * (4 + 4), rows * 10)
    out["hash32"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=None, max_abs_err=float(
                             (hash32(x, 7) - ref.hash32_ref(x, 7)).abs().max()))

    # bucket_histogram: one shard's destinations, P = 8, -1 on invalid rows
    ids = torch.from_numpy(rng.integers(0, P, rows).astype(np.int32)).to(dev)
    ids[rows - rows // 16:] = -1
    shifted = ids + 1
    ms = timer(lambda: bucket_histogram(ids, P))
    plain = timer(lambda: ref.histogram_ref(ids, P))
    lib = timer(lambda: torch.bincount(shifted, minlength=P + 1))
    bms, by = bound_ms(rows * 4 + P * 4, rows * 3)
    out["bucket_histogram"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float((bucket_histogram(ids, P)
                           - ref.histogram_ref(ids, P)).abs().max()))

    # bitonic: the two-phase combine's one 2048-pair tile of u32 keys
    tile = 2048
    keys = torch.from_numpy(rng.integers(0, 1000, tile).astype(np.int64)).to(dev)
    pay = torch.arange(tile, dtype=torch.int32, device=dev)
    ms = timer(lambda: bitonic_sort_tiles(keys, pay, tile=tile))
    plain = timer(lambda: ref.sort_tiles_ref(keys, pay, tile))
    lib = timer(lambda: torch.sort(keys.view(1, tile), dim=1, stable=True))
    # u32 key + int32 payload a pair, read once and written once (the
    # port's int64 key holder moves 4 B more a pair each way)
    passes = 11 * 12 // 2
    bms, by = bound_ms(2 * tile * (4 + 4), passes * (tile // 2) * 6)
    ko, vo = bitonic_sort_tiles(keys, pay, tile=tile)
    rk, rv = ref.sort_tiles_ref(keys, pay, tile)
    out["bitonic_sort_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float(max((ko - rk).abs().max(), (vo - rv).abs().max())))

    # segment_reduce: groupby shuffle's f32 sum, G = n = 8 shards * 2 * rows
    # / 8 (one shard's received capacity), ~125 sorted groups, -1 tail
    n = 2 * rows
    groups = 125
    valid = n // 2
    seg = np.full(n, -1, np.int32)
    seg[:valid] = np.sort(rng.integers(0, groups, valid)).astype(np.int32)
    seg_t = torch.from_numpy(seg).to(dev)
    vals = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    idx = torch.where(seg_t >= 0, seg_t, n).to(torch.int64)
    base = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    ms = timer(lambda: segment_reduce_tiles(vals, seg_t, n, "sum",
                                            contiguous_runs=True))
    plain = timer(lambda: ref.segment_reduce_ref(vals, seg_t, n, "sum"))
    lib = timer(lambda: torch.scatter_reduce(base, 0, idx, vals, "sum"))
    bms, by = bound_ms(n * 8 + n * 4, n)
    err = (segment_reduce_tiles(vals, seg_t, n, "sum", contiguous_runs=True)
           - ref.segment_reduce_ref(vals, seg_t, n, "sum")).abs().max()
    out["segment_reduce_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float(err))

    # segment_scan: one shard's window input, P x the range bucket (2**21)
    # = 2**24 slots, int32 values (dense_rank's run starts), ids sorted over
    # ~2 groups on the first 2**22 rows, then the -1 tail
    n = P * (4 * rows // P)
    valid = rows
    seg = np.full(n, -1, np.int32)
    seg[:valid] = np.sort(rng.integers(0, 2, valid)).astype(np.int32)
    seg_t = torch.from_numpy(seg).to(dev)
    vals = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    ms = timer(lambda: segment_scan_tiles(vals, seg_t, "sum"))
    plain = timer(lambda: ref.segment_scan_ref(vals, seg_t, "sum"))
    # no single PyTorch call computes a segmented scan; torch.cumsum of the
    # same column is an unsegmented scan over the same bytes
    cumsum_ms = timer(lambda: torch.cumsum(vals, 0, dtype=torch.int32))
    bms, by = bound_ms(n * (4 + 4 + 4), n)
    err = (segment_scan_tiles(vals, seg_t, "sum")
           - ref.segment_scan_ref(vals, seg_t, "sum")).abs().max()
    out["segment_scan_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=float(err), cumsum_ms=cumsum_ms, n=n)

    # flash_attention: one layer of the serving path's prefill, llama3-8b's
    # heads over 4 x 1024 tokens, bf16, causal
    cfg = get_config(LM_ARCH)
    b, s, h, kv, hd = LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    ms = timer(lambda: flash_attention(q, k, v))
    plain = timer(lambda: ref.attention_ref(q, k, v))
    # the port never calls SDPA: it is timed here as the yardstick
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    # q, k, v read once and out written once; the products of the
    # s (s + 1) / 2 unmasked (query, key) pairs: 2 hd for q k and 2 hd for
    # p v each, on the bf16 tensor cores
    bms, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * b * h * hd * s * (s + 1) / 2, TENSOR_BF16_OPS_PER_S)
    want = ref.attention_ref(q, k, v)
    lib_out = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    out["flash_attention"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float((flash_attention(q, k, v) - want).float().abs().max()),
        library_max_abs_err=float((lib_out - want).float().abs().max()))
    return out


# ---------------------------------------------------------------------------
# phases 8-10: the serving path (llama3-8b), through the kernel and plain
# ---------------------------------------------------------------------------


def logit_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_serve(dev):
    """Phase 8: the model at full width and depth, and one ``generate``
    through the kernel, the counts zeroed just before and read just after;
    then one more decode step, which must launch nothing."""
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = prompts(cfg, LM_BATCH, LM_PROMPT, 0, dev)
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    gen = generate(model, tokens, LM_GEN, keep_logits=True)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == cfg.num_layers,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"generate, want {cfg.num_layers} (once a layer, in the prefill)")
    check(all(counts[k] == 0 for k in RELATIONAL), f"serving launched {counts}")
    check(tuple(gen.tokens.shape) == (LM_BATCH, LM_GEN), "generated shape")
    check(bool(((gen.tokens >= 0) & (gen.tokens < cfg.padded_vocab)).all()),
          "generated token ids out of range")
    check(tuple(gen.logits[0].shape) == (LM_BATCH, cfg.padded_vocab) and
          all(tuple(x.shape) == (LM_BATCH, cfg.vocab_size)
              for x in gen.logits[1:]), "logits shapes")
    check(all(bool(torch.isfinite(x).all()) for x in gen.logits),
          "non-finite logits on the serving path")
    set_launches(0)
    with torch.no_grad():
        last, _ = make_decode_step(model)(gen.cache, gen.tokens[:, -1:],
                                          LM_PROMPT + LM_GEN - 1)
    check(launches()["flash_attention"] == 0, "a decode step launched flash")
    check(bool(torch.isfinite(last).all()), "non-finite decode logits")
    gen.cache = None
    return model, tokens, gen, counts, peak, init_s, n_params


def phase_serve_plain(model, tokens, gen) -> dict:
    """Phase 9: the plain run teacher-forced with the kernel run's tokens,
    and the serving invariant against one causal forward."""
    cfg = model.cfg
    set_launches(0)
    with kops.oracle_scope():
        plain = generate(model, tokens, LM_GEN, forced=gen.tokens,
                         keep_logits=True)
    check(all(v == 0 for v in launches().values()),
          f"plain serving run launched kernels: {launches()}")
    plain_errs = [logit_err(a, b) for a, b in zip(gen.logits, plain.logits)]
    check(max(plain_errs) <= LM_TOL,
          f"serving logits differ from the plain run by {max(plain_errs)}")
    # greedy tokens: with random weights the top-2 margins sit near bf16's
    # resolution, so a token is held equal only where the kernel run's
    # margin exceeds the tolerance; teacher forcing makes every step's
    # token comparable, not only the first
    margins = torch.stack([(lambda t: t[:, 0] - t[:, 1])(
        torch.topk(x.float(), 2, dim=-1).values) for x in gen.logits], 1)
    sure = margins > LM_TOL
    check(torch.equal(gen.tokens[sure], plain.tokens[sure]),
          f"a greedy token differs from the plain run where the margin "
          f"exceeds {LM_TOL}")
    same_plain = int((gen.tokens == plain.tokens).sum())
    del plain

    seq = torch.cat([tokens, gen.tokens[:, :LM_GEN - 1]], 1)
    set_launches(0)
    with torch.no_grad():
        full, _, _ = model.forward(tokens=seq)
    check(launches()["flash_attention"] == cfg.num_layers,
          "the causal forward did not run flash once a layer")
    rows = full[:, LM_PROMPT - 1:, :cfg.vocab_size]
    del full
    inv_errs = [logit_err(g[:, :cfg.vocab_size], rows[:, i])
                for i, g in enumerate(gen.logits)]
    check(max(inv_errs) <= LM_TOL,
          f"prefill + decode differ from the causal forward by {max(inv_errs)}")
    same = int((rows.argmax(-1).to(torch.int32) == gen.tokens).sum())
    return {"plain_max_abs_err": max(plain_errs),
            "plain_err_by_step": plain_errs,
            "first_token_margins": margins[:, 0].tolist(),
            "tokens_checked": int(sure.sum()),
            "plain_same_greedy_tokens": same_plain,
            "causal_max_abs_err": max(inv_errs),
            "causal_err_by_step": inv_errs,
            "causal_same_greedy_tokens": same}


def phase_serve_times(model, tokens, reps: int = 5) -> dict:
    """Phase 10: prefill median ms (host clock around a synchronised call),
    decode ms a token and tokens/s (medians of three ``generate`` runs)."""
    prefill = make_prefill_step(model, LM_PROMPT + LM_GEN)
    walls = []
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del res
    decode_ms, decode_tok_s, e2e_tok_s = [], [], []
    for _ in range(3):
        g = generate(model, tokens, LM_GEN)
        decode_ms.append(g.decode_s / (LM_GEN - 1) * 1e3)
        decode_tok_s.append(LM_BATCH * (LM_GEN - 1) / g.decode_s)
        e2e_tok_s.append(LM_BATCH * LM_GEN / (g.prefill_s + g.decode_s))
        del g
    return {"prefill_ms": statistics.median(walls), "prefill_runs": reps,
            "decode_ms_per_token": statistics.median(decode_ms),
            "decode_tokens_per_s": statistics.median(decode_tok_s),
            "end_to_end_tokens_per_s": statistics.median(e2e_tok_s)}


def phase_serve_profile(model, tokens, steps: int = 8) -> dict:
    """Phase 10's traces: one prefill, then ``steps`` decode steps."""
    prefill = make_prefill_step(model, LM_PROMPT + LM_GEN)
    decode = make_decode_step(model)
    held = {}

    def run_prefill():
        with torch.no_grad():
            held["logits"], held["cache"] = prefill({"tokens": tokens})

    def run_decode():
        tok = torch.argmax(held["logits"], -1)[:, None].to(torch.int32)
        with torch.no_grad():
            for i in range(steps):
                logits, _ = decode(held["cache"], tok, LM_PROMPT + i)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)

    # the serving path launches no ported kernel but flash (phase 8's
    # counts), so ``ported_kernels_ms`` is flash's device time
    return {"prefill": profiled("prefill", run_prefill),
            f"decode x{steps}": profiled("decode", run_decode)}


# ---------------------------------------------------------------------------


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is "
              "False", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    card = nvidia_smi()
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    say(f"[1] built {len(_build.sources())} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    t0 = time.perf_counter()
    phase_kernels(dev)
    say(f"[2] kernels equal their plain versions ({time.perf_counter() - t0:.1f} s)")
    phase_semantics(dev)
    say("[2] torch.sort float order on CUDA == CPU; counts carrier survives a "
        "float32 column")

    rows = ROWS
    ctx = DistContext(num_shards=P)
    t0 = time.perf_counter()
    tabs = make_tables(ctx, rows, dev)
    torch.cuda.synchronize()
    say(f"[3] tables: {len(tabs)} x {P} shards x {rows} rows made in "
        f"{time.perf_counter() - t0:.1f} s")
    res, walls, counts, peaks = phase_main_path(ctx, tabs)
    peak = max(peaks.values())
    for name, ms in walls.items():
        r = res[name]
        say(f"[3] {name}: {ms:.1f} ms wall, rows {sum(r['row_counts'])}, "
            f"overflow {r['overflow']}, peak {peaks[name] / 2**30:.2f} GiB")
    say(f"[3] peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    check(all(sum(o) == 0 for r in res.values() for o in r["overflow"]),
          "overflow on the main path")

    plain = phase_plain_path(ctx, tabs, res)
    say(f"[4] plain run equal; largest float-sum difference "
        f"{plain['worst_float_diff']:.3g}")
    for name, ms in plain["walls"].items():
        say(f"[4] {name}: plain {ms:.1f} ms wall (kernels {walls[name]:.1f} ms)")
    op_ms = phase_operator_times(ctx, tabs)
    for name, t in op_ms.items():
        say(f"[5] {name}: median {t['kernels']:.1f} ms through the kernels, "
            f"{t['plain']:.1f} ms plain ({t['samples']} runs each, in turns) "
            f"on {card}")
    prof = phase_profile(ctx, tabs)
    for name, pr in prof.items():
        say(f"[6] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, "
            f"ported kernels {pr['ported_kernels_ms']:.2f} ms")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.2f} ms  {kname[:110]}")
    del res, tabs
    torch.cuda.empty_cache()

    for src, (secs, _) in sorted(_build.LOGS.items()):
        say(f"[7] nvcc {src}: {secs:.1f} s (all sources compiled together)")
    lib = _build.library()
    for r in ptxas_report():
        hd = re.search(r"<(\d+)>", r["kernel"]) if "flash" in r["kernel"] else None
        dyn = (f", {lib.repro_flash_attention_smem(int(hd.group(1)))} B dynamic"
               if hd else "")
        say(f"[7] ptxas {r['kernel']}: {r.get('registers')} registers, spills "
            f"{r.get('spill_store_bytes')} B stored / {r.get('spill_load_bytes')}"
            f" B loaded, {r.get('static_smem_bytes')} B static shared memory"
            f"{dyn}")
    times = phase_timing(dev, rows)
    t = times["segment_scan_tiles"]
    say(f"[7] torch.cumsum (unsegmented) of segment_scan's column, "
        f"{t['n']} int32: {t['cumsum_ms']:.4f} ms on {card}")
    say(f"[7] flash_attention: SDPA's output differs from the plain version's "
        f"by {times['flash_attention']['library_max_abs_err']:.4g}")
    torch.cuda.empty_cache()

    model, tokens, gen, lm_counts, lm_peak, init_s, n_params = phase_serve(dev)
    say(f"[8] {LM_ARCH}: {n_params} parameters drawn in {init_s:.1f} s; "
        f"{LM_BATCH} x {LM_PROMPT}-token prompts, {LM_GEN} greedy tokens: "
        f"prefill {gen.prefill_s * 1e3:.1f} ms, decode "
        f"{gen.decode_s / (LM_GEN - 1) * 1e3:.2f} ms a token (first run); "
        f"peak {lm_peak / 2**30:.2f} GiB; launches {lm_counts}; a decode step "
        f"launches none")
    say(f"[8] generated (first row): {gen.tokens[0].tolist()}")
    agree = phase_serve_plain(model, tokens, gen)
    say(f"[9] plain run, teacher-forced: logits within "
        f"{agree['plain_max_abs_err']:.4g} (tolerance {LM_TOL}); greedy "
        f"tokens equal on all {agree['tokens_checked']} of "
        f"{LM_BATCH * LM_GEN} with a top-2 margin > {LM_TOL}, and on "
        f"{agree['plain_same_greedy_tokens']} in all; first tokens' margins "
        f"{[round(m, 4) for m in agree['first_token_margins']]}")
    say(f"[9] prefill + decode vs one causal forward over "
        f"{LM_PROMPT + LM_GEN - 1} tokens: within "
        f"{agree['causal_max_abs_err']:.4g} (tolerance {LM_TOL}); its greedy "
        f"tokens equal on {agree['causal_same_greedy_tokens']} of "
        f"{LM_BATCH * LM_GEN}")
    del gen
    serve_times = phase_serve_times(model, tokens)
    say(f"[10] prefill median {serve_times['prefill_ms']:.2f} ms, decode "
        f"{serve_times['decode_ms_per_token']:.3f} ms a token, "
        f"{serve_times['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{serve_times['end_to_end_tokens_per_s']:.1f} tokens/s end to end, "
        f"peak {lm_peak / 2**30:.2f} GiB on {card}")
    serve_prof = phase_serve_profile(model, tokens)
    for name, pr in serve_prof.items():
        say(f"[10] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"flash {pr['ported_kernels_ms']:.3f} ms, {pr['host_ops']} torch "
            f"ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")
    del model, tokens

    kernels = []
    for name, (fn, source, replaces) in KERNELS.items():
        t = times[name]
        say(f"[7] {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
            f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)}"
            f", bound {t['bound_ms']:.5f} by {t['bound_by']}) on {card}")
        n = lm_counts[name] if name == "flash_attention" else counts[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    say(json.dumps({"serve": {
        "arch": LM_ARCH, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
        "gen": LM_GEN, "parameters": n_params, "peak_bytes": lm_peak,
        "launches": lm_counts, **serve_times, **agree,
        "profile": {k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
                        "busy_share": v["busy_share"],
                        "flash_ms": v["ported_kernels_ms"],
                        "host_ops": v["host_ops"]}
                    for k, v in serve_prof.items()},
    }}))
    say(json.dumps({"main_path": {
        "rows_per_shard": rows, "peak_bytes": peak, "peak_bytes_by_call": peaks,
        "first_run_wall_ms": walls, "first_plain_run_wall_ms": plain["walls"],
        "operator_median_ms": op_ms,
        "profile": {k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
                        "busy_share": v["busy_share"],
                        "ported_kernels_ms": v["ported_kernels_ms"]}
                    for k, v in prof.items()},
    }}))
    say(json.dumps({"kernels": kernels}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
