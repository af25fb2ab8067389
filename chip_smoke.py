"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Phases (any failed check raises, and the script exits nonzero):

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel from ``src/repro_torch/kernels/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge shapes: exact equality (float sums on
   integer-valued data). Also torch.sort's float order on the card and the
   shuffle's counts carrier in a float32 column.
3. The main path at a size users run: tables of the paper's relation
   (int32 key + 3 float32, 16 B a row), 8 virtual shards x 2**22 rows each
   (512 MiB a table), through ``DistContext``: the sort join, the hash join,
   groupby two_phase (bucket 256, so the combine sorts 2048 rows on the
   bitonic kernel) and groupby shuffle (segment counts of 8 M) on
   ``key_range=1000``, and the global sort. Launch counts are zeroed just
   before and read just after; every kernel must have launched.
4. The same calls under ``oracle_scope()`` (every plain version, on the
   card, no launches): the same rows, per-shard row counts and shuffle
   stats, bit for bit; float sums and what derives from them (sum, mean,
   var) within the tolerance stated in ``compare_groupby``.
5. Each operator's median wall time through the kernels and through the
   plain versions, run in turns.
6. One ``torch.profiler`` trace of each operator through the kernels (GPU
   busy share, the kernels that took the most device time).
7. Each kernel's median time at the path's shape beside its plain
   version's, one PyTorch library call's where one computes the same
   function, and the least time the card could take (``bound_ms``).

It prints one JSON line with the main path's numbers, one with every
kernel's, then the nvidia-smi line, then ``{"ok": true, "device": {...}}``
as the last line. Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

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
from repro_torch.kernels.hash64 import hash32  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402

P = 8
ROWS = 1 << 22  # rows per shard: 8 x 4 Mi rows, 512 MiB a table
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
# outside the tensor cores, used for 32-bit scalar integer/float ops.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

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
}


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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
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
    torch.cuda.synchronize()


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
                    g: DistTable):
    aggs = {"d0": ["sum", "count", "mean", "var", "min", "max"]}
    return [
        ("join_sort", lambda: ctx.join(a, b, "k", algorithm="sort")),
        ("join_hash", lambda: ctx.join(a, b, "k", algorithm="hash")),
        ("groupby_two_phase", lambda: ctx.groupby(
            g, "k", aggs, strategy="two_phase", bucket_capacity=256)),
        ("groupby_shuffle", lambda: ctx.groupby(g, "k", aggs, strategy="shuffle")),
        ("sort", lambda: ctx.sort(a, "k")),
    ]


def summarize(out: DistTable, stats) -> dict:
    """What phase 4 compares: valid rows (trimmed, on the device),
    per-shard row counts and every shuffle's stats."""
    return {"rows": out.to_table().columns,
            "row_counts": out.row_counts.cpu().tolist(),
            "overflow": [s.overflow.cpu().tolist() for s in stats],
            "received": [s.received.cpu().tolist() for s in stats]}


def _bits(c: torch.Tensor) -> torch.Tensor:
    return c.view(torch.int32) if c.dtype == torch.float32 else c


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


def make_tables(ctx: DistContext, rows: int, device):
    """Three tables of the paper's relation, 8 shards each: two join sides
    (keys uniform over [0, 8 * rows)) and a groupby input (1000 keys)."""
    def dist(seed, key_range):
        return ctx.from_local_parts([
            random_table(rows, key_range=key_range, seed=seed, shard=i,
                         device=device) for i in range(P)])
    return dist(1, P * rows), dist(2, P * rows), dist(3, 1000)


def compare_results(name: str, got: dict, want: dict) -> float:
    """One operator's ``summarize`` through the kernels against the plain
    run's; returns the largest float-sum difference (0 outside groupby)."""
    for key in ("row_counts", "overflow", "received"):
        check(got[key] == want[key], f"{name}: {key} {got[key]} vs plain {want[key]}")
    if name.startswith("groupby"):
        return compare_groupby(name, got["rows"], want["rows"])
    compare_rows(name, got["rows"], want["rows"])
    return 0.0


def phase_main_path(ctx, a, b, g):
    results, walls = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    for name, call in main_path_calls(ctx, a, b, g):
        t0 = time.perf_counter()
        out, stats = call()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        results[name] = summarize(out, stats)
        del out, stats
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    return results, walls, counts, peak


def phase_plain_path(ctx, a, b, g, kernel_results) -> dict:
    walls, worst = {}, 0.0
    set_launches(0)
    with kops.oracle_scope():
        for name, call in main_path_calls(ctx, a, b, g):
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


def phase_operator_times(ctx, a, b, g, rounds: int = 2) -> dict[str, dict]:
    """Wall ms per operator through the kernels and through the plain
    versions, in turns (plain, kernels, kernels, plain) x ``rounds``;
    medians of the host clock around each synchronised call."""
    out = {}
    for name, call in main_path_calls(ctx, a, b, g):
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


def phase_profile(ctx, a, b, g, top: int = 8) -> dict[str, dict]:
    """One ``torch.profiler`` run of each operator through the kernels: wall
    ms (with the profiler's overhead), the summed device time of its GPU
    kernels, their ratio (the device's busy share; the port uses one
    stream) and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, call in main_path_calls(ctx, a, b, g):
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
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "busy_share": busy / wall,
                     "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}
    return out


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
    return out


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
    a, b, g = make_tables(ctx, rows, dev)
    torch.cuda.synchronize()
    say(f"[3] tables: 3 x {P} shards x {rows} rows made in "
        f"{time.perf_counter() - t0:.1f} s")
    res, walls, counts, peak = phase_main_path(ctx, a, b, g)
    for name, ms in walls.items():
        r = res[name]
        say(f"[3] {name}: {ms:.1f} ms wall, rows {sum(r['row_counts'])}, "
            f"overflow {r['overflow']}")
    say(f"[3] peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    check(all(sum(o) == 0 for r in res.values() for o in r["overflow"]),
          "overflow on the main path")

    plain = phase_plain_path(ctx, a, b, g, res)
    say(f"[4] plain run equal; largest float-sum difference "
        f"{plain['worst_float_diff']:.3g}")
    for name, ms in plain["walls"].items():
        say(f"[4] {name}: plain {ms:.1f} ms wall (kernels {walls[name]:.1f} ms)")
    op_ms = phase_operator_times(ctx, a, b, g)
    for name, t in op_ms.items():
        say(f"[5] {name}: median {t['kernels']:.1f} ms through the kernels, "
            f"{t['plain']:.1f} ms plain ({t['samples']} runs each, in turns) "
            f"on {card}")
    prof = phase_profile(ctx, a, b, g)
    for name, pr in prof.items():
        say(f"[6] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.2f} ms  {kname[:110]}")
    del res, a, b, g
    torch.cuda.empty_cache()

    times = phase_timing(dev, rows)
    kernels = []
    for name, (fn, source, replaces) in KERNELS.items():
        t = times[name]
        say(f"[7] {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
            f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)}"
            f", bound {t['bound_ms']:.5f} by {t['bound_by']}) on {card}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    say(json.dumps({"main_path": {
        "rows_per_shard": rows, "peak_bytes": peak,
        "first_run_wall_ms": walls, "first_plain_run_wall_ms": plain["walls"],
        "operator_median_ms": op_ms,
        "profile": {k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
                        "busy_share": v["busy_share"]} for k, v in prof.items()},
    }}))
    say(json.dumps({"kernels": kernels}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
