"""Where a benchmark cell's time goes, by the program's own spans and
counters (``repro_torch.core.trace``). On one CUDA card, from the root of a
checkout:

    python3 tools/trace_cells.py [--cells join.uniform,groupby.q5] \
        [--seed N] [--out results/torch/trace_cells.json]

(``--device cpu --rows 256`` rehearses it on the CPU: no device times.)

Each cell is set up as ``bench/run.py`` sets it up (its tables made on the
card from the seed, the traffic's warm-up calls), then:

* spans: ``CALLS`` calls under the profiler inside ``trace.spanning()``,
  reduced by :func:`reduce_spans`: each span's host and device ms a call,
  the share of the device's busy time the ``repro_torch.op.*`` spans cover,
  the device operations that take the most time, and each idle gap named
  ``<innermost program span> > <innermost host operator>``;
* counters: one call inside ``trace.counting()``: rows received over the
  exchanges' send slots, result rows over the local joins' slots; and in
  the same call the ``segment_reduce`` seam's calls that took the plain
  route (``kops.segment_reduce.plain_calls``) beside the kernel's launches
  (``segment_reduce_tiles.launches``);
* syncs: one call under ``torch.cuda.set_sync_debug_mode("warn")``, each
  warning by the program's line that made it;
* cost: ``CALLS`` profiled calls with the spans on and off in turns (on,
  off, off, on), host ms a call.

A span's device time is the device's busy time under the profiler's
device-side ranges of that span (``gpu_user_annotation``: each holds the
operations launched while the span was the innermost one open, the port's
``ctypes``-launched kernels included); a layer's is that of its span and
every span under it. The device operations, their union and the idle
gaps are ``bench.profiling``'s own; only the reduction by span is this
tool's. Prints one JSON line a cell and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench.profiling import (CALL_RANGE, Trace, _union_seconds,  # noqa: E402
                             busy_seconds, reduce_profile)

PREFIX = "repro_torch."
CALLS = 3
TOP_OPS = 8  # device operations listed by their time
GAP_US = 100.0  # an idle gap this long inside a call should be named by a span


class _Events:
    """A profile seen through some of its events: what
    ``bench.profiling.reduce_profile`` reads of a profile."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def reduce_spans(events, calls: int) -> dict:
    """A profile of ``calls`` calls with the program's spans on, reduced.

    ``events`` are ``prof.events()``, each call inside a ``bench.call``
    range as the harness makes its calls. The device operations and the
    idle gaps between them are the benchmark's own (``reduce_profile``,
    with the spans' device-side ranges left out); a span's device-side
    ranges are the events on the device with its name: each holds the
    device operations launched while the span was the innermost one
    open."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = [e for e in cpu if e.name.startswith(PREFIX)]
    ops = [e for e in dev if not e.name.startswith(PREFIX)]
    own: dict[str, list] = {}
    for a in dev:
        if a.name.startswith(PREFIX):
            own.setdefault(a.name, []).append(
                (a.time_range.start, a.time_range.end))

    # each gap named by the innermost host operator, and the same gaps by
    # the innermost program span or call range
    hosts, inner = Trace(), Trace()
    reduce_profile(_Events(cpu + ops), hosts)
    reduce_profile(_Events([e for e in cpu if e.name.startswith(PREFIX) or
                            e.name == CALL_RANGE] + ops), inner)
    busy = [(s, e) for _, s, e in hosts.device_ops]
    busy_ms = busy_seconds(hosts.device_ops) * 1e3 / calls

    def under(*heads):
        """Busy ms a call under the spans whose names start with one of
        ``heads``: |busy| + |spans| - |busy or spans|."""
        ivs = [iv for n, got in own.items() if n.startswith(heads)
               for iv in got]
        both = _union_seconds(ivs)[0] - _union_seconds(busy + ivs)[0]
        return busy_ms + both * 1e3 / calls if ivs else 0.0

    top: Counter = Counter()
    for name, s, e in hosts.device_ops:
        top[name] += (e - s) / 1e3 / calls

    spans: dict[str, dict] = {}
    for e in ranges:
        rec = spans.setdefault(e.name, {"n": 0, "host_ms": 0.0})
        rec["n"] += 1 / calls
        rec["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    for name, rec in spans.items():
        rec["device_ms"] = under(name)  # its own operations: self time

    gaps: dict[str, float] = {}
    unnamed_in_call: list = []
    for (host, secs), (span, _) in zip(hosts.gaps, inner.gaps):
        if not span.startswith(PREFIX):
            name = host
            if span == CALL_RANGE and secs * 1e6 >= GAP_US:
                unnamed_in_call.append([name, secs * 1e3])
        elif host == span:
            name = span
        else:
            name = f"{span} > {host}"
        gaps[name] = gaps.get(name, 0.0) + secs * 1e3 / calls

    # the operators' spans and their children (these open only inside one)
    op_ms = under(PREFIX + "op.", PREFIX + "exchange", PREFIX + "join.",
                  PREFIX + "groupby.")
    exchange = under(PREFIX + "exchange")
    local_join = under(PREFIX + "join.local")
    aggregate = under(PREFIX + "groupby.")
    return {
        "busy_ms": busy_ms,
        "device_ranges": sum(map(len, own.values())),
        "op_ms": op_ms,
        "op_cover": op_ms / busy_ms if busy_ms else None,
        "inner_cover": (exchange + local_join + aggregate) / op_ms
        if op_ms else None,
        "plan_host_ms": spans.get(PREFIX + "plan", {}).get("host_ms"),
        "exchange_device_ms": exchange,
        "local_join_device_ms": local_join,
        "aggregate_device_ms": aggregate,
        "spans": spans,
        "top_ops_ms": top.most_common(TOP_OPS),
        "idle_gaps_ms": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        # idle gaps of 0.1 ms or more inside a call that no span names
        "gaps_in_a_call_unnamed": unnamed_in_call,
    }


def fills(counts: dict) -> dict:
    """The counters' ratios, in %: rows received over the exchanges' send
    slots, result rows over the local joins' slots."""
    def pct(num, den):
        return 100.0 * counts[num] / counts[den] if counts.get(den) else None
    return {"exchange_fill_pct": pct("exchange.rows_received",
                                     "exchange.slots"),
            "join_fill_pct": pct("join.rows_out", "join.slots"),
            "counts": counts}


def _cell(name: str, seed: int, device, rows: int | None) -> dict:
    import importlib

    import torch

    from bench import harness
    from bench.tables import make_tables
    from repro_torch.core import trace
    from repro_torch.core.context import DistContext
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.segment_reduce import segment_reduce_tiles

    cell = harness.find_cell(name)
    traffic = cell.traffic
    op = importlib.import_module(f"bench.ops.{traffic['op']}")
    ctx = DistContext(num_shards=cell.workers, device=device)
    tables = make_tables(cell.config, traffic, seed, device, rows)
    state = op.prepare(ctx, tables, traffic)
    del tables

    cuda = device.type == "cuda"

    def call():
        """One call of the cell, in this tool's range, then a sync (outside
        it, as the harness makes its calls)."""
        with torch.profiler.record_function(CALL_RANGE):
            op.call(ctx, state, traffic)
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(int(traffic.get("warmup_calls", 2))):
        call()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def profiled(on: bool):
        """(host ms of each call, the profile) with the spans on or off."""
        ms = []
        with trace.spanning(on), torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                t = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t) * 1e3)
        return ms, prof

    ms_on, prof = profiled(True)
    res = {"cell": name, "seed": seed, "torch": torch.__version__,
           **reduce_spans(list(prof.events()), CALLS)}
    del prof
    seam = (kops.segment_reduce.plain_calls, segment_reduce_tiles.launches)
    with trace.counting() as c:
        call()
    res.update(fills(c.resolve()))
    res["segment_reduce"] = {
        "plain_calls": kops.segment_reduce.plain_calls - seam[0],
        "tiles_launches": segment_reduce_tiles.launches - seam[1]}
    seen = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            op.call(ctx, state, traffic)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(device)
    res["syncs"] = dict(Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message)
        and "prototype" not in str(w.message)).most_common())
    cost = {True: list(ms_on), False: []}
    for on in (False, False, True):
        cost[on].extend(profiled(on)[0])
    res["traced_call_ms"] = {"spans_on": statistics.median(cost[True]),
                             "spans_off": statistics.median(cost[False]),
                             "on": cost[True], "off": cost[False]}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="join.uniform,groupby.q5,"
                    "join.copartitioned")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--out", default="results/torch/trace_cells.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows a worker (default: the configuration's)")
    args = ap.parse_args(argv)
    import gc

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = []
    for i, name in enumerate(args.cells.split(",")):
        res = _cell(name, args.seed + i, device, args.rows)
        res["device"] = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        print(json.dumps(res), flush=True)
        out.append(res)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
