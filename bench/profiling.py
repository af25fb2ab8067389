"""What a traced run reads: host synchronisations, a profiler trace of a few
steady calls reduced to numbers, and the shapes each kernel seam was
called with.

The reductions are frozen copies of ``chip_smoke.py``'s methods, with the
busy share taken from the union of device intervals over the traced window
rather than summed kernel time over a wall that includes the profiler:

* host synchronisations: ``torch.cuda.set_sync_debug_mode("warn")``'s
  warnings during the program's call (``chip_smoke.count_syncs``);
* host operations: the ``aten::`` operators the host dispatched that run
  inside no other ``aten::`` operator (``chip_smoke.profiled``), counted
  inside the harness's ``bench.call`` ranges only;
* device time under a seam: the profiler's device-side span of the
  ``bench.seam.<name>`` range the harness opens around a call of
  ``repro_torch.kernels.ops.<name>``: from the start of the first device
  operation launched inside the range to the end of the last. The
  kernels' own launches (a ``ctypes`` library with its own CUDA runtime)
  are not reliably linked to the host operator that made them, but the
  range's span is, and on one stream nothing else runs inside it.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import warnings

import torch

CALL_RANGE = "bench.call"
SEAM_RANGE = "bench.seam."
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """A traced run reduced to what the per-layer readers take."""

    calls: int = 0
    host_ops: int = 0
    sync_calls: int = 0
    syncs: int | None = None
    window_s: float = 0.0
    # (name, start us, end us) of every device operation in the window
    device_ops: list = dataclasses.field(default_factory=list)
    # seam -> {"launched": calls seen in the trace, "device_s": seconds}
    seams: dict = dataclasses.field(default_factory=dict)
    # seam -> the meter records of one metered call
    metered: dict = dataclasses.field(default_factory=dict)
    metered_calls: int = 0
    # each traced call's shuffle records (the program's ``report=``)
    reports: list = dataclasses.field(default_factory=list)
    # (name, seconds) the host spent in its innermost operator while the
    # device was idle, one entry per gap
    gaps: list = dataclasses.field(default_factory=list)


def count_syncs(call):
    """(result, host synchronisations the call made)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) and
                    "prototype" not in str(w.message) for w in seen)


@contextlib.contextmanager
def seams_wrapped(wrappers: dict):
    """Replace ``repro_torch.kernels.ops.<seam>`` by ``wrappers[seam](orig)``
    for the block; the program calls its seams through that module."""
    from repro_torch.kernels import ops as kops

    saved = {name: getattr(kops, name) for name in wrappers}
    try:
        for name, wrap in wrappers.items():
            setattr(kops, name, functools.wraps(saved[name])(wrap(saved[name])))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def ranged(seam: str):
    """A wrapper that opens ``bench.seam.<seam>`` around each call."""
    def wrap(orig):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(SEAM_RANGE + seam):
                return orig(*args, **kwargs)
        return inner
    return wrap


def metered(meters: list, sink: list):
    """A wrapper that gives each call's arguments to every meter of the seam
    and keeps what they return."""
    def wrap(orig):
        def inner(*args, **kwargs):
            for m in meters:
                sink.append(m(*args, **kwargs))
            return orig(*args, **kwargs)
        return inner
    return wrap


def _union_seconds(intervals: list) -> tuple[float, list]:
    """Length of the union of (start, end) us intervals, in seconds, and
    the idle gaps between the merged intervals as (start, end) us."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6, gaps


def busy_seconds(device_ops: list) -> float:
    return _union_seconds([(s, e) for _, s, e in device_ops])[0]


def _ancestors(ev):
    p = ev.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def reduce_profile(prof, trace: Trace) -> None:
    """Fill ``trace`` from a ``torch.profiler.profile`` of the traced calls."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name.startswith(SEAM_RANGE):
            seam = trace.seams.setdefault(ev.name[len(SEAM_RANGE):],
                                          {"launched": 0, "device_s": 0.0})
            seam["launched"] += 1
            seam["device_s"] += ev.time_range.elapsed_us() / 1e6
        elif not ev.name.startswith("bench."):
            # the harness's own ranges also have device-side spans: they
            # are not operations
            trace.device_ops.append((ev.name, ev.time_range.start,
                                     ev.time_range.end))
    for ev in cpu:
        if ev.name.startswith("aten::"):
            names = [a.name for a in _ancestors(ev)]
            inside = [n for n in names if n.startswith("aten::") or n == CALL_RANGE]
            if inside and inside[0] == CALL_RANGE:
                trace.host_ops += 1
    # each idle gap named by the innermost host operator running as it
    # opened: of the spans that cover its start, the one that began last
    _, gaps = _union_seconds([(s, e) for _, s, e in trace.device_ops])
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu)
    starts = [s for s, _, _ in spans]
    for gs, ge in gaps:
        i = bisect.bisect_right(starts, gs) - 1
        while i >= 0 and spans[i][1] < gs:
            i -= 1
        trace.gaps.append((spans[i][2] if i >= 0 else "host",
                           (ge - gs) / 1e6))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing, each list at most ``top`` long."""
    by_op: dict[str, float] = {}
    for name, s, e in trace.device_ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    by_gap: dict[str, float] = {}
    for name, secs in trace.gaps:
        by_gap[name] = by_gap.get(name, 0.0) + secs
    def ranked(d):
        # a kernel's name is its full C++ signature: its head names it
        return [[k[:NAME_CHARS], v]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}
