"""One run of one cell: set-up, the measured window or the traced calls, the
comparison with the plain reference, and the result's line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* its configuration: the ``file`` of its ``configs`` entry (tables,
  columns, workers, rows a worker);
* its traffic: ``bench/traffic/<traffic>.json`` (the operator, its
  arguments, the loop, the warm-up, the limits of the comparison);
* the operator's driver ``bench/ops/<op>.py`` and its plain reference
  ``bench/reference/<op>.py``; the loop ``bench/loops/<loop>.py``;
* each metric's reader ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the number or None. A reader that names a kernel seam (``SEAM``)
  has the harness open a profiler range around that seam in the traced
  calls, and may give a ``meter`` that sees the seam's arguments in one
  more call made after them.

A later cell adds files and entries; none of this module needs an edit.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from bench import profiling
from bench.tables import input_rows, make_tables

ROOT = Path(__file__).resolve().parents[1]
# top-level module names a run must never have loaded: JAX and the JAX
# package the port was made from
BANNED = ("jax", "jaxlib", "flax", "repro")
# a traced run: calls under the sync counter, under the profiler, metered
SYNC_CALLS, TRACE_CALLS, METER_CALLS = 2, 3, 1


@dataclasses.dataclass
class Run:
    """What a run measured; the readers take their numbers from it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    # one record a call in the window: seconds, rows, counts, ok
    calls: list = dataclasses.field(default_factory=list)
    trace: profiling.Trace | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """Import a reader by its file, so any metric name can have one."""
    spec = importlib.util.spec_from_file_location(f"bench_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def workers(self) -> int:
        return int(self.config["workers"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(root / "bench" / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def readers(metrics: list, root: Path = ROOT) -> dict:
    return {m["name"]: load_file(root / "bench" / "metrics" / f"{m['name']}.py",
                                 m["name"]) for m in metrics}


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is banned: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seam_wrappers(cell_readers: dict, meters_on: bool, sink: dict) -> dict:
    seams: dict[str, list] = {}
    for mod in cell_readers.values():
        seam = getattr(mod, "SEAM", None)
        if seam is not None:
            seams.setdefault(seam, [])
            if getattr(mod, "meter", None) is not None:
                seams[seam].append(mod.meter)
    if not meters_on:
        return {s: profiling.ranged(s) for s in seams}
    return {s: profiling.metered(ms, sink.setdefault(s, []))
            for s, ms in seams.items() if ms}


def _resolve(record):
    """A meter's record with its 0-d device tensors read on the host."""
    if isinstance(record, dict):
        return {k: _resolve(v) for k, v in record.items()}
    if isinstance(record, torch.Tensor):
        return record.item()
    return record


class _Caller:
    """Makes the cell's calls one at a time and keeps what the comparison
    needs: each call's record, the result of the call drawn from the seed,
    and the last result until the window has closed."""

    def __init__(self, op, ctx, state, traffic: dict, rows: int,
                 device: torch.device):
        self.op, self.ctx, self.state, self.traffic = op, ctx, state, traffic
        self.rows, self.device = rows, device
        self.last = None
        self.sample: int | None = None
        self.checked: list = []

    def step(self, i: int, around=None) -> dict:
        """Call i; ``around`` wraps the program's call alone."""
        self.last = None  # each result released before the next call
        rec = {"rows": self.rows, "ok": True, "elided": True}

        def thunk():
            return self.op.call(self.ctx, self.state, self.traffic)
        try:
            out, report = around(thunk) if around else thunk()
            sync(self.device)
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            print(f"call {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            rec["ok"] = False
            return rec
        rec["counts"] = out.row_counts.tolist()
        rec["elided"] = all(r.get("elided", False) for r in report)
        rec["report"] = report
        if i == self.sample:
            # the comparison's work, which the loop leaves out of the window
            t = time.perf_counter()
            self.checked.append(self.op.summarize(out, rec["counts"]))
            rec["check_s"] = time.perf_counter() - t
        self.last = out
        return rec


def _window(caller: _Caller, run: Run, loop, seconds: float, seed: int,
            warm_s: float, t0: float) -> None:
    # the call whose whole result is compared besides the last one, drawn
    # from the seed among the calls the window should hold
    caller.sample = random.Random(seed).randrange(
        max(1, int(0.8 * seconds / max(warm_s, 1e-3))))
    run.setup_s = time.perf_counter() - t0
    run.window_s, run.calls = loop.window(caller.step, seconds, caller.traffic)


def _traced(caller: _Caller, run: Run, cell_readers: dict, t0: float) -> None:
    """The sync counter over SYNC_CALLS calls, the profiler over
    TRACE_CALLS with ranges around the call and the readers' seams, and
    the seams' meters over METER_CALLS more."""
    run.setup_s = time.perf_counter() - t0
    run.trace = tr = profiling.Trace()
    cuda = caller.device.type == "cuda"

    def counted(thunk):
        res, n = profiling.count_syncs(thunk)
        tr.syncs = (tr.syncs or 0) + n
        tr.sync_calls += 1
        return res

    def ranged(thunk):
        with torch.profiler.record_function(profiling.CALL_RANGE):
            return thunk()

    for i in range(SYNC_CALLS):
        run.calls.append(caller.step(i, counted if cuda else None))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with profiling.seams_wrapped(_seam_wrappers(cell_readers, False, {})):
        sync(caller.device)
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            for i in range(TRACE_CALLS):
                rec = caller.step(SYNC_CALLS + i, ranged)
                run.calls.append(rec)
                tr.reports.append(rec.get("report", []))
            tr.window_s = time.perf_counter() - t
    tr.calls = TRACE_CALLS
    profiling.reduce_profile(prof, tr)
    sink: dict = {}
    wrappers = _seam_wrappers(cell_readers, True, sink)
    if wrappers:
        with profiling.seams_wrapped(wrappers):
            for i in range(METER_CALLS):
                run.calls.append(caller.step(SYNC_CALLS + TRACE_CALLS + i))
        tr.metered = {s: [_resolve(r) for r in recs] for s, recs in sink.items()}
        tr.metered_calls = METER_CALLS


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             rows_per_worker: int | None = None) -> tuple[dict, list]:
    """One run. Returns the result's line (without the device's name) and
    the compared numbers as (name, value, limit)."""
    from repro_torch.core.context import DistContext

    traffic = cell.traffic
    op = importlib.import_module(f"bench.ops.{traffic['op']}")
    ref = importlib.import_module(f"bench.reference.{traffic['op']}")
    loop = importlib.import_module(f"bench.loops.{traffic.get('loop', 'closed')}")
    metrics = cell.per_layer if trace else cell.end_to_end
    cell_readers = readers(metrics)
    cuda = device.type == "cuda"

    ctx = DistContext(num_shards=cell.workers, device=device)
    tables = make_tables(cell.config, traffic, seed, device, rows_per_worker)
    rows = input_rows(tables)
    caller = _Caller(op, ctx, op.prepare(ctx, tables, traffic), traffic, rows,
                     device)
    del tables, ctx  # the program's state holds what it needs
    for i in range(int(traffic.get("warmup_calls", 2))):
        t = time.perf_counter()
        caller.step(-1 - i)
        warm_s = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = Run()
    if trace:
        _traced(caller, run, cell_readers, t0)
    else:
        _window(caller, run, loop, seconds, seed, warm_s, t0)
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked = caller.checked
    if caller.last is not None:
        checked.append(op.summarize(caller.last, run.calls[-1]["counts"]))

    # the program's state is freed before the reference runs, so the
    # reference neither sets the peak nor finds its memory taken
    del caller
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tables = make_tables(cell.config, traffic, seed, device, rows_per_worker)
    want = ref.expected(tables, traffic, cell.workers)
    del tables
    compared = [("failed_calls", float(sum(not c["ok"] for c in run.calls)), 0.0)]
    if traffic.get("require_elided"):
        compared.append(("calls_with_a_shuffle",
                         float(sum(not c["elided"] for c in run.calls)), 0.0))
    ok_calls = [c["counts"] for c in run.calls if c["ok"]]
    compared += ref.compare(ok_calls, checked, want, traffic.get("limits", {}))
    if not checked:
        compared.append(("no_result_compared", 1.0, 0.0))

    values = {}
    for m in metrics:
        v = cell_readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"breakdown": profiling.breakdown(run.trace)} if trace else {}
    result.update({
        "correct": all(v <= lim for _, v, lim in compared),
        "attempted": len(run.calls),
        "failed": sum(not c["ok"] for c in run.calls),
        "metrics": values,
        "device": {"count": cell.chips,
                   "memory_peak_bytes": max(setup_peak, run.peak_bytes)},
    })
    if trace:
        result["device"]["busy_s"] = profiling.busy_seconds(run.trace.device_ops)
        result["device"]["window_s"] = run.trace.window_s
    return result, compared
