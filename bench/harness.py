"""One run of one cell: set-up, the measured window or the traced calls, the
comparison with the plain reference, and the result's line.

Everything a cell needs is found by name from ``BENCHMARK.json``, as a file
under the root that ``BENCHMARK.json`` was read from (``Cell.root``):

* its configuration: the ``file`` of its ``configs`` entry. A table over
  workers gives ``workers`` (1 when left out), ``rows_per_worker`` and
  ``tables``; a model gives its widths beside them. A ``cpu`` block is for
  the CPU tests alone (``bench/tests``): its keys replace the
  configuration's own there, and a run on the card never reads it;
* its traffic: ``bench/traffic/<traffic>.json`` (the operator, its
  arguments, the loop, the warm-up, the limits of the comparison);
* the operator's module ``bench/ops/<op>.py``, its plain reference
  ``bench/reference/<op>.py`` and the loop ``bench/loops/<loop>.py``;
* each metric's reader ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the number or None, and which sets ``CPU_SILENT = True`` where
  it reads only what a card gives. A reader that names a kernel seam
  (``SEAM``) has the harness open a profiler range around that seam in
  the traced calls, and may give a ``meter`` that sees the seam's
  arguments in one more call made after them;
* the faults its tests plant, ``bench/tests/faults/<op>.py``.

The operator's module gives ``prepare(ctx, tables, traffic, *, config,
seed)``, which builds the program's state from the tables (a model draws
its weights from ``seed`` there, with ``tables.weights``);
``call(ctx, state, traffic)``, which makes one call through the program's
entry and returns ``(out, report)``; ``summarize(out, counts)``, what of a
result the comparison keeps; and optionally ``counts(out)``, a call's
per-worker counts (else ``out.row_counts``). The reference gives
``expected(tables, traffic, workers, *, config, seed, control=False)``,
worked out again from tables made anew from the seed, and ``compare(calls,
checked, want, limits)``, the compared numbers as (name, value, limit);
each summary in ``checked`` has the call's number in the run (from 0, the
warm-up calls first) under ``"call"``, for a program whose calls carry
state.

A later cell adds files and entries; none of this module needs an edit.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
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
    # the cell as run: a reader takes widths and sizes from its config
    cell: Cell | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_piece(root: Path, kind: str, name: str):
    """``<root>/bench/<kind>/<name>.py`` imported by its file, once a
    process, so any name can have one and a root made elsewhere (a test's)
    is read as the checkout's is."""
    path = (Path(root) / "bench" / kind / f"{name}.py").resolve()
    key = "bench_piece_" + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT

    @property
    def workers(self) -> int:
        return int(self.config.get("workers", 1))

    def piece(self, kind: str):
        """The cell's module of ``kind``: its loop (``loops``), else its
        operator's (``ops``, ``reference``, ``tests/faults``)."""
        name = self.traffic.get("loop", "closed") if kind == "loops" \
            else self.traffic["op"]
        return load_piece(self.root, kind, name)


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
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)


def readers(metrics: list, root: Path = ROOT) -> dict:
    return {m["name"]: load_piece(root, "metrics", m["name"]) for m in metrics}


def counts(op, out) -> list[int]:
    """A call's per-worker counts: the operator's ``counts(out)`` where it
    has one, else the result's ``row_counts``."""
    own = getattr(op, "counts", None)
    return own(out) if own is not None else out.row_counts.tolist()


def summary(op, out, call_counts: list[int], call: int) -> dict:
    """What the comparison keeps of call ``call``'s result."""
    return {**op.summarize(out, call_counts), "call": call}


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
        self.last = None  # (the call's number in the run, its result)
        self.made = 0
        self.sample: int | None = None
        self.checked: list = []

    def step(self, i: int, around=None) -> dict:
        """Call i; ``around`` wraps the program's call alone."""
        self.last = None  # each result released before the next call
        n, self.made = self.made, self.made + 1
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
        rec["counts"] = counts(self.op, out)
        rec["elided"] = all(r.get("elided", False) for r in report)
        rec["report"] = report
        if i == self.sample:
            # the comparison's work, which the loop leaves out of the window
            t = time.perf_counter()
            self.checked.append(summary(self.op, out, rec["counts"], n))
            rec["check_s"] = time.perf_counter() - t
        self.last = n, out
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
             device: torch.device, t0: float) -> tuple[dict, list]:
    """One run. Returns the result's line (without the device's name) and
    the compared numbers as (name, value, limit)."""
    from repro_torch.core.context import DistContext

    traffic, config = cell.traffic, cell.config
    op, ref, loop = (cell.piece(k) for k in ("ops", "reference", "loops"))
    metrics = cell.per_layer if trace else cell.end_to_end
    cell_readers = readers(metrics, cell.root)
    cuda = device.type == "cuda"

    ctx = DistContext(num_shards=cell.workers, device=device)
    tables = make_tables(config, traffic, seed, device)
    rows = input_rows(tables)
    caller = _Caller(op, ctx, op.prepare(ctx, tables, traffic, config=config,
                                         seed=seed), traffic, rows, device)
    del tables, ctx  # the program's state holds what it needs
    for i in range(int(traffic.get("warmup_calls", 2))):
        t = time.perf_counter()
        caller.step(-1 - i)
        warm_s = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell=cell)
    if trace:
        _traced(caller, run, cell_readers, t0)
    else:
        _window(caller, run, loop, seconds, seed, warm_s, t0)
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked = caller.checked
    if caller.last is not None:
        n, out = caller.last
        checked.append(summary(op, out, run.calls[-1]["counts"], n))
        del out

    # the program's state is freed before the reference runs, so the
    # reference neither sets the peak nor finds its memory taken
    del caller
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tables = make_tables(config, traffic, seed, device)
    want = ref.expected(tables, traffic, cell.workers, config=config,
                        seed=seed)
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
