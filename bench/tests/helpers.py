"""Shared by the harness's CPU tests: the cells they run, each at the sizes
of its configuration's ``cpu`` block, through the same path a chip run
takes after its look for a card.

Besides the benchmark's own cells, the tests run those of
``bench/tests/example``: a root made as a later PR would make one, from
this checkout's ``BENCHMARK.json`` and ``bench/`` with the example's files
added and its ``entries.json`` appended, and nothing of ``bench/`` edited.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

from bench import harness

# the CPU sizes of a configuration without a ``cpu`` block: rows a worker
# for a run, and for the control (8 x 8192 record ids pass 2**15, which the
# join's control, its payloads at int16, cannot carry)
ROWS = 256
CONTROL_ROWS = 8192
SEED = 2**31 + 7
EXAMPLE = Path(__file__).resolve().parent / "example"


def cells() -> list[str]:
    return [w["name"] for w in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["workloads"]]


def example_cells() -> list[str]:
    return [w["name"] for w in harness.load_json(
        EXAMPLE / "entries.json")["workloads"]]


def all_cells() -> list[str]:
    return cells() + example_cells()


@functools.cache
def example_root() -> Path:
    """A checkout with the example's cells added through new files and
    entries alone; removed when the process ends."""
    root = Path(tempfile.mkdtemp(prefix="bench-example-"))
    atexit.register(shutil.rmtree, root, True)
    shutil.copytree(harness.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "example"))
    for src in sorted((EXAMPLE / "bench").rglob("*")):
        if not src.is_file() or "__pycache__" in src.parts:
            continue
        dst = root / src.relative_to(EXAMPLE)
        if dst.exists():
            raise FileExistsError(f"the example would edit {dst}")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for key, entries in harness.load_json(EXAMPLE / "entries.json").items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def root_of(workload: str) -> Path:
    return harness.ROOT if workload in cells() else example_root()


def find(workload: str) -> harness.Cell:
    return harness.find_cell(workload, root_of(workload))


def on_cpu(cell: harness.Cell) -> harness.Cell:
    """The cell at its CPU sizes: the configuration's ``cpu`` block over its
    own keys, else ROWS and CONTROL_ROWS."""
    config = {**cell.config, "rows_per_worker": ROWS,
              "control_rows": CONTROL_ROWS, **cell.config.get("cpu", {})}
    return dataclasses.replace(cell, config=config)


def run(workload: str, *, trace: bool = False, seed: int = SEED,
        seconds: float = 0.2):
    return harness.run_cell(on_cpu(find(workload)), seed=seed,
                            seconds=seconds, trace=trace,
                            device=torch.device("cpu"), t0=time.perf_counter())
