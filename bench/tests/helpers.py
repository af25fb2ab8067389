"""Shared by the harness's CPU tests: one run of a cell on the CPU at a
few hundred rows a worker, through the same path a chip run takes after
its look for a card."""
from __future__ import annotations

import time

import torch

from bench import harness

ROWS = 256
SEED = 2**31 + 7


def run(workload: str, *, trace: bool = False, seed: int = SEED,
        seconds: float = 0.2):
    cell = harness.find_cell(workload)
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                            device=torch.device("cpu"),
                            t0=time.perf_counter(), rows_per_worker=ROWS)


def cells() -> list[str]:
    return [w["name"] for w in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["workloads"]]
