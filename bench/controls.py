"""Readings that the comparison's limits are set from, at a cell's own size:

    python3 bench/controls.py --workload <cell> --seeds <n> [<n> ...] [--control-seeds <k>]

For each seed, in one process: the tables made from the seed, the
program's call made once through the cell's own entry (after one warm-up
call) and judged as a run judges its results; then, for the first
``--control-seeds`` seeds, the control judged the same way: the plain
reference put in the program's place with every value column carried at
the type below the one the configuration states (``reference.common.LOWER``:
float32 for float64, int32 for int64, int16 for int32) and its float
arithmetic run there.
One line a seed and side, with every compared number. The benchmark's runs
never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

def control_numbers(cell, tables: dict, want: dict, seed: int) -> list:
    """The control's compared numbers: the reference at the lower types
    judged against the reference."""
    ref = cell.piece("reference")
    got = ref.expected(tables, cell.traffic, cell.workers, config=cell.config,
                       seed=seed, control=True)
    return ref.compare([got["counts"]], [got], want,
                       cell.traffic.get("limits", {}))


def program_numbers(cell, ctx, tables: dict, want: dict, seed: int) -> list:
    """One warm call of the program on ``tables`` (its second), judged
    against ``want``."""
    from bench import harness

    op = cell.piece("ops")
    state = op.prepare(ctx, tables, cell.traffic, config=cell.config, seed=seed)
    for call in range(2):
        out, _ = op.call(ctx, state, cell.traffic)
        harness.sync(ctx.device)
    counts = harness.counts(op, out)
    got = harness.summary(op, out, counts, call)
    del out, state
    return cell.piece("reference").compare([counts], [got], want,
                                           cell.traffic.get("limits", {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from bench import harness
    from bench.tables import make_tables
    from repro_torch.core.context import DistContext

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    ref = cell.piece("reference")
    dev = torch.device("cuda", 0)
    ctx = DistContext(num_shards=cell.workers, device=dev)
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        tables = make_tables(cell.config, cell.traffic, seed, dev)
        want = ref.expected(tables, cell.traffic, cell.workers,
                            config=cell.config, seed=seed)
        sides = [("program", program_numbers(cell, ctx, tables, want, seed))]
        if i < args.control_seeds:
            sides.append(("control", control_numbers(cell, tables, want, seed)))
        del tables, want
        gc.collect()
        torch.cuda.empty_cache()
        for side, nums in sides:
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "seconds": round(time.perf_counter() - t, 2),
                              "compared": {n: v for n, v, _ in nums}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
