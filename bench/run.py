"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. It refuses
to run without them (no CPU fallback), makes its tables on the card from
the seed, warms up, measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or traces a few steady calls (``--trace 1``: its
per-layer metrics), compares the results with the plain reference, prints
the compared numbers beside their limits as the last lines of standard
error, and prints one JSON line as the last line of standard output.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``bench``) and its ``src`` (the program), in place
# of this file's folder, whose module names could shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache of the run at a fixed place in the checkout
# (the kernels' own build goes to build/repro_torch_kernels/ by their code)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from bench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    line = f"device: {kind} x {torch.cuda.device_count()} (cell uses {cell.chips})"
    print(line)
    print(line, file=sys.stderr)
    result, compared = harness.run_cell(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t0=T0)
    found = harness.banned_modules()
    if found:
        print(f"refused: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": kind, **result["device"]}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    for name, v, lim in compared:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
