"""What the exact references share: their inputs flattened and, for the
control, carried at the width below the configuration's; the comparison of
per-worker counts and digests."""
from __future__ import annotations

import torch

# rows of the left input a block of the join's expansion takes at a time
BLOCK_ROWS = 1 << 22

# the control's type for each type a configuration states: the nearest
# below it
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16,
         torch.int64: torch.int32, torch.int32: torch.int16}


def flat(table: dict[str, torch.Tensor], control: bool = False,
         keys: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """Every column as one (workers * rows,) tensor, the workers' rows in
    order. The control carries every column but the ``keys`` through the
    type below its own and back."""
    out = {}
    for name, col in table.items():
        v = col.reshape(-1)
        if control and name not in keys:
            v = v.to(LOWER[v.dtype]).to(v.dtype)
        out[name] = v
    return out


def compare_exact(calls: list[list[int]], checked: list[dict], want: dict,
                  limits: dict | None = None) -> list[tuple[str, float, float]]:
    """The numbers an exact result is judged by, each with its limit 0:
    calls whose per-worker row counts differ from the reference's, and
    workers whose row digest differs, over every checked result."""
    bad_calls = sum(c != want["counts"] for c in calls)
    bad_shards = sum(g != w for got in checked
                     for g, w in zip(got["digests"], want["digests"]))
    bad_shards += sum(got["counts"] != want["counts"] for got in checked)
    return [("calls_with_wrong_counts", float(bad_calls), 0.0),
            ("workers_with_wrong_rows", float(bad_shards), 0.0)]
