"""What the drivers share: the inputs as the program's sharded tables, and
the summary of an exact result."""
from __future__ import annotations

import torch


def dist_table(columns: dict[str, torch.Tensor]):
    """The program's sharded table over the benchmark's (workers, rows)
    columns, every row valid (no copy)."""
    from repro_torch.core.context import DistTable

    first = next(iter(columns.values()))
    p, r = first.shape
    return DistTable(dict(columns),
                     torch.full((p,), r, dtype=torch.int32, device=first.device))


def exact_summary(out, counts: list[int]) -> dict:
    """Per-worker row counts and row digests of a result."""
    from bench.reference.digest import result_digests

    return {"counts": list(counts),
            "digests": result_digests(out.columns, counts)}
