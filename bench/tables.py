"""The benchmark's table generator: every input made on the device from the
run's seed, in a few large calls.

A configuration file (``bench/configs/<config>.json``) names its tables and
their columns; each table is ``workers x rows_per_worker`` rows (``workers``
1 when left out), one ``(workers, rows_per_worker)`` tensor a column, drawn
by a ``torch.Generator`` on the device seeded from (run seed, table index,
column index). The same seed gives the same tables on the same card, so the
reference makes them again after the window instead of holding a copy. A
model's weights come from the same seed on a stream of their own
(``weights``), so its reference draws them again as well.

Distributions, over a table of N rows:

* ``uniform_int``: ``low + randint(levels)``, where ``levels`` is given or
  is ``levels_per_row x N`` (a cardinality that follows the scale);
* ``permutation``: ``low .. low + N - 1`` in a random order (unique keys);
* ``row_index``: ``low .. low + N - 1`` in row order (a record id);
* ``uniform_real``: uniform over ``[0, high)``, rounded to ``decimals``.
"""
from __future__ import annotations

import torch

DTYPES = {"int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32, "float64": torch.float64}
# the table index of the weights' stream: tables count from 0
WEIGHTS_STREAM = -1


def _generator(device: torch.device, seed: int, table: int, column: int
               ) -> torch.Generator:
    g = torch.Generator(device=device)
    # any whole number up to 2**63 seeds a generator; the run seed may be
    # wider than 32 bits
    g.manual_seed((int(seed) * 1_000_003 + table * 1009 + column) % (1 << 63))
    return g


def _column(spec: dict, shape: tuple[int, int], g: torch.Generator,
            device: torch.device) -> torch.Tensor:
    dist = spec["distribution"]
    dtype = DTYPES[spec["dtype"]]
    n = shape[0] * shape[1]
    low = int(spec.get("low", 0))
    if dist == "uniform_int":
        levels = int(spec["levels"]) if "levels" in spec else \
            round(spec["levels_per_row"] * n)
        return torch.randint(low, low + levels, shape, generator=g,
                             device=device, dtype=dtype)
    if dist == "permutation":
        perm = torch.randperm(n, generator=g, device=device)
        return (perm + low).to(dtype).reshape(shape)
    if dist == "row_index":
        return torch.arange(low, low + n, device=device, dtype=dtype
                            ).reshape(shape)
    if dist == "uniform_real":
        x = torch.rand(shape, generator=g, device=device, dtype=dtype)
        scale = 10.0 ** int(spec["decimals"])
        return torch.round(x * float(spec["high"]) * scale) / scale
    raise ValueError(f"unknown distribution {dist!r}")


def make_tables(config: dict, traffic: dict, seed: int,
                device: torch.device, rows_per_worker: int | None = None
                ) -> dict[str, dict[str, torch.Tensor]]:
    """``{table: {column: (workers, rows) tensor}}`` for the tables the
    traffic reads. ``rows_per_worker`` overrides the configuration's scale
    (``tools/trace_cells.py --rows``)."""
    p = int(config.get("workers", 1))
    out = {}
    for t, (name, columns) in enumerate(config.get("tables", {}).items()):
        r = int(rows_per_worker or config["rows_per_worker"])
        if name not in traffic["inputs"]:
            continue
        out[name] = {col: _column(spec, (p, r), _generator(device, seed, t, c),
                                  device)
                     for c, (col, spec) in enumerate(sorted(columns.items()))}
    return out


def weights(seed: int, shapes: dict[str, tuple[int, ...]],
            device: torch.device, dtype: torch.dtype = torch.float32
            ) -> dict[str, torch.Tensor]:
    """A model's weights, standard normal, drawn on the device from the run's
    seed: one generator, one call a tensor, in the order of ``shapes``."""
    g = _generator(device, seed, WEIGHTS_STREAM, 0)
    return {name: torch.randn(shape, generator=g, device=device, dtype=dtype)
            for name, shape in shapes.items()}


def input_rows(tables: dict[str, dict[str, torch.Tensor]]) -> int:
    """Rows over every input table (both sides of a join)."""
    return sum(next(iter(cols.values())).numel() for cols in tables.values())
