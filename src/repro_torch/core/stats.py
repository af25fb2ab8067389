"""Cardinality statistics and the sizing math of the cost model (the port
of ``repro.core.stats``).

* :class:`TableStats`: row count plus, for each 1-D key-typed column, a
  min/max and an NDV (number of distinct values) estimate from one sweep
  (:func:`sketch_columns`): each column's murmur3 hash (seed 5) marks one
  of :data:`SKETCH_BUCKETS` bitmap slots, and linear counting turns the
  occupancy into ``ndv = -m * ln(1 - occupied/m)``. ``DistContext.analyze``
  caches them on a ``DistTable``; the estimators in ``core/plan.py``
  propagate them through plan nodes.
* Sizing math: AllToAll send buckets are static per-(source, dest) slot
  budgets. With statistics the cost model sizes them from the estimated
  occupancy (:func:`with_skew_margin`: the Poisson mean plus four standard
  deviations plus four), and an overflow of such a bucket re-runs the plan
  once at safe capacities (``DistContext._run_plan``).
* ``FALLBACK_SLACK``: without statistics every bucket is
  ``capacity * FALLBACK_SLACK / num_shards``; the sort multiplies it by
  :data:`SORT_SLACK_FACTOR`, the join's output budget by
  :data:`JOIN_OUT_FACTOR`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from repro_torch.core import faults as FLT

# ---------------------------------------------------------------------------
# slack constants (the no-stats path)
# ---------------------------------------------------------------------------

#: The single fallback slack for every capacity derived without statistics:
#: bucket = ceil(capacity * FALLBACK_SLACK / num_shards).
FALLBACK_SLACK = 2.0

#: Sort range-partitions by sampled splitters, whose quantile error piles
#: rows up beyond hash uniformity: the no-stats sort bucket uses
#: FALLBACK_SLACK * SORT_SLACK_FACTOR.
SORT_SLACK_FACTOR = 2.0

#: No-stats join output budget: JOIN_OUT_FACTOR * p * bucket (both shuffled
#: operands land in one output table).
JOIN_OUT_FACTOR = 2.0

#: Selectivity assumed for a Select, whose predicate the planner cannot
#: evaluate statically: the System R default.
DEFAULT_SELECTIVITY = 0.5

#: Multiplier on the estimated mean occupancy of stats-sized sort and
#: window buckets (sampled-splitter error).
RANGE_SIZING_FACTOR = 2.0

#: Multiplier on the estimated per-shard join match count (key
#: multiplicity concentrates matches beyond the Poisson model).
JOIN_OUT_SIZING_FACTOR = 1.5

#: Linear-counting bitmap width of the NDV sketch. Error ~ sqrt(m) *
#: exp(ndv/m) / ndv: under 3% up to ndv ~ m.
SKETCH_BUCKETS = 4096

#: The murmur3 seed of the sketch's hash.
SKETCH_SEED = 5

#: A shuffle below this wire-byte estimate runs as one collective (S=1).
STAGE_WIRE_THRESHOLD = 1 << 20

#: Staging ceiling.
MAX_SHUFFLE_STAGES = 4


def pick_stages(wire_bytes: float, bucket_capacity: int) -> int:
    """Pipeline depth for a shuffle moving ``wire_bytes``: 1 at or below
    :data:`STAGE_WIRE_THRESHOLD`, then doubling with the volume up to
    :data:`MAX_SHUFFLE_STAGES`, clamped to the bucket capacity. Every depth
    gives the same bits."""
    if bucket_capacity <= 1 or wire_bytes <= STAGE_WIRE_THRESHOLD:
        return 1
    s = 2
    while s < MAX_SHUFFLE_STAGES and wire_bytes >= (2 * s) * STAGE_WIRE_THRESHOLD:
        s *= 2
    return min(s, bucket_capacity)


# ---------------------------------------------------------------------------
# statistics containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column statistics: NDV estimate + value range (as floats)."""

    ndv: float
    lo: float | None = None
    hi: float | None = None


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Table-level statistics (hashable planner metadata).

    ``rows`` is exact on analyzed tables and an estimate after operator
    propagation. ``columns`` holds ColumnStats for the 1-D key-typed
    columns only. ``max_shard_rows`` is the exact per-shard max on analyzed
    tables (None once an operator has redistributed rows).
    """

    rows: float
    columns: tuple[tuple[str, ColumnStats], ...] = ()
    max_shard_rows: float | None = None

    def col(self, name: str) -> ColumnStats | None:
        for k, cs in self.columns:
            if k == name:
                return cs
        return None

    def ndv(self, keys: Sequence[str]) -> float | None:
        """Joint NDV of a key tuple: the product of the per-column NDVs
        capped by the row count (the independence upper bound). None when
        any key column has no statistics."""
        out = 1.0
        cap = max(self.rows, 1.0)
        for k in keys:
            cs = self.col(k)
            if cs is None:
                return None
            out *= max(cs.ndv, 1.0)
            if out >= cap:
                return cap
        return min(out, cap)

    def shard_rows(self, p: int) -> float:
        """Per-source-shard row estimate (the exact max when known)."""
        if self.max_shard_rows is not None:
            return self.max_shard_rows
        return self.rows / max(p, 1)


def cap_rows(stats: TableStats, rows: float,
             keep: Sequence[str] | None = None) -> TableStats:
    """Propagated stats: a new row count, per-column NDVs capped at it, and
    optionally only the ``keep`` columns."""
    rows = max(rows, 0.0)
    cols = []
    for k, cs in stats.columns:
        if keep is not None and k not in keep:
            continue
        cols.append((k, ColumnStats(min(cs.ndv, max(rows, 1.0)),
                                    cs.lo, cs.hi)))
    return TableStats(rows=rows, columns=tuple(cols), max_shard_rows=None)


# ---------------------------------------------------------------------------
# bucket sizing (the Poisson skew model)
# ---------------------------------------------------------------------------


def with_skew_margin(mean: float) -> int:
    """Slot budget for an expected occupancy of ``mean`` rows: the mean
    plus ~4 Poisson standard deviations plus a small-count floor. Every
    consumer is backed by the overflow re-run.

    The ``stats.estimate`` fault site lives here: an armed fault derates
    the budget (divides by ``FaultPlan.factor``), modelling a badly wrong
    cardinality estimate, the chaos probe of the overflow re-run."""
    mean = max(mean, 0.0)
    budget = max(1, math.ceil(mean + 4.0 * math.sqrt(mean) + 4.0))
    fp = FLT.check("stats.estimate")
    if fp is not None:
        budget = max(1, int(budget // max(fp.factor, 1.0)))
    return budget


def size_bucket(source_rows: float, p: int, factor: float = 1.0) -> int:
    """Per-(source, dest) send-slot budget for ``source_rows`` rows a source
    shard hashed over ``p`` destinations; ``factor`` widens the mean for
    skew-prone placements (range partitions)."""
    return with_skew_margin(factor * max(source_rows, 0.0) / max(p, 1))


def size_output(rows: float, p: int, factor: float = 1.0) -> int:
    """Per-shard output budget for ``rows`` estimated global result rows
    hash-spread over ``p`` shards."""
    return with_skew_margin(factor * max(rows, 0.0) / max(p, 1))


# ---------------------------------------------------------------------------
# the analysis sweep
# ---------------------------------------------------------------------------


def _identities(dtype: torch.dtype) -> tuple[float, float]:
    """(min, max) identities of a key dtype, as the reference takes them:
    +-inf for floats, the dtype's max and min for integers."""
    if dtype.is_floating_point:
        return math.inf, -math.inf
    info = torch.iinfo(dtype)
    return info.max, info.min


def _sketch_one(col: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(occupied-bitmap-count, min, max) of one 1-D key column over the
    ``valid`` rows, as a (3,) float64 tensor on the column's device (exact:
    every int32, uint32 and float32 value is a float64). The bitmap slots
    are ``hash32(col, seed=5) % SKETCH_BUCKETS``: one launch of the fused
    hash-partition entry over every row, the invalid rows then sent to a
    dump slot."""
    from repro_torch.kernels import ops as kops

    n = col.shape[0]
    dev = col.device
    lo_id, hi_id = _identities(col.dtype)
    if n == 0:
        return torch.tensor([0.0, lo_id, hi_id], dtype=torch.float64,
                            device=dev)
    every_row = torch.tensor(n, dtype=torch.int32, device=dev)
    slot = kops.hash_partition_ids([col], every_row, SKETCH_BUCKETS,
                                   seed=SKETCH_SEED)
    slot = torch.where(valid, slot, SKETCH_BUCKETS)
    hist = torch.bincount(slot, minlength=SKETCH_BUCKETS + 1)
    filled = (hist[:SKETCH_BUCKETS] > 0).sum()
    # torch has no uint32 min/max; the int64 holder keeps the order
    vals = col.to(torch.int64) if col.dtype == torch.uint32 else col
    lo = torch.where(valid, vals, lo_id).amin()
    hi = torch.where(valid, vals, hi_id).amax()
    if col.dtype.is_floating_point:
        # the reference's min/max order -0.0 below +0.0; torch's return
        # whichever zero comes first
        zero = valid & (col == 0)
        neg = torch.signbit(col)
        lo = torch.where(lo == 0, torch.where((zero & neg).any(), -0.0, 0.0),
                         lo)
        hi = torch.where(hi == 0, torch.where((zero & ~neg).any(), 0.0, -0.0),
                         hi)
    return torch.stack([filled.to(torch.float64), lo.to(torch.float64),
                        hi.to(torch.float64)])


def sketch_columns(columns: Mapping[str, torch.Tensor], valid: torch.Tensor,
                   names: Sequence[str]) -> torch.Tensor:
    """The sketch of the ``names`` columns (1-D, one length) under
    ``valid``: a (len(names), 3) float64 tensor of (filled, lo, hi) rows,
    left on the device."""
    dev = valid.device
    if not names:
        return torch.zeros((0, 3), dtype=torch.float64, device=dev)
    return torch.stack([_sketch_one(columns[n], valid) for n in names])


def linear_count(filled: int, rows: float,
                 buckets: int = SKETCH_BUCKETS) -> float:
    """Linear-counting NDV from bitmap occupancy, clamped to [0, rows]."""
    if rows <= 0 or filled <= 0:
        return 0.0
    if filled >= buckets:  # saturated sketch: every value looks distinct
        return float(rows)
    ndv = -buckets * math.log1p(-filled / buckets)
    return float(min(max(ndv, 1.0), rows))


def finish_stats(names: Sequence[str], sketch: Sequence[Sequence[float]],
                 rows: int, max_shard_rows: float) -> TableStats:
    """TableStats from a sketch brought to the host (rows of (filled, lo,
    hi) in ``names`` order)."""
    cols = tuple((n, ColumnStats(linear_count(int(filled), rows),
                                 float(lo), float(hi)))
                 for n, (filled, lo, hi) in zip(names, sketch))
    return TableStats(rows=float(rows), columns=cols,
                      max_shard_rows=float(max_shard_rows))


def analyze_table(table) -> TableStats:
    """TableStats of a local :class:`~repro_torch.core.table.Table` (the
    sweep ``DistContext.analyze`` runs over a sharded one), with
    ``max_shard_rows`` the row count. One transfer to the host."""
    names = tuple(table.key_column_names)
    sk = sketch_columns(table.columns, table.valid_mask(), names)
    host = torch.cat([table.row_count.reshape(1).to(torch.float64),
                      sk.reshape(-1)]).cpu().tolist()
    rows = int(host[0])
    sketch = [host[1 + 3 * i: 4 + 3 * i] for i in range(len(names))]
    return finish_stats(names, sketch, rows, rows)
