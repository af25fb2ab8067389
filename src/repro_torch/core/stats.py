"""Sizing constants of the no-statistics path (the port of the constants in
``repro.core.stats``). The cardinality sketch and ``analyze`` come later.
"""
from __future__ import annotations

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
