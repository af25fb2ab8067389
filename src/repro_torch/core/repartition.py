"""The network operator: hash partition + AllToAll shuffle (the port of
``repro.core.repartition``).

Each shard packs its rows into ``num_partitions`` equal ``bucket_capacity``
send slots (grouped by a stable sort) and the slots are exchanged with one
AllToAll over the virtual mesh. Skew beyond ``bucket_capacity`` is counted
(``overflow``), not hidden.

The exchange may be staged (:func:`staged_all_to_all`): the send buckets
split into S chunks along the capacity axis, one collective per chunk, each
chunk landing where the monolithic exchange puts it, so every staging, and
the ``ppermute`` ring (``shuffle_mode="ring"``), gives the same bits. The
per-bucket send counts ride inside the first 4-byte column, bitcast into a
prepended capacity slot (the counts carrier), so no separate counts
collective is needed. The counts move only by ``view``, ``cat`` and
indexing, never through float arithmetic, so a float32 carrier keeps their
(denormal) bit patterns.

Functions here take the shards as a list of per-shard Tables of equal
capacity and run the per-shard steps in a loop, with the collectives over
all shards at once (see ``core/mesh.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import faults as FLT
from repro_torch.core import trace
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.ops_local import compact
from repro_torch.core.table import Table
from repro_torch.kernels import ops as kops
from repro_torch.utils import ceil_div


class ShuffleStats(NamedTuple):
    overflow: torch.Tensor  # (p,) int32: rows each shard's sends dropped
    received: torch.Tensor  # (p,) int32: valid rows each shard received


class Partitioning(NamedTuple):
    """Static placement metadata: rows live on shard ``hash(keys) % n``."""

    keys: tuple[str, ...]   # key columns, in the order they were hashed
    num_partitions: int     # the modulus (== mesh axis size when created)
    seed: int               # murmur3 seed of the partitioning hash


@dataclasses.dataclass(frozen=True)
class RangePartitioning:
    """Static placement metadata for range-partitioned tables (sort output):
    shard i's key tuples are all <= shard i+1's, equal tuples colocated.
    ``fingerprint`` is splitter provenance. A dataclass, not a NamedTuple,
    so it never compares equal to a hash :class:`Partitioning`."""

    keys: tuple[str, ...]
    num_partitions: int
    fingerprint: object


_FINGERPRINTS = itertools.count()


def fresh_range_fingerprint() -> tuple:
    """Unique provenance token for a materialized range-partitioned table."""
    return ("table", next(_FINGERPRINTS))


def range_prefix_matches(part, keys: tuple[str, ...]) -> bool:
    """True when ``part`` is a RangePartitioning whose key columns are a
    prefix of ``keys``."""
    return (isinstance(part, RangePartitioning)
            and len(part.keys) <= len(keys)
            and part.keys == tuple(keys[:len(part.keys)]))


def zero_shuffle_stats(num_shards: int, device) -> ShuffleStats:
    """Stats for an elided shuffle: nothing sent, nothing dropped."""
    z = torch.zeros(num_shards, dtype=torch.int32, device=device)
    return ShuffleStats(overflow=z, received=z.clone())


def pack_by_partition(part_id: torch.Tensor, num_partitions: int,
                      bucket_capacity: int):
    """Group one shard's rows into equal-capacity per-partition send slots.

    part_id: (n,) int32 destination in [0, num_partitions); -1 = skip.
    Returns (send_idx (num_partitions, bucket_capacity) int64 with -1 for
    empty slots, hist (num_partitions,) int32 true per-partition counts).
    """
    (n,) = part_id.shape
    dev = part_id.device
    if n == 0:
        return (torch.full((num_partitions, bucket_capacity), -1,
                           dtype=torch.int64, device=dev),
                torch.zeros(num_partitions, dtype=torch.int32, device=dev))
    pid_sort = torch.where(part_id >= 0, part_id, num_partitions)
    order = torch.sort(pid_sort, stable=True).indices
    hist = kops.bucket_histogram(part_id, num_partitions)
    h = hist.to(torch.int64)
    off = torch.cumsum(h, 0) - h
    j = torch.arange(bucket_capacity, device=dev)[None, :]
    src = torch.clamp(off[:, None] + j, 0, n - 1)
    ok = j < h[:, None]
    return torch.where(ok, order[src], -1), hist


def _chunk_bounds(width: int, stages: int) -> list[tuple[int, int]]:
    """Split ``[0, width)`` into ~``stages`` contiguous chunks (remainder in
    the last; ``stages > width`` gives one slot per chunk; [] for 0)."""
    if width <= 0:
        return []
    step = ceil_div(width, max(1, min(int(stages), width)))
    return [(lo, min(lo + step, width)) for lo in range(0, width, step)]


def _ring_exchange(buf: torch.Tensor, mesh: VirtualMesh) -> torch.Tensor:
    """AllToAll via a ``ppermute`` ring: p-1 point-to-point steps.

    Step k: shard i sends its bucket for destination (i + k) % p along the
    permutation s -> (s + k) % p, and the receiver stores it at slot
    (i - k) % p: element for element what ``all_to_all`` gives (k = 0 is
    the local bucket, no collective)."""
    p = mesh.axis_size
    if p == 1:
        return buf
    idx = torch.arange(p, device=buf.device)
    out = torch.zeros_like(buf)
    for k in range(p):
        chunk = buf[idx, (idx + k) % p]
        if k:
            chunk = mesh.ppermute(chunk, [(s, (s + k) % p) for s in range(p)])
        out[idx, (idx - k + p) % p] = chunk
    return out


def staged_all_to_all(buf: torch.Tensor, mesh: VirtualMesh, *, stages: int = 1,
                      shuffle_mode: str = "alltoall") -> torch.Tensor:
    """Exchange every shard's ``(p, width, *rest)`` send buckets, stacked as
    ``(p_src, p_dst, width, *rest)``, optionally in ``stages`` chunks along
    the width; the result ``(p_dst, p_src, width, *rest)`` is the same for
    every staging and for ``shuffle_mode="ring"``."""
    if shuffle_mode == "ring":
        return _ring_exchange(buf, mesh)
    if shuffle_mode != "alltoall":
        raise ValueError(f"unknown shuffle_mode: {shuffle_mode!r}")
    bounds = _chunk_bounds(buf.shape[2], stages)
    if len(bounds) <= 1:
        return mesh.all_to_all(buf)
    return torch.cat([mesh.all_to_all(buf[:, :, lo:hi]) for lo, hi in bounds],
                     dim=2)


def _poison_chunk(recv: torch.Tensor, width: int) -> torch.Tensor:
    """Overwrite the first ``width`` received capacity slots of every
    (destination, source) bucket with the NaN bit pattern: the
    ``shuffle.chunk`` garble/drop fault. Floats become NaN (caught by the
    finalize NaN scan); a 4-byte carrier's bitcast counts decode to an
    absurd row count (caught by the received-rows invariant). Writes in
    place: ``recv`` is the exchange's fresh output."""
    if recv.dtype.is_floating_point:
        bad = float("nan")
    elif recv.element_size() == 4:
        # the float32 quiet-NaN bit pattern, so bitcast counts explode
        bad = 0x7FC00000
    else:
        bad = torch.iinfo(recv.dtype).max
    recv[:, :, :width] = bad
    return recv


def _shuffle_fault(bucket_capacity: int, stages: int,
                   shuffle_mode: str) -> FLT.FaultPlan | None:
    """Consult the ``shuffle.chunk`` site for one exchange (on a plan's
    first run only: ``faults.check_first_run``). Only a pipelined exchange
    (staged chunks or the ppermute ring) is eligible: the fault models
    pipelining bugs, so the monolithic-AllToAll rung provably avoids it.
    Raise mode raises here; garble mode returns the plan for
    :func:`repartition` to poison a received chunk with."""
    staged = (shuffle_mode == "ring"
              or len(_chunk_bounds(bucket_capacity, stages)) > 1)
    if not staged:
        return None
    fp = FLT.check_first_run("shuffle.chunk")
    if fp is not None and fp.effective_mode == "raise":
        raise FLT.FaultError("shuffle.chunk",
                             f"stages={stages} mode={shuffle_mode}")
    return fp


def _counts_carrier(table: Table) -> str | None:
    """The column that carries the per-bucket send counts: the first
    (sorted) 4-byte column; None when none qualifies."""
    for name in table.column_names:
        if table.columns[name].element_size() == 4:
            return name
    return None


def repartition(tables: Sequence[Table], part_ids: Sequence[torch.Tensor], *,
                mesh: VirtualMesh, bucket_capacity: int, stages: int = 1,
                shuffle_mode: str = "alltoall"
                ) -> tuple[list[Table], ShuffleStats]:
    """Send each valid row of every shard to the shard its ``part_id``
    names (int32, -1 = skip).

    Returns the received shards (capacity = p * bucket_capacity, valid rows
    front-compacted, in source-shard order) and the shuffle stats.
    """
    p = mesh.axis_size
    if len(tables) != p or len(part_ids) != p:
        raise ValueError(f"need {p} shards, got {len(tables)}")
    t0 = tables[0]
    dev = t0.device
    c = t0.capacity
    cb = bucket_capacity

    with trace.span("repro_torch.exchange.pack"):
        packs = [pack_by_partition(torch.where(t.valid_mask(), pid, -1), p, cb)
                 for t, pid in zip(tables, part_ids)]
        send_idx = torch.stack([s for s, _ in packs])  # (p_src, p_dst, cb)
        hist = torch.stack([h for _, h in packs])      # (p_src, p_dst)
        sent = torch.clamp(hist, max=cb).to(torch.int32)
    carrier = _counts_carrier(t0)
    fault = _shuffle_fault(cb, stages, shuffle_mode)
    # garble the carrier (or the only exchanged column when none): its
    # first received chunk, counts slot included
    garble_col = carrier if carrier is not None else t0.column_names[0]
    with trace.span("repro_torch.exchange.buffers"):
        shard = torch.arange(p, device=dev)[:, None, None]
        src_row = send_idx.clamp(0, max(c - 1, 0))
        sent_mask = send_idx >= 0

    # one column at a time: a column's send buffer is freed once exchanged
    recv_cols = {}
    recv_counts = None
    for name in t0.columns:
        with trace.span("repro_torch.exchange.buffers"):
            col = torch.stack([t.columns[name] for t in tables])  # (p, c, *rest)
            rest = tuple(col.shape[2:])
            if c == 0:
                buf = torch.zeros((p, p, cb) + rest, dtype=col.dtype,
                                  device=dev)
            else:
                buf = col[shard, src_row]  # (p, p, cb, *rest)
                sel = sent_mask.reshape(send_idx.shape + (1,) * len(rest))
                buf = torch.where(sel, buf, torch.zeros((), dtype=col.dtype,
                                                        device=dev))
            if name == carrier:
                cnt = sent.view(col.dtype)  # bitcast, never arithmetic
                if rest:
                    meta = torch.zeros((p, p, math.prod(rest)),
                                       dtype=col.dtype, device=dev)
                    meta[:, :, 0] = cnt
                    meta = meta.reshape((p, p, 1) + rest)
                else:
                    meta = cnt[:, :, None]
                buf = torch.cat([meta, buf], dim=2)  # (p, p, cb + 1, *rest)
        with trace.span("repro_torch.exchange.all_to_all"):
            recv = staged_all_to_all(buf, mesh, stages=stages,
                                     shuffle_mode=shuffle_mode)
            if fault is not None and name == garble_col:
                width = (_chunk_bounds(buf.shape[2], stages)[0][1]
                         if shuffle_mode != "ring" else buf.shape[2])
                recv = _poison_chunk(recv, width)
            if name == carrier:
                meta_r = recv[:, :, 0]
                if rest:
                    meta_r = meta_r.reshape(p, p, -1)[:, :, 0]
                recv_counts = meta_r.contiguous().view(torch.int32)  # (dst, src)
                recv = recv[:, :, 1:]
            recv_cols[name] = recv.reshape((p, p * cb) + rest)

    if recv_counts is None:  # no 4-byte column: separate counts collective
        with trace.span("repro_torch.exchange.all_to_all"):
            recv_counts = staged_all_to_all(
                sent.reshape(p, p, 1), mesh,
                shuffle_mode=shuffle_mode).reshape(p, p)

    with trace.span("repro_torch.exchange.compact"):
        slot = torch.arange(cb, device=dev)[None, None, :]
        recv_valid = (slot < recv_counts[:, :, None]).reshape(p, p * cb)
        full = torch.tensor(p * cb, dtype=torch.int32, device=dev)
        outs = [compact(Table({k: v[i] for k, v in recv_cols.items()}, full),
                        recv_valid[i]) for i in range(p)]
        stats = ShuffleStats(
            overflow=torch.clamp(hist - cb, min=0).sum(1).to(torch.int32),
            received=recv_counts.sum(1).to(torch.int32),
        )
    trace.count("exchange.rows_received", stats.received)
    trace.count("exchange.slots", p * p * cb)
    return outs, stats


def default_bucket_capacity(capacity: int, num_shards: int,
                            slack: float | None = None) -> int:
    """Per-destination slot budget: even split x slack for skew
    (``slack=None`` uses :data:`repro_torch.core.stats.FALLBACK_SLACK`)."""
    from repro_torch.core.stats import FALLBACK_SLACK

    if slack is None:
        slack = FALLBACK_SLACK
    return max(1, ceil_div(int(capacity * slack), num_shards))
