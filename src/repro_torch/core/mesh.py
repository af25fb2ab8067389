"""VirtualMesh: p shards in one process, in place of ``shard_map`` and the
``jax.lax`` collectives the reference's operators use.

Per-shard values are stacked on a leading shard axis of length p. A
collective is one call over all shards:

- ``all_to_all`` takes the ``(p_src, p_dst, width, ...)`` send buffers of
  every shard and returns ``(p_dst, p_src, width, ...)``: shard i receives,
  at slot j, what shard j sent to i (``lax.all_to_all(split_axis=0,
  concat_axis=0, tiled=True)``);
- ``all_gather`` gives every shard the stacked ``(p, ...)`` values (one
  tensor that all shards read);
- ``ppermute`` moves shard ``src``'s value to shard ``dst`` for each pair
  of the permutation; shards that receive nothing get zeros.

Every collective issued is counted in :attr:`counts` by name, so that
wire accounting and a collective audit have something to read.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch


class VirtualMesh:
    """One mesh axis of ``num_shards`` virtual shards."""

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError(num_shards)
        self.num_shards = num_shards
        self.counts: Counter = Counter()

    @property
    def axis_size(self) -> int:
        return self.num_shards

    def axis_index(self, shard: int) -> int:
        if not 0 <= shard < self.num_shards:
            raise IndexError(shard)
        return shard

    def reset_counts(self) -> None:
        self.counts.clear()

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """(p_src, p_dst, ...) send buffers -> (p_dst, p_src, ...) received."""
        p = self.num_shards
        if buf.shape[0] != p or buf.shape[1] != p:
            raise ValueError(f"all_to_all needs a ({p}, {p}, ...) buffer, got "
                             f"{tuple(buf.shape)}")
        self.counts["all_to_all"] += 1
        return buf.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(p, ...) per-shard values -> the (p, ...) stack every shard sees."""
        if x.shape[0] != self.num_shards:
            raise ValueError(f"all_gather needs a leading shard axis, got "
                             f"{tuple(x.shape)}")
        self.counts["all_gather"] += 1
        return x

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """(p, ...) per-shard values -> out[dst] = x[src] for (src, dst) in
        ``perm``; other shards get zeros."""
        p = self.num_shards
        if x.shape[0] != p:
            raise ValueError(f"ppermute needs a leading shard axis, got "
                             f"{tuple(x.shape)}")
        self.counts["ppermute"] += 1
        out = torch.zeros_like(x)
        if perm:
            src = torch.tensor([s for s, _ in perm], device=x.device)
            dst = torch.tensor([d for _, d in perm], device=x.device)
            out[dst] = x[src]
        return out
