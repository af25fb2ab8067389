"""Order-free fingerprints of a multiset of rows, so that a result of a
hundred million rows is compared exactly without a second copy of it.

A row hashes its columns' 32-bit words (a 64-bit column gives two), in
sorted column order, through a 64-bit multiply-xorshift chain; a worker's digest is the sum of its rows'
hashes modulo 2**64. Equal multisets give equal digests; a row lost,
added, altered or placed on another worker changes its worker's digest
except with a chance of about 2**-64. The program's result and the
reference's rows go through the same function on the same device."""
from __future__ import annotations

import torch

from bench.reference.hashing import as_u32

_SEED = 0x243F6A8885A308D3
_K = 0x5851F42D4C957F2D


def _words(x: torch.Tensor) -> list[torch.Tensor]:
    """A 1-D column's 32-bit words, each int64 in [0, 2**32)."""
    if x.element_size() == 8:
        pair = x.contiguous().view(torch.int32).reshape(-1, 2)
        return [as_u32(pair[:, 0]), as_u32(pair[:, 1])]
    return [as_u32(x)]


def row_hashes(columns: dict[str, torch.Tensor]) -> torch.Tensor:
    """(n,) int64 hash of each row of 32- or 64-bit columns of one length."""
    names = sorted(columns)
    n = columns[names[0]].shape[0]
    h = torch.full((n,), _SEED, dtype=torch.int64,
                   device=columns[names[0]].device)
    for name in names:
        for w in _words(columns[name]):
            h = (h ^ w) * _K
            h = h ^ (h >> 29)
    return h


def shard_digests(columns: dict[str, torch.Tensor], shard: torch.Tensor,
                  workers: int) -> torch.Tensor:
    """(workers,) int64: the sum of the row hashes on each worker, where
    ``shard`` (n,) gives each row's worker."""
    out = torch.zeros(workers, dtype=torch.int64, device=shard.device)
    return out.index_add_(0, shard.to(torch.int64), row_hashes(columns))


def result_digests(columns: dict[str, torch.Tensor], counts: list[int]
                   ) -> list[int]:
    """Per-worker digests of a sharded result: ``columns`` (workers, C),
    worker i's valid rows ``[0, counts[i])``, one worker at a time so the
    temporaries stay small."""
    out = []
    for i, n in enumerate(counts):
        h = row_hashes({k: v[i, :n] for k, v in columns.items()})
        out.append(int(h.sum()))
    return out
