"""Inner equi-join, the plain way: sort the right side's keys, find each
left row's run of equal keys with two binary searches, expand the pairs.
Every matching pair once, on the worker its key hashes to."""
from __future__ import annotations

import torch

from bench.reference.common import BLOCK_ROWS, compare_exact, flat
from bench.reference.digest import shard_digests
from bench.reference.hashing import partition_of


def expected(tables: dict, traffic: dict, workers: int, *, config=None,
             seed=None, control: bool = False) -> dict:
    call = traffic["call"]
    on, hash_seed = call["on"], int(call.get("seed", 7))
    left_name, right_name = traffic["inputs"]
    a = flat(tables[left_name], control, (on,))
    b = flat(tables[right_name], control, (on,))
    dev = a[on].device
    bk, perm = torch.sort(b[on], stable=True)
    digests = torch.zeros(workers, dtype=torch.int64, device=dev)
    counts = torch.zeros(workers, dtype=torch.int64, device=dev)
    n = a[on].shape[0]
    for start in range(0, n, BLOCK_ROWS):
        ak = a[on][start:start + BLOCK_ROWS]
        lo = torch.searchsorted(bk, ak)
        cnt = torch.searchsorted(bk, ak, right=True) - lo
        ai = torch.repeat_interleave(
            torch.arange(start, start + ak.shape[0], device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(ai.shape[0], device=dev) - \
            torch.repeat_interleave(first, cnt)
        bi = perm[torch.repeat_interleave(lo, cnt) + off]
        cols = {c: v[ai] for c, v in a.items()}
        cols.update({(c + "_r" if c in a else c): v[bi] for c, v in b.items()})
        shard = partition_of([cols[on]], workers, hash_seed)
        digests += shard_digests(cols, shard, workers)
        counts += torch.bincount(shard, minlength=workers)
    return {"counts": counts.tolist(), "digests": digests.tolist()}


compare = compare_exact
