"""``DistContext.groupby`` on the traffic's one input, with the default
strategy unless the traffic names one."""
from __future__ import annotations

import torch

from bench.ops.common import dist_table


def prepare(ctx, tables: dict, traffic: dict, *, config=None, seed=None):
    (name,) = traffic["inputs"]
    return dist_table(tables[name])


def call(ctx, state, traffic: dict):
    kw = dict(traffic["call"])
    keys, aggs = kw.pop("keys"), kw.pop("aggs")
    report: list = []
    out, _ = ctx.groupby(state, keys, aggs, report=report, **kw)
    return out, report


def summarize(out, counts: list[int]) -> dict:
    """Every group on the host: its columns and the worker that holds it."""
    rows = {k: torch.cat([v[i, :n] for i, n in enumerate(counts)]).cpu()
            for k, v in out.columns.items()}
    shard = torch.repeat_interleave(torch.arange(len(counts)),
                                    torch.tensor(counts))
    return {"counts": list(counts), "rows": rows, "shard": shard}
