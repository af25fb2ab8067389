"""``DistContext.join`` on the traffic's two inputs. With ``prepartition``,
set-up hash-partitions both inputs once (``DistContext.partition_by``) and
every call goes through a lazy frame, whose planner elides both shuffles."""
from __future__ import annotations

from bench.ops.common import dist_table, exact_summary


def prepare(ctx, tables: dict, traffic: dict, *, config=None, seed=None):
    left, right = (dist_table(tables[name]) for name in traffic["inputs"])
    pre = traffic.get("prepartition")
    if pre:
        left, _ = ctx.partition_by(left, pre["keys"], seed=int(pre["seed"]))
        right, _ = ctx.partition_by(right, pre["keys"], seed=int(pre["seed"]))
    return left, right


def call(ctx, state, traffic: dict):
    left, right = state
    kw = dict(traffic["call"])
    on = kw.pop("on")
    report: list = []
    if traffic.get("prepartition"):
        out, _ = ctx.frame(left).join(ctx.frame(right), on, **kw
                                      ).collect_with_stats(report=report)
    else:
        out, _ = ctx.join(left, right, on, report=report, **kw)
    return out, report


summarize = exact_summary
