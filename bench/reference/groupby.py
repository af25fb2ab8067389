"""Keyed aggregation, the plain way: each group's count, sum, mean,
population variance (two passes), min and max by scatter over
``torch.unique``'s inverse, each group on the worker its key hashes to.
An integer column's sum, min and max are exact (int64), a float column's
arithmetic is float64. The control carries each value column at the type
below its own and runs the float arithmetic in that type."""
from __future__ import annotations

import torch

from bench.reference.common import LOWER, flat
from bench.reference.hashing import partition_of

# the aggregates of an integer column that are exact
EXACT_INT = ("sum", "count", "min", "max")


def _aggregate(x: torch.Tensor, inv: torch.Tensor, groups: int,
               count: torch.Tensor, ops) -> dict[str, torch.Tensor]:
    """The ``ops`` of one column, in ``x``'s type (count in int64)."""
    dt = x.dtype

    def scatter_sum(v):
        return torch.zeros(groups, dtype=v.dtype, device=v.device
                           ).index_add_(0, inv, v)

    def extreme(how):
        info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
        start = info.max if how == "amin" else info.min
        return torch.full((groups,), start, dtype=dt, device=x.device
                          ).scatter_reduce_(0, inv, x, how)

    out = {}
    for op in ops:
        if op == "count":
            out[op] = count
        elif op == "sum":
            out[op] = scatter_sum(x)
        elif op in ("mean", "var"):
            mean = scatter_sum(x) / count.to(dt)
            out[op] = mean if op == "mean" else \
                scatter_sum((x - mean[inv]) ** 2) / count.to(dt)
        else:
            out[op] = extreme("amin" if op == "min" else "amax")
    return out


def expected(tables: dict, traffic: dict, workers: int, *, config=None,
             seed=None, control: bool = False) -> dict:
    call = traffic["call"]
    key, hash_seed = call["keys"], int(call.get("seed", 7))
    (name,) = traffic["inputs"]
    t = flat({c: tables[name][c] for c in [key, *call["aggs"]]}, control,
             (key,))
    keys, inv = torch.unique(t[key], return_inverse=True)
    groups = keys.shape[0]
    count = torch.bincount(inv, minlength=groups)
    rows = {key: keys}
    scales = {}
    for col, ops in call["aggs"].items():
        src = tables[name][col].dtype
        if src.is_floating_point:
            float_ops, int_ops = ops, []
        else:
            int_ops = [op for op in ops if op in EXACT_INT]
            float_ops = [op for op in ops if op not in EXACT_INT]
        arith = LOWER[src] if control and src.is_floating_point else torch.float64
        for op, v in _aggregate(t[col].to(arith), inv, groups, count,
                                float_ops).items():
            rows[f"{col}_{op}"] = v.to(torch.float64) if op != "count" else v
        for op, v in _aggregate(t[col].to(torch.int64), inv, groups, count,
                                int_ops).items():
            rows[f"{col}_{op}"] = v
        # what each float aggregate's rounding error scales with: the sum
        # of magnitudes (sum), their mean (mean), the mean square (var)
        x64 = tables[name][col].reshape(-1).to(torch.float64)
        mag = torch.zeros(groups, dtype=torch.float64, device=x64.device
                          ).index_add_(0, inv, x64.abs())
        scale = {"sum": lambda: mag, "mean": lambda: mag / count,
                 "var": lambda: torch.zeros_like(mag).index_add_(
                     0, inv, x64 * x64) / count}
        for op in float_ops:
            if op in scale:
                scales[f"{col}_{op}"] = scale[op]()
    shard = partition_of([keys], workers, hash_seed)
    return {"counts": torch.bincount(shard, minlength=workers).tolist(),
            "key": key, "rows": {k: v.cpu() for k, v in rows.items()},
            "scales": {k: v.cpu() for k, v in scales.items()},
            "shard": shard.cpu()}


def compare(calls: list[list[int]], checked: list[dict], want: dict,
            limits: dict) -> list[tuple[str, float, float]]:
    """Calls whose per-worker group counts differ, groups missing, doubled
    or on another worker, exact aggregates (count, min, max, an integer
    column's sum) that differ, each with limit 0; and the widest gap of a
    float aggregate (sum, mean, var) as a share of its error scale,
    against ``limits``."""
    key = want["key"]
    wk = want["rows"][key]
    bad_calls = sum(c != want["counts"] for c in calls)
    misplaced = exact_bad = 0
    worst = 0.0
    for got in checked:
        order = torch.argsort(got["rows"][key])
        gk = got["rows"][key][order]
        if gk.shape != wk.shape or not torch.equal(gk, wk):
            # a group missing, doubled or foreign: the aggregates have no
            # partner to be compared with
            misplaced += max(1, int((~torch.isin(wk, gk)).sum())
                             + int((~torch.isin(gk, wk)).sum())
                             + gk.shape[0] - torch.unique(gk).shape[0])
            continue
        misplaced += int((got["shard"][order] != want["shard"]).sum())
        for name, w in want["rows"].items():
            if name == key:
                continue
            g = got["rows"][name][order].to(w.dtype)
            if name in want["scales"]:
                gap = (g - w).abs() / want["scales"][name].clamp_min(1e-300)
                worst = max(worst, float(torch.nan_to_num(gap, nan=float("inf")).max()))
            else:
                exact_bad += int((g != w).sum())
    return [("calls_with_wrong_counts", float(bad_calls), 0.0),
            ("groups_missing_or_misplaced", float(misplaced), 0.0),
            ("exact_aggregates_wrong", float(exact_bad), 0.0),
            ("float_aggregate_gap", worst, float(limits["float_aggregate_gap"]))]
