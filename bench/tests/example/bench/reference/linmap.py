"""The plain reference of the ``linmap`` operator: the weights drawn again
from the seed, and each checked call's result against the features times
the map after as many calls, ``map + call * step``, in float64. The control
carries the features and the map through bfloat16, the type below float32,
and answers for the second call, the one ``bench/controls.py`` judges."""
from __future__ import annotations

import torch

from bench.reference.common import LOWER
from bench.tables import weights

GRID = 10


def _draw(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    d, v = int(config["hidden_size"]), int(config["vocab_size"])
    w = weights(seed, {"embed": (v, d), "map": (d, d), "step": (d, d)}, device)
    scale = {"embed": 1.0, "map": d ** -0.5, "step": 1e-2 * d ** -0.5}
    return {k: torch.round(t * scale[k] * 2**GRID) / 2**GRID
            for k, t in w.items()}


def expected(tables: dict, traffic: dict, workers: int, *, config, seed,
             control: bool = False) -> dict:
    (name,) = traffic["inputs"]
    ids = tables[name]["id"].reshape(-1)
    w = _draw(config, seed, ids.device)
    x = w["embed"][ids % int(config["vocab_size"])]
    want = {"counts": [x.shape[0]], "x": x.double().cpu(),
            "map": w["map"].double().cpu(), "step": w["step"].double().cpu()}
    if control:
        low = LOWER[x.dtype]
        m = w["map"] + w["step"]
        want.update(call=1, y=(x.to(low) @ m.to(low)).float().cpu())
    return want


def compare(calls: list[list[int]], checked: list[dict], want: dict,
            limits: dict) -> list[tuple[str, float, float]]:
    """Calls whose row count differs (limit 0), and the widest gap of a
    result's entry from the reference's, as a share of the reference's
    largest entry."""
    bad_calls = sum(c != want["counts"] for c in calls)
    worst = 0.0
    for got in checked:
        ref = want["x"] @ (want["map"] + got["call"] * want["step"])
        if got["y"].shape != ref.shape:
            worst = float("inf")
            continue
        gap = (got["y"].double() - ref).abs().max() / ref.abs().max()
        worst = max(worst, float(gap))
    return [("calls_with_wrong_counts", float(bad_calls), 0.0),
            ("map_gap", worst, float(limits["map_gap"]))]
