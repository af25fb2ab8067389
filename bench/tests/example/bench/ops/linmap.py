"""A linear map over a token table whose map takes one fixed step every
call: the smallest operator whose calls carry state, as a training step
carries its weights. It stands in for a model's module in the harness's
tests (``bench/tests/example``) and has no program behind it."""
from __future__ import annotations

import torch

from bench.tables import weights

# the weights lie on a grid of 2**-GRID, so the map's steps add exactly
GRID = 10


def _draw(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    d, v = int(config["hidden_size"]), int(config["vocab_size"])
    w = weights(seed, {"embed": (v, d), "map": (d, d), "step": (d, d)}, device)
    scale = {"embed": 1.0, "map": d ** -0.5, "step": 1e-2 * d ** -0.5}
    return {k: torch.round(t * scale[k] * 2**GRID) / 2**GRID
            for k, t in w.items()}


def prepare(ctx, tables: dict, traffic: dict, *, config, seed):
    (name,) = traffic["inputs"]
    w = _draw(config, seed, ctx.device)
    ids = tables[name]["id"].reshape(-1) % int(config["vocab_size"])
    return {"x": w["embed"][ids], "map": w["map"], "step": w["step"]}


def rows(state) -> torch.Tensor:
    """The tokens' features a call maps."""
    return state["x"]


def advance(state) -> None:
    """The state after a call: the map one step on."""
    state["map"] = state["map"] + state["step"]


def call(ctx, state, traffic: dict):
    y = rows(state) @ state["map"]
    advance(state)
    return y, []


def counts(y) -> list[int]:
    return [y.shape[0]]


def summarize(y, call_counts: list[int]) -> dict:
    return {"counts": list(call_counts), "y": y.cpu()}
