"""Synthetic table generators: the paper's benchmark relation, deterministic.

The paper's experiments use rows of one integer index and three doubles; the
engine uses int32 keys and float32 payloads (16 bytes a row). Every
generator is a pure function of ``(seed, step, shard)``: the numpy streams
are those of ``repro.data.synthetic`` (``SeedSequence([seed, step,
shard])``), so both packages get the same rows from the same arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.table import Table


def _rng(seed: int, step: int = 0, shard: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


def random_table(rows: int, *, num_payload: int = 3, key_range: int | None = None,
                 seed: int = 0, step: int = 0, shard: int = 0,
                 key_name: str = "k",
                 device: str | torch.device = "cuda") -> Table:
    """The paper's relation: one int32 key + ``num_payload`` float32s."""
    rng = _rng(seed, step, shard)
    key_range = key_range or max(1, rows)
    cols = {key_name: rng.integers(0, key_range, rows).astype(np.int32)}
    for i in range(num_payload):
        cols[f"d{i}"] = rng.standard_normal(rows).astype(np.float32)
    return Table.from_numpy(cols, device=device)


def zipf_table(rows: int, *, a: float = 1.5, num_payload: int = 3,
               key_range: int | None = None, seed: int = 0, step: int = 0,
               shard: int = 0, key_name: str = "k",
               device: str | torch.device = "cuda") -> Table:
    """Skewed (Zipf) keys: stresses shuffle bucket overflow handling."""
    rng = _rng(seed, step, shard)
    key_range = key_range or max(1, rows)
    k = (rng.zipf(a, rows) - 1) % key_range
    cols = {key_name: k.astype(np.int32)}
    for i in range(num_payload):
        cols[f"d{i}"] = rng.standard_normal(rows).astype(np.float32)
    return Table.from_numpy(cols, device=device)
