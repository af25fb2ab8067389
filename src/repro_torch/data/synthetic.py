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


def lm_samples_table(rows: int, seq_len: int, vocab_size: int, *,
                     seed: int = 0, step: int = 0, shard: int = 0,
                     device: str | torch.device = "cuda") -> Table:
    """LM pre-training 'documents': tokens as a 2-D column + metadata.

    Columns: sample_id (int32), tokens (rows, seq_len) int32 in ``[1,
    vocab_size)``, quality (float32 in [0, 1)): the filter column, source
    (int32 bucket in [0, 8)).
    """
    rng = _rng(seed, step, shard)
    base = (step * 1_000_003 + shard * 7_001) % (2**31 - rows)
    return Table.from_numpy({
        "sample_id": (base + np.arange(rows)).astype(np.int32),
        "tokens": rng.integers(1, vocab_size, (rows, seq_len)).astype(np.int32),
        "quality": rng.random(rows).astype(np.float32),
        "source": rng.integers(0, 8, rows).astype(np.int32),
    }, device=device)


def lm_labels_table(sample_ids: np.ndarray, *, seed: int = 0, step: int = 0,
                    shard: int = 0, drop_fraction: float = 0.1,
                    device: str | torch.device = "cuda") -> Table:
    """Per-sample weights keyed by sample_id (host ids in, so no device
    read); a fraction is missing, so the pipeline's inner join also acts
    as a filter (the paper's ETL join)."""
    rng = _rng(seed ^ 0x5EED, step, shard)
    keep = rng.random(len(sample_ids)) >= drop_fraction
    ids = np.asarray(sample_ids)[keep]
    return Table.from_numpy({
        "sample_id": ids.astype(np.int32),
        "weight": 0.5 + rng.random(len(ids)).astype(np.float32),
    }, device=device)
