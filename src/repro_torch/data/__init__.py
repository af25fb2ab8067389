"""Deterministic synthetic tables and the relational token pipeline."""
from repro_torch.data.synthetic import (  # noqa: F401
    lm_labels_table,
    lm_samples_table,
    random_table,
    zipf_table,
)
from repro_torch.data.pipeline import RelationalTokenPipeline, Prefetcher  # noqa: F401
