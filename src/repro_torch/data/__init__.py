"""Deterministic synthetic tables (the paper's benchmark relation)."""
