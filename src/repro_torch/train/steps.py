"""Serving steps of the port (``repro/train/steps.py:223-246``).

The model holds its parameters, so the step functions close over it and
take none. Left for later: every training step.
"""
from __future__ import annotations

from repro_torch.models.factory import Model


def make_prefill_step(model: Model, max_len: int):
    """batch -> (last_logits (B, padded_vocab), cache): a causal pass over
    ``batch['tokens']`` that writes a fresh (L, B, max_len, KV, hd) cache.
    The logits keep the vocab padding, as the reference's prefill does."""
    def prefill_fn(batch):
        if batch.get("embeds") is not None:
            raise NotImplementedError("prefill with embeds (vlm, audio) is "
                                      "not ported")
        tokens = batch["tokens"]
        cache = model.init_cache(tokens.shape[0], max_len)
        logits, cache, _ = model.forward(tokens=tokens, mode="causal",
                                         cache=cache)
        return logits[:, -1], cache
    return prefill_fn


def make_decode_step(model: Model):
    """(cache, tokens (B, 1), pos: int) -> (logits (B, vocab_size), cache),
    the cache updated in place."""
    def decode_fn(cache, tokens, pos: int):
        logits, cache = model.decode_step(cache, tokens, pos)
        return logits[:, -1], cache
    return decode_fn
