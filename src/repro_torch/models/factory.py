"""Model factory of the port (``repro/models/factory.py``), dense family.

``build_model(cfg, device)`` returns a :class:`Model`: an ``nn.Module``
holding a :class:`~repro_torch.models.transformer.Transformer` drawn from
a ``torch.Generator``, with ``forward``, ``init_cache`` and
``decode_step``. The parameters live in the module, so the step functions
take none (the reference passes its parameter tree to every call). Left for
later: ``loss_fn`` (the training slice) and the other families.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import transformer as TF
from repro_torch.models.common import ModelConfig
from repro_torch.utils import resolve_device


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.lm = TF.Transformer(cfg, generator)

    @property
    def device(self) -> torch.device:
        return self.lm.embed.device

    def forward(self, *, tokens: torch.Tensor, mode: str = "causal",
                cache=None, pos: int | None = None):
        """(logits (B, S, padded_vocab), cache, aux)."""
        return self.lm(tokens, mode=mode, cache=cache, pos=pos)

    def init_cache(self, batch: int, max_len: int):
        return TF.init_cache(self.cfg, batch, max_len, self.device)

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """(logits (B, S, vocab_size), cache): the vocab padding trimmed."""
        logits, cache, _ = self.forward(tokens=tokens, mode="decode",
                                        cache=cache, pos=pos)
        return logits[..., : self.cfg.vocab_size], cache


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda", *,
                generator: torch.Generator | None = None) -> Model:
    """A model of ``cfg`` with random weights on ``device`` (``cuda`` unless
    the caller asks for another; ``cuda`` without a card raises), drawn from
    ``generator`` (one on ``device``; by default a new one seeded 0)."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not ported (dense only)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return Model(cfg, generator)
