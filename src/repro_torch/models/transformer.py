"""The decoder-only transformer of the port (``repro/models/transformer.py``),
dense GQA family: ``Block`` (RMSNorm, GQA attention, RMSNorm, SwiGLU MLP,
two residual adds) and ``Transformer`` (embedding, the blocks, final norm,
a tied or untied head), with ``init_cache``.

The reference scans stacked layer parameters under ``jit``; here
``Transformer.forward`` (the reference's ``lm_forward``) is a Python loop
over ``Block`` modules, each holding its own layer's tensors. The cache
stays stacked on L, as the reference's, and each block writes its slice in
place. While autograd records (training), ``cfg.remat`` applies as the
reference's ``_remat``: ``"full"`` runs each block under
``torch.utils.checkpoint`` (its input saved, its forward run again in the
backward), ``"none"`` plainly. Left for later: MoE, MLA, the vision front,
and the ``"dots"`` policy (matmul outputs saved).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as NN
from repro_torch.models.common import ModelConfig


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # no autograd graph is built through the weights unless a train step
    # (train/steps.py) makes them trainable for its backward
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(d: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


def _remat_contexts():
    """``checkpoint``'s (forward, recompute) contexts. The recompute runs
    inside the backward, for CUDA tensors on autograd's device thread,
    where the caller's thread-local ``oracle_scope()`` is not set: it is
    carried over, so the recompute takes the forward's attention path."""
    again = kops.oracle_scope() if kops.oracle_only() else contextlib.nullcontext()
    return contextlib.nullcontext(), again


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dev = generator.device
        self.ln1 = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype, dev))
        self.attn = _frozen_dict(NN.init_attention(cfg, generator))
        self.ln2 = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype, dev))
        self.mlp = _frozen_dict(NN.init_mlp(cfg.d_model, cfg.d_ff, cfg,
                                            generator))

    def forward(self, x: torch.Tensor, *, rope, mode: str, cache=None,
                pos: int | None = None):
        cfg = self.cfg
        h = NN.rms_norm(x, self.ln1, cfg.norm_eps)
        a, cache = NN.attention_fwd(self.attn, h, cfg, mode=mode, rope=rope,
                                    cache=cache, pos=pos)
        x = x + a
        h = NN.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + NN.mlp_fwd(self.mlp, h), cache


class Transformer(nn.Module):
    """Parameters are drawn from ``generator`` on its device, in the
    reference's distributions: embedding N(0, 0.02^2), every matrix
    N(0, 1/fan_in) with fan-in its second-to-last dim (so the untied head,
    (padded_vocab, d), has std 1/sqrt(padded_vocab)), norms ones."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family != "dense" or cfg.attn_kind != "gqa" or \
                cfg.moe_num_experts or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.arch}: only the dense GQA family is ported")
        self.cfg = cfg
        dev = generator.device
        self.embed = _frozen(NN.init_embed(cfg, generator))
        self.layers = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                               dev))
        self.lm_head = None if cfg.tie_embeddings else _frozen(NN._dense(
            (cfg.padded_vocab, cfg.d_model), cfg.param_dtype, generator))

    def forward(self, tokens: torch.Tensor, *, mode: str = "causal",
                cache=None, pos: int | None = None):
        """Returns (logits (B, S, padded_vocab), cache, aux).

        tokens (B, S) int; mode 'causal' (prefill, training) or 'decode'
        (S new tokens at ``pos``, a Python int). cache: ``init_cache``'s
        stacked {'k', 'v'}, written in place and returned.
        """
        cfg = self.cfg
        x = NN.embed_fwd(self.embed, tokens, cfg)
        s = x.shape[1]
        start = pos if mode == "decode" else 0
        positions = torch.arange(s, device=x.device) + start
        rope = NN.rope_tables(positions, cfg.hd, cfg.rope_theta)
        remat = cache is None and torch.is_grad_enabled() and x.requires_grad
        if remat and cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.remat!r}: the port has "
                                      "'full' and 'none'")
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else \
                {"k": cache["k"][i], "v": cache["v"][i]}
            if remat and cfg.remat == "full":
                x, _ = checkpoint(block, x, rope=rope, mode=mode,
                                  use_reentrant=False,
                                  context_fn=_remat_contexts)
            else:
                x, _ = block(x, rope=rope, mode=mode, cache=layer_cache,
                             pos=pos)
        x = NN.rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = NN.unembed_fwd(head, x, cfg)
        return logits, cache, {"moe_aux": 0.0, "moe_dropped": 0.0}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device
               ) -> dict[str, torch.Tensor]:
    """Stacked (L, B, max_len, KV, hd) decode cache in ``cfg.dtype``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
