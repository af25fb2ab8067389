"""The Whisper-style encoder-decoder of the port (``repro/models/encdec.py``),
the audio backbone; its conv frontend is a stub, as the reference's.

The encoder takes precomputed frame embeddings (B, S_enc, d), adds fp32
sinusoidal positions (cast to the activation dtype), and runs
bidirectional blocks (LayerNorm without bias, self-attention, LayerNorm,
GELU MLP, two residual adds) and a final LayerNorm. The decoder embeds its
tokens, adds a learned position table of ``MAX_DEC_POS`` rows, and runs
blocks of causal self-attention, cross-attention over the encoder's K and
V (projected once a layer by ``build_cross_kv``) and a GELU MLP, each after
a LayerNorm; a final LayerNorm and the embedding as a tied head. LayerNorm
and GELU round as the reference's (``layers.layer_norm``,
``layers.gelu``).

Attention goes through ``layers.attention_fwd``: the encoder's
self-attention ('bidir') and the decoder's ('causal') through the flash
kernel, its decode steps through the plain einsums over the cache; the
cross-attention ('cross_decode' over the built K and V, in prefill and
training too, as the reference) through the flash kernel, non-causal,
where the decoder's rows are as many as the encoder's, the plain einsums
otherwise (a decode step, or a prompt shorter than the audio).

Serving: prefill runs the encoder once, writes every layer's cross K/V
into the cache and the prompt's self K/V; a decode step updates only the
self cache and does not run the encoder again. While autograd records
(training), ``remat="full"`` (or ``"dots"``, the matmul outputs kept:
``transformer.remat_context``) runs each encoder and decoder block under
``torch.utils.checkpoint``, as the reference remats both scan bodies.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as NN
from repro_torch.models.common import (
    ModelConfig, ShardingRules, per_layer_specs, spec, stack_layer_specs)
from repro_torch.models.transformer import (
    AUX_KEYS, FrozenTree, _frozen, remat_context)

MAX_DEC_POS = 32768  # the learned decoder position table's rows


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """(s, d) fp32: sin over the first d/2 columns, cos over the rest, at
    angle pos / 10000^(2 i / d)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def init_enc_block(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d, dt, dev = cfg.d_model, cfg.param_dtype, generator.device
    return {"ln1": NN.init_norm(d, dt, dev),
            "attn": NN.init_attention(cfg, generator),
            "ln2": NN.init_norm(d, dt, dev),
            "mlp": NN.init_mlp(d, cfg.d_ff, cfg, generator, kind="gelu")}


def init_dec_block(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d, dt, dev = cfg.d_model, cfg.param_dtype, generator.device
    return {"ln1": NN.init_norm(d, dt, dev),
            "self": NN.init_attention(cfg, generator),
            "ln2": NN.init_norm(d, dt, dev),
            "cross": NN.init_attention(cfg, generator),
            "ln3": NN.init_norm(d, dt, dev),
            "mlp": NN.init_mlp(d, cfg.d_ff, cfg, generator, kind="gelu")}


def enc_block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    return {"ln1": rules.vec(), "attn": NN.attention_specs(cfg, rules),
            "ln2": rules.vec(),
            "mlp": NN.mlp_specs(cfg.d_model, cfg.d_ff, rules, kind="gelu")}


def dec_block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    return {"ln1": rules.vec(), "self": NN.attention_specs(cfg, rules),
            "ln2": rules.vec(), "cross": NN.attention_specs(cfg, rules),
            "ln3": rules.vec(),
            "mlp": NN.mlp_specs(cfg.d_model, cfg.d_ff, rules, kind="gelu")}


class EncBlock(FrozenTree):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__(init_enc_block(cfg, generator))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = NN.layer_norm(x, self["ln1"], None, cfg.norm_eps)
        a, _ = NN.attention_fwd(self["attn"], h, cfg, mode="bidir")
        x = x + a
        h = NN.layer_norm(x, self["ln2"], None, cfg.norm_eps)
        return x + NN.mlp_fwd(self["mlp"], h)


class DecBlock(FrozenTree):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__(init_dec_block(cfg, generator))
        self.cfg = cfg

    def forward(self, x: torch.Tensor, cross_kv, *, mode: str,
                self_cache=None, pos: int | None = None,
                mesh=None) -> torch.Tensor:
        """Self-attention ('causal' or 'decode'; the cache written in
        place; its decode seq-sharded on a mesh's model axis > 1),
        cross-attention over ``cross_kv`` {'k', 'v'} (B, T, KV, hd), the
        MLP."""
        cfg = self.cfg
        h = NN.layer_norm(x, self["ln1"], None, cfg.norm_eps)
        a, _ = NN.attention_fwd(self["self"], h, cfg, mode=mode,
                                cache=self_cache, pos=pos, mesh=mesh)
        x = x + a
        h = NN.layer_norm(x, self["ln2"], None, cfg.norm_eps)
        c, _ = NN.attention_fwd(self["cross"], h, cfg, mode="cross_decode",
                                cache=cross_kv)
        x = x + c
        h = NN.layer_norm(x, self["ln3"], None, cfg.norm_eps)
        return x + NN.mlp_fwd(self["mlp"], h)


class EncDec(nn.Module):
    """Parameters drawn from ``generator`` on its device in the reference's
    distributions: the embedding and ``dec_pos`` N(0, 0.02^2), every
    matrix N(0, 1/fan_in), norms ones."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family != "audio" or cfg.encoder_layers <= 0 or \
                cfg.attn_kind != "gqa" or cfg.moe_num_experts or \
                cfg.frontend != "audio_stub" or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.arch}: the encoder-decoder takes GQA attention, "
                f"encoder_layers > 0, the audio_stub front, a tied head and "
                f"no experts")
        self.cfg = cfg
        dev = generator.device
        self.embed = _frozen(NN.init_embed(cfg, generator))
        self.dec_pos = _frozen(NN._dense((MAX_DEC_POS, cfg.d_model),
                                         cfg.param_dtype, generator,
                                         scale=0.02))
        self.enc_layers = nn.ModuleList(EncBlock(cfg, generator)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, generator)
                                        for _ in range(cfg.num_layers))
        self.enc_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                             dev))
        self.dec_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                             dev))

    def _remat(self):
        """``checkpoint``'s context_fn while autograd records, else None."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            return remat_context(self.cfg)
        return None

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """embeds (B, S_enc, d), the frontend stub's frame embeddings ->
        the encoder's output (B, S_enc, d) in the activation dtype."""
        cfg = self.cfg
        x = embeds.to(cfg.dtype) + _sinusoid(
            embeds.shape[1], cfg.d_model, embeds.device).to(cfg.dtype)[None]
        remat = self._remat()
        for block in self.enc_layers:
            x = checkpoint(block, x, use_reentrant=False, context_fn=remat) \
                if remat is not None else block(x)
        return NN.layer_norm(x, self.enc_norm, None, cfg.norm_eps)

    def build_cross_kv(self, enc: torch.Tensor) -> list[dict]:
        """Each decoder layer's cross K/V {'k', 'v'} (B, S_enc, KV, hd)
        from the encoder's output."""
        cfg = self.cfg
        b, s, _ = enc.shape
        shape = (b, s, cfg.num_kv_heads, cfg.hd)
        return [{"k": (enc @ blk["cross"]["wk"].to(enc.dtype)).reshape(shape),
                 "v": (enc @ blk["cross"]["wv"].to(enc.dtype)).reshape(shape)}
                for blk in self.dec_layers]

    def decode(self, tokens: torch.Tensor, cross: list[dict], *, mode: str,
               self_cache=None, pos: int | None = None,
               mesh=None) -> torch.Tensor:
        """The decoder: mode 'causal' (prefill, teacher forcing) or
        'decode' (new tokens at ``pos``); ``self_cache`` the stacked
        {'k', 'v'} (L, B, S_max, KV, hd), written in place. Returns the
        logits (B, S, padded_vocab)."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = NN.embed_fwd(self.embed, tokens, cfg)
        start = pos if mode == "decode" else 0
        pidx = torch.arange(s, device=x.device) + start
        x = x + self.dec_pos[pidx].to(cfg.dtype)[None]
        remat = self._remat() if self_cache is None else None
        for i, block in enumerate(self.dec_layers):
            sc = None if self_cache is None else \
                {name: t[i] for name, t in self_cache.items()}
            if remat is not None:
                x = checkpoint(block, x, cross[i], mode=mode, mesh=mesh,
                               use_reentrant=False, context_fn=remat)
            else:
                x = block(x, cross[i], mode=mode, self_cache=sc, pos=pos,
                          mesh=mesh)
        x = NN.layer_norm(x, self.dec_norm, None, cfg.norm_eps)
        return NN.unembed_fwd(self.embed, x, cfg)

    def forward(self, tokens: torch.Tensor, *, embeds=None,
                mode: str = "causal", cache=None, pos: int | None = None,
                mesh=None):
        """Returns (logits (B, S, padded_vocab), cache, aux).

        mode 'causal': ``embeds`` (B, S_enc, d) through the encoder, then
        the decoder over ``tokens`` (B, S) teacher-forced (training), or,
        with a cache (``init_encdec_cache``'s, its cross rows S_enc), a
        prefill that writes the cross K/V and the prompt's self K/V. mode
        'decode': new tokens at ``pos`` against the cache; the encoder is
        not run again. aux: the zero MoE terms. mesh: the decoder's
        self-attention's."""
        cfg = self.cfg
        if mode == "decode":
            cross = [{name: t[i] for name, t in cache["cross"].items()}
                     for i in range(cfg.num_layers)]
            logits = self.decode(tokens, cross, mode="decode",
                                 self_cache=cache["self"], pos=pos, mesh=mesh)
        elif mode == "causal":
            if embeds is None:
                raise ValueError(f"{cfg.arch}: the encoder needs frame "
                                 f"embeddings (B, S_enc, {cfg.d_model}) as "
                                 f"embeds")
            cross = self.build_cross_kv(self.encode(embeds))
            if cache is not None:
                have = cache["cross"]["k"].shape[2]
                if have != embeds.shape[1]:
                    raise ValueError(f"the cache holds {have} cross rows, the "
                                     f"audio {embeds.shape[1]} frames")
                for i, kv in enumerate(cross):
                    for name, t in kv.items():
                        cache["cross"][name][i] = t.to(
                            cache["cross"][name].dtype)
            logits = self.decode(tokens, cross, mode="causal",
                                 self_cache=None if cache is None
                                 else cache["self"], mesh=mesh)
        else:
            raise ValueError(f"encoder-decoder mode {mode!r}: 'causal' or "
                             f"'decode'")
        aux = {k: torch.zeros((), dtype=torch.float32, device=logits.device)
               for k in AUX_KEYS}
        return logits, cache, aux


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{'self': {'k', 'v'} (L, B, max_len, KV, hd), 'cross': {'k', 'v'} (L,
    B, enc_len, KV, hd)}, zeros in cfg.dtype."""
    def stacked(rows):
        shape = (cfg.num_layers, batch, rows, cfg.num_kv_heads, cfg.hd)
        return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
                for name in ("k", "v")}
    return {"self": stacked(max_len), "cross": stacked(enc_len)}


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, tuple]:
    """{parameter name: spec} of an :class:`EncDec` (the learned position
    table replicated)."""
    return {"embed": NN.embed_spec(cfg, rules), "dec_pos": spec(None, None),
            **per_layer_specs(enc_block_specs(cfg, rules), "enc_layers",
                              cfg.encoder_layers),
            **per_layer_specs(dec_block_specs(cfg, rules), "dec_layers",
                              cfg.num_layers),
            "enc_norm": rules.vec(), "dec_norm": rules.vec()}


def encdec_cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                       ) -> dict:
    """The self and cross caches as attention caches, stacked on L."""
    one = stack_layer_specs(NN.attn_cache_specs(cfg, rules, batch))
    return {"self": one, "cross": dict(one)}
