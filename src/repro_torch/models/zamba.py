"""The Zamba2-style hybrid of the port (``repro/models/zamba.py``): a Mamba2
(SSD) backbone and one shared attention block.

zamba2-1.2b runs 38 Mamba2 blocks; after every ``attn_every``-th (6) the
**shared** ``transformer.Block`` runs (one set of weights, its own KV cache
slot for each of its invocations), then the ``rem`` trailing Mamba blocks
(2). The reference scans over periods (``attn_every`` stacked Mamba blocks
and one shared-block call); here ``Hybrid.forward`` loops over them in
Python, each Mamba block an ``nn.Module`` with its own layer's tensors.
While autograd records (training), ``remat="full"`` (or ``"dots"``, the
matmul outputs kept: ``transformer.remat_context``) runs each period under
``torch.utils.checkpoint``, as the reference's ``_remat(period_body)``: the
period's input is saved and its Mamba blocks and shared block run again in
the backward, so a step runs the shared block's flash forward twice an
invocation and its backward once. The trailing blocks run plainly, as in
the reference.

The Mamba2 block (``MambaBlock``): RMSNorm, ``in_proj`` to (z, x, B, C, Δ),
the causal depthwise conv over (x, B, C) and SiLU, Δ = softplus(Δ +
dt_bias) folded into k = B Δ, q = C (one group shared by the heads), the
chunked GLA (prefill, training) or its decode step over the fp32 state,
the ``D`` skip, a gated RMSNorm (norm(y) * SiLU(z)), ``out_proj`` and the
residual, with the reference's rounding points (``models/recurrent.py``;
SiLU as ``jax.nn.silu`` lowers, op by op in the activation dtype:
``layers.silu``).

Like the reference, the shared block sees the hidden state only (Zamba2's
concatenated embeddings and per-invocation LoRA are left out there too).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as NN
from repro_torch.models.common import (
    ModelConfig, ShardingRules, flat_specs, per_layer_specs, spec,
    stack_layer_specs)
from repro_torch.models.recurrent import (
    causal_depthwise_conv, chunked_gla, gla_decode_step)
from repro_torch.models.transformer import (
    AUX_KEYS, Block, FrozenTree, _frozen, block_specs, remat_context)


def _mamba_dims(cfg: ModelConfig):
    """(d_inner, state N, heads H, value head dim P, conv channels, in_proj
    width)."""
    d_in = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.n_ssm_heads
    p = d_in // h
    conv_ch = d_in + 2 * n                   # x, B, C go through the conv
    d_proj = 2 * d_in + 2 * n + h            # z, x, B, C, dt
    return d_in, n, h, p, conv_ch, d_proj


def _mamba_split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, _, _, _, conv_ch, _ = _mamba_dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_ch],
            zxbcdt[..., d_in + conv_ch:])


def init_mamba_block(cfg: ModelConfig, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
    """The reference's leaves and distributions: norms ones, ``in_proj``
    and ``out_proj`` N(0, 1/fan_in), ``conv_w`` N(0, 0.25), ``A_log`` 0
    (A = -1), ``D`` 1, ``dt_bias`` -1."""
    d, dt, dev = cfg.d_model, cfg.param_dtype, generator.device
    d_in, _, h, _, conv_ch, d_proj = _mamba_dims(cfg)
    return {"ln": NN.init_norm(d, dt, dev),
            "in_proj": NN._dense((d, d_proj), dt, generator),
            "conv_w": NN._dense((cfg.ssm_conv, conv_ch), dt, generator,
                                scale=0.5),
            "A_log": torch.zeros((h,), dtype=dt, device=dev),
            "D": torch.ones((h,), dtype=dt, device=dev),
            "dt_bias": torch.full((h,), -1.0, dtype=dt, device=dev),
            "norm": NN.init_norm(d_in, dt, dev),
            "out_proj": NN._dense((d_in, d), dt, generator)}


def mamba_block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    d = cfg.d_model
    d_in, _, _, _, _, d_proj = _mamba_dims(cfg)
    return {"ln": rules.vec(), "in_proj": rules.col(d, d_proj),
            "conv_w": spec(None, None), "A_log": rules.vec(), "D": rules.vec(),
            "dt_bias": rules.vec(), "norm": rules.vec(),
            "out_proj": rules.row(d_in, d)}


def mamba_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, cache=None,
              decode: bool = False):
    """The Mamba2 block. cache: {'conv' (B, K-1, CC), 'ssm' (B, H, N, P)
    fp32} or None. Returns (x + out, new cache or None)."""
    b, s, _ = x.shape
    d_in, n, h, pdim, _, _ = _mamba_dims(cfg)
    dt_ = x.dtype
    hx = NN.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dtp = _mamba_split(hx @ p["in_proj"].to(dt_), cfg)

    xbc, new_conv = causal_depthwise_conv(
        xbc, p["conv_w"], None if cache is None else cache["conv"])
    xbc = NN.silu(xbc)
    xin = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + n]              # (B, S, N), one group
    cmat = xbc[..., d_in + n:]

    dt = F.softplus(dtp.float() + p["dt_bias"].float())          # (B, S, H)
    log_a = -torch.exp(p["A_log"].float()) * dt                  # <= 0
    v = xin.reshape(b, s, h, pdim)
    k = (bmat[:, :, None, :] * dt[..., None].to(dt_)).to(dt_)     # Δ into k
    q = cmat[:, :, None, :].expand(b, s, h, n)

    if decode:
        if s != 1:
            raise ValueError(f"a Mamba decode step takes one token, got {s}")
        y, new_ssm = gla_decode_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0],
                                     cache["ssm"])
        y = y[:, None]
    else:
        y, new_ssm = chunked_gla(
            q, k, v, log_a, chunk=min(cfg.ssm_chunk, s),
            initial_state=None if cache is None else cache["ssm"])
    y = y + v * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = NN.rms_norm(y, p["norm"], cfg.norm_eps) * NN.silu(z)
    out = y @ p["out_proj"].to(dt_)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": new_ssm}
    return x + out, new_cache


class MambaBlock(FrozenTree):
    """One Mamba2 block's frozen leaves (``ln``, ``in_proj``, ``conv_w``,
    ``A_log``, ``D``, ``dt_bias``, ``norm``, ``out_proj``); its forward is
    :func:`mamba_fwd`."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__(init_mamba_block(cfg, generator))
        self.cfg = cfg

    def forward(self, x, *, cache=None, decode: bool = False):
        return mamba_fwd(self, x, self.cfg, cache=cache, decode=decode)


def period_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(periods, trailing Mamba blocks): the shared block runs once a
    period."""
    periods = cfg.num_layers // cfg.attn_every
    return periods, cfg.num_layers - periods * cfg.attn_every


class Hybrid(nn.Module):
    """Parameters drawn from ``generator`` on its device in the
    reference's distributions: the embedding N(0, 0.02^2), the Mamba
    blocks (``init_mamba_block``), the shared block as
    ``transformer.Block`` draws it, the final norm ones and the untied head
    (padded_vocab, d) N(0, 1/padded_vocab)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family != "hybrid" or cfg.attn_every <= 0 or \
                cfg.attn_kind != "gqa" or cfg.moe_num_experts or \
                cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.arch}: the hybrid takes GQA shared attention every "
                f"attn_every > 0 Mamba blocks, no experts and no frontend")
        self.cfg = cfg
        dev = generator.device
        self.embed = _frozen(NN.init_embed(cfg, generator))
        self.mamba = nn.ModuleList(MambaBlock(cfg, generator)
                                   for _ in range(cfg.num_layers))
        self.shared = Block(cfg, generator)
        self.final_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                               dev))
        self.lm_head = _frozen(NN._dense((cfg.padded_vocab, cfg.d_model),
                                         cfg.param_dtype, generator))

    def _period(self, x, first: int, *, rope, mode: str, cache=None,
                attn_slot: int | None = None, pos: int | None = None,
                mesh=None):
        """Mamba blocks ``first`` .. ``first + attn_every - 1`` and, with an
        ``attn_slot``, the shared block; the caches written in place."""
        decode = mode == "decode"
        for i in range(first, first + self.cfg.attn_every):
            x = self._mamba(x, i, cache, decode)
        if attn_slot is not None:
            slot = None if cache is None else \
                {name: t[attn_slot] for name, t in cache["attn"].items()}
            x, _, _ = self.shared(x, rope=rope, mode=mode, cache=slot, pos=pos,
                                  mesh=mesh)
        return x

    def _mamba(self, x, i: int, cache, decode: bool):
        if cache is None:
            return self.mamba[i](x)[0]
        mc = cache["mamba"]
        x, new = self.mamba[i](x, cache={"conv": mc["conv"][i],
                                         "ssm": mc["ssm"][i]}, decode=decode)
        mc["conv"][i] = new["conv"]
        mc["ssm"][i] = new["ssm"]
        return x

    def forward(self, tokens: torch.Tensor, *, embeds=None,
                mode: str = "causal", cache=None, pos: int | None = None,
                mesh=None):
        """Returns (logits (B, S, padded_vocab), cache, aux).

        tokens (B, S); mode 'causal' (prefill, training) or 'decode' (one
        token at ``pos``, a Python int). cache: ``init_hybrid_cache``'s,
        written in place and returned. aux: the zero MoE terms, as the
        reference's dense shared block gives. mesh: the shared block's
        (its decode seq-sharded on a model axis > 1)."""
        if embeds is not None:
            raise NotImplementedError("the hybrid takes no embeds")
        cfg = self.cfg
        x = NN.embed_fwd(self.embed, tokens, cfg)
        s = x.shape[1]
        start = pos if mode == "decode" else 0
        rope = NN.rope_tables(torch.arange(s, device=x.device) + start, cfg.hd,
                              cfg.rope_theta)
        periods, rem = period_counts(cfg)
        remat = remat_context(cfg) if cache is None and \
            torch.is_grad_enabled() and x.requires_grad else None
        for i in range(periods):
            first = i * cfg.attn_every
            if remat is not None:
                x = checkpoint(self._period, x, first, rope=rope, mode=mode,
                               attn_slot=i, mesh=mesh, use_reentrant=False,
                               context_fn=remat)
            else:
                x = self._period(x, first, rope=rope, mode=mode, cache=cache,
                                 attn_slot=i, pos=pos, mesh=mesh)
        for i in range(periods * cfg.attn_every, cfg.num_layers):
            x = self._mamba(x, i, cache, mode == "decode")
        x = NN.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = NN.unembed_fwd(self.lm_head, x, cfg)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        return logits, cache, aux


def init_mamba_cache(cfg: ModelConfig, batch: int, device
                     ) -> dict[str, torch.Tensor]:
    d_in, n, h, pdim, conv_ch, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((batch, h, n, pdim), dtype=torch.float32,
                               device=device)}


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, device
                      ) -> dict[str, dict[str, torch.Tensor]]:
    """{'mamba': {'conv' (L, B, K-1, CC) in cfg.dtype, 'ssm' (L, B, H, N, P)
    fp32}, 'attn': {'k', 'v' each (periods, B, max_len, KV, hd)}}, zeros."""
    periods, _ = period_counts(cfg)
    one = init_mamba_cache(cfg, batch, device)
    attn = NN.init_attn_cache(cfg, batch, max_len, device)
    return {"mamba": {name: t[None].repeat((cfg.num_layers,) + (1,) * t.ndim)
                      for name, t in one.items()},
            "attn": {name: t[None].repeat((periods,) + (1,) * t.ndim)
                     for name, t in attn.items()}}


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, tuple]:
    """{parameter name: spec} of a :class:`Hybrid` (the one shared block
    unstacked, as in the reference)."""
    return {"embed": NN.embed_spec(cfg, rules),
            **per_layer_specs(mamba_block_specs(cfg, rules), "mamba",
                              cfg.num_layers),
            **flat_specs(block_specs(cfg, rules), "shared."),
            "final_norm": rules.vec(),
            "lm_head": rules.embed(cfg.padded_vocab, cfg.d_model)}


def hybrid_cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                       ) -> dict:
    """The Mamba states over the batch axes (the sequence is not a dim of
    theirs), the shared block's KV slots as an attention cache."""
    b, _ = rules.decode_layout(batch, False)
    mamba = {"conv": spec(None, b, None, None),
             "ssm": spec(None, b, None, None, None)}
    attn = stack_layer_specs(NN.attn_cache_specs(cfg, rules, batch))
    return {"mamba": mamba, "attn": attn}
