"""The xLSTM LM of the port (``repro/models/xlstm.py``): mLSTM (matrix
memory) and sLSTM (scalar memory) blocks.

xlstm-1.3b runs 48 blocks in 6 periods of 7 mLSTM blocks and 1 sLSTM block
(``slstm_every`` 8, the paper's 7:1 ratio), then ``rem`` trailing mLSTM
blocks (0 there). The reference stacks the mLSTM blocks in that order
(period by period, the trailing ones last) and scans over periods; here
``XLSTM.forward`` loops over them in Python, each block an ``nn.Module``
with its own layer's tensors: ``mlstm.<j>`` is the reference's stacked
index j, ``slstm.<i>`` period i's sLSTM. While autograd records
(training), ``remat="full"`` (or ``"dots"``, the matmul outputs kept:
``transformer.remat_context``) runs each period under
``torch.utils.checkpoint``, as the reference's ``_remat(period_body)``;
the trailing blocks run plainly, as in the reference.

The mLSTM block: RMSNorm, ``up`` to (x_inner, z), the causal depthwise
conv and SiLU, block-diagonal per-head q/k projections (v is the
unprojected inner activation), k / sqrt(hd) in the activation dtype, fp32
sigmoid input and forget gates, log a = log(f + 1e-6), the input gate
folded into k, and the chunked GLA (``models/recurrent.py``) with the
normalizer riding as one more value column (hd + 1 wide); then
y / max(|normalizer|, 1), the gated RMSNorm plus the ``skip`` path, times
SiLU(z), ``down`` and the residual. The sLSTM block: four gates from
RMSNorm(x) (sigmoid, sigmoid, tanh, sigmoid), the scan
(``recurrent.slstm_scan``) or its decode step over the fp32 (c, n) state,
an RMSNorm and the residual, then a SwiGLU FFN of width
``round_up(4/3 d, 128)``. Sigmoid and SiLU are rounded as the reference's
jaxpr rounds them (``layers.sigmoid``, ``layers.silu``). As the reference
(its docstring), the gates are sigmoids, not exponential gating with a
running-max stabiliser.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as NN
from repro_torch.models.common import (
    ModelConfig, ShardingRules, per_layer_specs, spec)
from repro_torch.models.recurrent import (
    causal_depthwise_conv, chunked_gla, gla_decode_step, slstm_decode_step,
    slstm_scan)
from repro_torch.models.transformer import (
    AUX_KEYS, FrozenTree, _frozen, remat_context)
from repro_torch.utils import round_up


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(inner width 2 d, heads, head dim)."""
    d_in = 2 * cfg.d_model
    return d_in, cfg.num_heads, d_in // cfg.num_heads


def _slstm_ff(cfg: ModelConfig) -> int:
    return round_up(int(cfg.d_model * 4 / 3), 128)


def xl_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(periods, mLSTM blocks a period, trailing mLSTM blocks)."""
    per = cfg.slstm_every
    periods = cfg.num_layers // per
    return periods, per - 1, cfg.num_layers - periods * per


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm_block(cfg: ModelConfig, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
    """The reference's leaves and distributions: norms and ``skip`` ones,
    matrices N(0, 1/fan_in) (``wq``/``wk`` (H, hd, hd), fan-in hd),
    ``conv_w`` N(0, 0.25), ``b_ig`` 0, ``b_fg`` 3 (open forget gates)."""
    d, dt, dev = cfg.d_model, cfg.param_dtype, generator.device
    d_in, h, hd = _mlstm_dims(cfg)
    return {"ln": NN.init_norm(d, dt, dev),
            "up": NN._dense((d, 2 * d_in), dt, generator),
            "conv_w": NN._dense((cfg.ssm_conv, d_in), dt, generator,
                                scale=0.5),
            "wq": NN._dense((h, hd, hd), dt, generator),
            "wk": NN._dense((h, hd, hd), dt, generator),
            "w_ig": NN._dense((d_in, h), dt, generator),
            "b_ig": torch.zeros((h,), dtype=dt, device=dev),
            "w_fg": NN._dense((d_in, h), dt, generator),
            "b_fg": torch.full((h,), 3.0, dtype=dt, device=dev),
            "gnorm": NN.init_norm(d_in, dt, dev),
            "skip": torch.ones((d_in,), dtype=dt, device=dev),
            "down": NN._dense((d_in, d), dt, generator)}


def mlstm_block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    """The block-diagonal q/k's contraction dim FSDP-sharded (gathered on
    use), as the reference's."""
    d = cfg.d_model
    d_in, _, hd = _mlstm_dims(cfg)
    return {"ln": rules.vec(), "up": rules.col(d, 2 * d_in),
            "conv_w": spec(None, None),
            "wq": spec(None, rules._fs(hd), None),
            "wk": spec(None, rules._fs(hd), None),
            "w_ig": spec(None, None), "b_ig": rules.vec(),
            "w_fg": spec(None, None), "b_fg": rules.vec(),
            "gnorm": rules.vec(), "skip": rules.vec(),
            "down": rules.row(d_in, d)}


def mlstm_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, cache=None,
              decode: bool = False):
    """The mLSTM block. cache: {'conv' (B, K-1, d_in), 'state' (B, H, hd,
    hd + 1) fp32} or None. Returns (x + out, new cache or None)."""
    b, s, _ = x.shape
    d_in, h, hd = _mlstm_dims(cfg)
    dt = x.dtype
    hx = NN.rms_norm(x, p["ln"], cfg.norm_eps)
    ui = hx @ p["up"].to(dt)
    xi, z = ui[..., :d_in], ui[..., d_in:]
    xc, new_conv = causal_depthwise_conv(
        xi, p["conv_w"], None if cache is None else cache["conv"])
    xc = NN.silu(xc)
    xch = xc.reshape(b, s, h, hd)
    q = torch.einsum("bshk,hkj->bshj", xch, p["wq"].to(dt))
    k = torch.einsum("bshk,hkj->bshj", xch, p["wk"].to(dt))
    k = k / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
    v = xi.reshape(b, s, h, hd)
    ig = NN.sigmoid((xi @ p["w_ig"].to(dt)).float() + p["b_ig"].float())
    fg = NN.sigmoid((xi @ p["w_fg"].to(dt)).float() + p["b_fg"].float())
    log_a = torch.log(fg + 1e-6)
    kt = k * ig[..., None].to(dt)                  # the input gate into k
    v_aug = torch.cat([v, torch.ones((b, s, h, 1), dtype=dt,
                                     device=x.device)], -1)
    if decode:
        if s != 1:
            raise ValueError(f"an mLSTM decode step takes one token, got {s}")
        y_aug, new_state = gla_decode_step(q[:, 0], kt[:, 0], v_aug[:, 0],
                                           log_a[:, 0], cache["state"])
        y_aug = y_aug[:, None]
    else:
        y_aug, new_state = chunked_gla(
            q, kt, v_aug, log_a, chunk=min(cfg.ssm_chunk, s),
            initial_state=None if cache is None else cache["state"])
    y, denom = y_aug[..., :hd], y_aug[..., hd:]
    y = y / torch.clamp(denom.float().abs(), min=1.0).to(dt)
    y = y.reshape(b, s, d_in)
    y = NN.rms_norm(y, p["gnorm"], cfg.norm_eps) + xc * p["skip"].to(dt)
    y = y * NN.silu(z)
    out = y @ p["down"].to(dt)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "state": new_state}
    return x + out, new_cache


# ---------------------------------------------------------------------------
# sLSTM block (and its post-up FFN, PF 4/3)
# ---------------------------------------------------------------------------


def init_slstm_block(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's leaves: norms ones, the four gate matrices (d, d)
    N(0, 1/d), ``b_i`` 0, ``b_f`` 3, and a SwiGLU ``mlp``."""
    d, dt, dev = cfg.d_model, cfg.param_dtype, generator.device
    return {"ln": NN.init_norm(d, dt, dev),
            "wi": NN._dense((d, d), dt, generator),
            "wf": NN._dense((d, d), dt, generator),
            "wz": NN._dense((d, d), dt, generator),
            "wo": NN._dense((d, d), dt, generator),
            "b_i": torch.zeros((d,), dtype=dt, device=dev),
            "b_f": torch.full((d,), 3.0, dtype=dt, device=dev),
            "gnorm": NN.init_norm(d, dt, dev),
            "ln2": NN.init_norm(d, dt, dev),
            "mlp": NN.init_mlp(d, _slstm_ff(cfg), cfg, generator)}


def slstm_block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    d = cfg.d_model
    return {"ln": rules.vec(), "wi": rules.col(d, d), "wf": rules.col(d, d),
            "wz": rules.col(d, d), "wo": rules.col(d, d), "b_i": rules.vec(),
            "b_f": rules.vec(), "gnorm": rules.vec(), "ln2": rules.vec(),
            "mlp": NN.mlp_specs(d, _slstm_ff(cfg), rules)}


def slstm_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, cache=None,
              decode: bool = False):
    """The sLSTM block. cache: {'c', 'n'} each (B, d) fp32, or None.
    Returns (x, new cache or None)."""
    s = x.shape[1]
    dt = x.dtype
    hx = NN.rms_norm(x, p["ln"], cfg.norm_eps)
    i = NN.sigmoid(hx @ p["wi"].to(dt) + p["b_i"].to(dt))
    f = NN.sigmoid(hx @ p["wf"].to(dt) + p["b_f"].to(dt))
    z = torch.tanh(hx @ p["wz"].to(dt))
    o = NN.sigmoid(hx @ p["wo"].to(dt))
    if decode:
        if s != 1:
            raise ValueError(f"an sLSTM decode step takes one token, got {s}")
        hs, (c, n) = slstm_decode_step(i[:, 0], f[:, 0], z[:, 0], o[:, 0],
                                       (cache["c"], cache["n"]))
        hs = hs[:, None]
    else:
        hs, (c, n) = slstm_scan(i, f, z, o,
                                None if cache is None else cache["c"],
                                None if cache is None else cache["n"])
    x = x + NN.rms_norm(hs, p["gnorm"], cfg.norm_eps)
    hx = NN.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + NN.mlp_fwd(p["mlp"], hx)
    return x, (None if cache is None else {"c": c, "n": n})


class MLSTMBlock(FrozenTree):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__(init_mlstm_block(cfg, generator))
        self.cfg = cfg

    def forward(self, x, *, cache=None, decode: bool = False):
        return mlstm_fwd(self, x, self.cfg, cache=cache, decode=decode)


class SLSTMBlock(FrozenTree):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__(init_slstm_block(cfg, generator))
        self.cfg = cfg

    def forward(self, x, *, cache=None, decode: bool = False):
        return slstm_fwd(self, x, self.cfg, cache=cache, decode=decode)


# ---------------------------------------------------------------------------
# the network: periods of (slstm_every - 1) mLSTM blocks and 1 sLSTM block
# ---------------------------------------------------------------------------


class XLSTM(nn.Module):
    """Parameters drawn from ``generator`` on its device in the reference's
    distributions: the embedding N(0, 0.02^2), the blocks
    (``init_mlstm_block``, ``init_slstm_block``), the final norm ones and
    the untied head (padded_vocab, d) N(0, 1/padded_vocab)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family != "ssm" or cfg.slstm_every <= 0 or \
                cfg.frontend != "none" or cfg.moe_num_experts:
            raise NotImplementedError(
                f"{cfg.arch}: xLSTM takes slstm_every > 0, no experts and no "
                f"frontend")
        self.cfg = cfg
        dev = generator.device
        periods, m_per, rem = xl_counts(cfg)
        self.embed = _frozen(NN.init_embed(cfg, generator))
        self.mlstm = nn.ModuleList(MLSTMBlock(cfg, generator)
                                   for _ in range(periods * m_per + rem))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, generator)
                                   for _ in range(periods))
        self.final_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                               dev))
        self.lm_head = _frozen(NN._dense((cfg.padded_vocab, cfg.d_model),
                                         cfg.param_dtype, generator))

    def _mlstm(self, x, j: int, cache, decode: bool):
        if cache is None:
            return self.mlstm[j](x)[0]
        mc = cache["mlstm"]
        x, new = self.mlstm[j](x, cache={"conv": mc["conv"][j],
                                         "state": mc["state"][j]},
                               decode=decode)
        mc["conv"][j] = new["conv"]
        mc["state"][j] = new["state"]
        return x

    def _period(self, x, i: int, cache=None, decode: bool = False):
        """Period i: its mLSTM blocks, then its sLSTM block; the caches
        written in place."""
        m_per = self.cfg.slstm_every - 1
        for j in range(i * m_per, (i + 1) * m_per):
            x = self._mlstm(x, j, cache, decode)
        if cache is None:
            return self.slstm[i](x)[0]
        sc = cache["slstm"]
        x, new = self.slstm[i](x, cache={"c": sc["c"][i], "n": sc["n"][i]},
                               decode=decode)
        sc["c"][i] = new["c"]
        sc["n"][i] = new["n"]
        return x

    def forward(self, tokens: torch.Tensor, *, embeds=None,
                mode: str = "causal", cache=None, pos: int | None = None,
                mesh=None):
        """Returns (logits (B, S, padded_vocab), cache, aux).

        tokens (B, S); mode 'causal' (prefill, training) or 'decode' (one
        token; ``pos`` is not needed: the state carries the position).
        cache: ``init_xlstm_cache``'s, written in place and returned. aux:
        the zero MoE terms, as the reference's. ``mesh`` is not read: the
        reference writes no per-shard code for xLSTM."""
        if embeds is not None:
            raise NotImplementedError("xLSTM takes no embeds")
        if mode not in ("causal", "decode"):
            raise ValueError(f"xLSTM mode {mode!r}: 'causal' or 'decode'")
        cfg = self.cfg
        decode = mode == "decode"
        x = NN.embed_fwd(self.embed, tokens, cfg)
        periods, m_per, rem = xl_counts(cfg)
        remat = remat_context(cfg) if cache is None and \
            torch.is_grad_enabled() and x.requires_grad else None
        for i in range(periods):
            if remat is not None:
                x = checkpoint(self._period, x, i, use_reentrant=False,
                               context_fn=remat)
            else:
                x = self._period(x, i, cache, decode)
        for j in range(periods * m_per, periods * m_per + rem):
            x = self._mlstm(x, j, cache, decode)
        x = NN.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = NN.unembed_fwd(self.lm_head, x, cfg)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        return logits, cache, aux


def init_xlstm_cache(cfg: ModelConfig, batch: int, device
                     ) -> dict[str, dict[str, torch.Tensor]]:
    """{'mlstm': {'conv' (n_m, B, K-1, d_in) in cfg.dtype, 'state' (n_m, B,
    H, hd, hd + 1) fp32}, 'slstm': {'c', 'n' each (periods, B, d) fp32}},
    zeros. No dim grows with the sequence."""
    periods, m_per, rem = xl_counts(cfg)
    n_m = periods * m_per + rem
    d_in, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"mlstm": {
                "conv": torch.zeros((n_m, batch, cfg.ssm_conv - 1, d_in),
                                    dtype=cfg.dtype, device=device),
                "state": torch.zeros((n_m, batch, h, hd, hd + 1), dtype=f32,
                                     device=device)},
            "slstm": {name: torch.zeros((periods, batch, cfg.d_model),
                                        dtype=f32, device=device)
                      for name in ("c", "n")}}


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, tuple]:
    """{parameter name: spec} of an :class:`XLSTM`."""
    periods, m_per, rem = xl_counts(cfg)
    return {"embed": NN.embed_spec(cfg, rules),
            **per_layer_specs(mlstm_block_specs(cfg, rules), "mlstm",
                              periods * m_per + rem),
            **per_layer_specs(slstm_block_specs(cfg, rules), "slstm", periods),
            "final_norm": rules.vec(),
            "lm_head": rules.embed(cfg.padded_vocab, cfg.d_model)}


def xlstm_cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                      ) -> dict:
    """Every state over the batch axes; no dim grows with the sequence."""
    b, _ = rules.decode_layout(batch, False)
    return {"mlstm": {"conv": spec(None, b, None, None),
                      "state": spec(None, b, None, None, None)},
            "slstm": {"c": spec(None, b, None), "n": spec(None, b, None)}}
