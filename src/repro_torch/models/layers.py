"""Shared neural layers of the port (``repro/models/layers.py``): init
helpers, RMSNorm and LayerNorm, RoPE, embeddings, the activations as the
reference rounds them, the SwiGLU/GELU MLP, GQA attention (self and cross)
and MLA (multi-head latent attention, minicpm3-4b's).

Layers are functional, as in the reference: ``init_*`` returns a dict of
tensors (weights in the reference's ``(in, out)`` layout, applied as
``x @ w``), ``*_fwd`` consumes it; ``models/transformer.py`` holds them in
``nn.Module``s. Compute runs in ``cfg.dtype`` with fp32 statistics and
softmax, in the reference's order of operations and rounding points.

Attention modes: ``causal`` / ``bidir`` (prefill: self-attention with
S == T, through the flash kernel behind ``kernels/ops.attention``),
``decode`` (one new token against the KV cache, the reference's masked
einsum math in plain torch) and ``cross`` / ``cross_decode``. MLA:
prefill and training materialise per-head K and V (q k over nope + rope, p v over the value width) and run
the same flash kernel; decode is the reference's absorbed attention over
the latent cache, in plain torch. The cross modes (the encoder-decoder's)
attend over the encoder's K and V without a mask: the flash kernel where
the queries are as many as the encoder's rows, the plain einsums
otherwise. Left for later: the chunked paths for S > 8192 and the
multi-device flash-decode (GQA's and MLA's ``mla_seq_shard``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig

NEG_INF = -1e30  # the reference's mask value (``_mask_scores``)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dense(shape, dtype, generator: torch.Generator, scale=None) -> torch.Tensor:
    """Normal(0, 1) in fp32 times ``scale`` (1/sqrt(fan_in), fan-in the
    second-to-last dim), cast to ``dtype``, on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def init_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: the mean square accumulated in fp32, ``rsqrt`` in fp32 then
    cast to x's dtype, ``x * inv * scale`` in x's dtype."""
    xf = x.float()
    ms = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv[..., None] * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """LayerNorm at the reference's rounding points: the mean and the mean
    square from fp32-accumulated sums, ``var = max(ms - mu^2, 0)`` and
    ``rsqrt`` in fp32, ``mu`` and ``inv`` rounded to x's dtype, then
    ``(x - mu) * inv * scale (+ bias)`` in x's dtype (``F.layer_norm``
    takes a two-pass variance and rounds once)."""
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1) / d
    ms = (xf * xf).sum(-1) / d
    inv = torch.rsqrt(torch.clamp(ms - mu * mu, min=0.0) + eps)
    y = (x - mu.to(x.dtype)[..., None]) * inv.to(x.dtype)[..., None] * \
        scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# RoPE (llama half-split convention)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (S,) -> (sin, cos) each (S, dim/2), fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    # a Python-float base: fp32 pow on the device, no host-to-device copy
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); sin/cos (S, hd/2). fp32 arithmetic, cast back."""
    dt = x.dtype
    x = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(cfg: ModelConfig, generator: torch.Generator) -> torch.Tensor:
    return _dense((cfg.padded_vocab, cfg.d_model), cfg.param_dtype, generator,
                  scale=0.02)


def embed_fwd(table: torch.Tensor, tokens: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    return table.to(cfg.dtype)[tokens]


def unembed_fwd(table: torch.Tensor, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V) against a (V, d) table."""
    return x @ table.to(cfg.dtype).t()


# ---------------------------------------------------------------------------
# activations, as the reference's jaxprs round them
# ---------------------------------------------------------------------------


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid``'s ``logistic``: forward 1 / (1 + exp(-x)) as XLA
    lowers it, each op rounded to x's dtype; backward g * (s * (1 - s)),
    its JVP rule's order of operations (autograd through the forward's
    ops rounds elsewhere)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference rounds it. Below fp32
    (``_Logistic``): the same bits forward and backward in bf16, where
    ``torch.sigmoid``, which rounds once, differs on about a third of the
    values. In fp32 a rounding per op is 2^-24 and XLA's exp is within an
    ulp of exact: ``torch.sigmoid`` comes closer to it (0.4% of values an
    ulp apart) than torch's own exp op by op (4%)."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.sigmoid(x)
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), each op rounded to x's dtype
    (``F.silu`` rounds once); in fp32 ``F.silu``, for ``sigmoid``'s
    reason (its gradient, too, is the nearer to the reference's)."""
    if x.dtype in (torch.float32, torch.float64):
        return F.silu(x)
    return x * sigmoid(x)


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu``'s tanh approximation as its jaxpr runs it, op by op in
    x's dtype, its constants first rounded to that dtype: forward
    x * (0.5 * (1 + tanh(c2 * (x + c1 * x^3)))), c1 = 0.044715, c2 =
    sqrt(2/pi); backward the ops of its VJP in their order (tanh's
    derivative as g (1 - t) + g (1 - t) t, x^3's as 3 x^2)."""

    @staticmethod
    def forward(ctx, x):
        c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
        c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype,
                          device=x.device)
        t = torch.tanh(c2 * (x + c1 * (x * x * x)))
        h = 0.5 * (1 + t)
        ctx.save_for_backward(x, t, h, c1, c2)
        return x * h

    @staticmethod
    def backward(ctx, g):
        x, t, h, c1, c2 = ctx.saved_tensors
        o = (0.5 * (g * x)) * (1 - t)
        r = c2 * (o + o * t)
        return (g * h + r) + (c1 * r) * (3 * (x * x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default) as the reference
    rounds it (``_Gelu``): in bf16 the same bits forward and backward
    (``F.gelu(approximate="tanh")`` differs on ~40% of them)."""
    return _Gelu.apply(x)


# ---------------------------------------------------------------------------
# MLP (SwiGLU; GELU via kind='gelu')
# ---------------------------------------------------------------------------


def init_mlp(d: int, d_ff: int, cfg: ModelConfig, generator: torch.Generator,
             kind: str = "swiglu") -> dict[str, torch.Tensor]:
    dt = cfg.param_dtype
    if kind == "swiglu":
        return {"wi": _dense((d, d_ff), dt, generator),
                "wg": _dense((d, d_ff), dt, generator),
                "wo": _dense((d_ff, d), dt, generator)}
    if kind == "gelu":
        return {"wi": _dense((d, d_ff), dt, generator),
                "wo": _dense((d_ff, d), dt, generator)}
    raise ValueError(f"unknown MLP kind {kind!r}")


def mlp_fwd(p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    if "wg" in p:
        h = silu(x @ p["wg"].to(x.dtype)) * h
    else:
        h = gelu(h)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, generator: torch.Generator
                   ) -> dict[str, torch.Tensor]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.param_dtype
    return {"wq": _dense((d, H * hd), dt, generator),
            "wk": _dense((d, KV * hd), dt, generator),
            "wv": _dense((d, KV * hd), dt, generator),
            "wo": _dense((H * hd, d), dt, generator)}


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    b, t, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, g, hd).reshape(b, t, kv * g, hd)


def _mask_scores(scores: torch.Tensor, *, causal: bool, q_offset: int,
                 kv_len: int | None, s: int, t: int) -> torch.Tensor:
    tpos = torch.arange(t, device=scores.device)
    if causal:
        qpos = torch.arange(s, device=scores.device) + q_offset
        scores = scores.masked_fill(tpos[None, :] > qpos[:, None], NEG_INF)
    if kv_len is not None:
        scores = scores.masked_fill(tpos >= kv_len, NEG_INF)
    return scores


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """q (B,S,H,hd), k (B,T,KV,hd), v (B,T,KV,dv) -> (B,S,H,dv). fp32
    softmax; scores scaled by 1/sqrt(hd), q's width (dv differs for MLA).

    Self-attention (S == T, no offset, no kv_len: every prefill) goes
    through ``kernels/ops.attention``, the flash kernel on the card, fp32
    inside, whatever v's width. Otherwise (decode against the cache) the reference's math: KV
    heads repeated to H, scores and probabilities rounded to q's dtype by
    the einsums, masked with -1e30 over the whole cache, fp32 softmax.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if s == t and q_offset == 0 and kv_len is None:
        return kops.attention(q, k, v, causal=causal)
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = _mask_scores(scores / math.sqrt(hd), causal=causal,
                          q_offset=q_offset, kv_len=kv_len, s=s, t=t)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                  rope=None, cache=None, pos: int | None = None,
                  x_kv: torch.Tensor | None = None):
    """GQA attention. Returns (out, cache).

    mode 'causal' | 'bidir' (prefill: self-attention; with a cache, k and
    v are written to its first S rows), 'decode' (k and v written at
    ``pos``, then the new tokens attend over the cache up to ``pos + S``),
    'cross' (K and V projected from ``x_kv`` (B, T, d), the encoder's
    output, and returned as the cache) or 'cross_decode' (K and V read
    from ``cache``, the encoder's). Both cross modes attend without a mask
    over all T rows: through the flash kernel where S == T (the only
    shapes the TPU kernel takes), the plain einsums otherwise. cache:
    {'k', 'v'} each (B, S_max, KV, hd), updated in place by the self modes
    (the reference donates it); pos is a Python int, so nothing is read
    back from the device.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    if mode in ("cross", "cross_decode"):
        if mode == "cross":
            cache = {"k": (x_kv @ p["wk"].to(dt)).reshape(B, -1, KV, hd),
                     "v": (x_kv @ p["wv"].to(dt)).reshape(B, -1, KV, hd)}
        out = _sdpa(q, cache["k"].to(dt), cache["v"].to(dt), causal=False)
        return out.reshape(B, S, H * hd) @ p["wo"].to(dt), cache
    k = (x @ p["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KV, hd)
    if rope is not None:
        sin, cos = rope
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    if mode in ("causal", "bidir"):
        out = _sdpa(q, k, v, causal=(mode == "causal"))
        if cache is not None:  # prefill into a bigger cache
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    elif mode == "decode":
        cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
        out = _sdpa(q, cache["k"].to(dt), cache["v"].to(dt), causal=True,
                    q_offset=pos, kv_len=pos + S)
    else:
        raise ValueError(f"attention mode {mode!r}")
    return out.reshape(B, S, H * hd) @ p["wo"].to(dt), cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    dtype=None) -> dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA attention (minicpm3 / deepseek-style latent KV)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, generator: torch.Generator
             ) -> dict[str, torch.Tensor]:
    """The reference's MLA leaves, in its order and distributions: the
    query's down and up projections with an RMSNorm between, the joint KV
    down projection (latent + the shared rope key) with an RMSNorm on the
    latent, the latent's up projections to per-head k_nope and v, and wo."""
    d, H = cfg.d_model, cfg.num_heads
    ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    dt, dev = cfg.param_dtype, generator.device
    return {"w_dq": _dense((d, ql), dt, generator),
            "q_norm": init_norm(ql, dt, dev),
            "w_uq": _dense((ql, H * (nd + rd)), dt, generator),
            "w_dkv": _dense((d, kvl + rd), dt, generator),
            "kv_norm": init_norm(kvl, dt, dev),
            "w_uk": _dense((kvl, H * nd), dt, generator),
            "w_uv": _dense((kvl, H * vd), dt, generator),
            "wo": _dense((H * vd, d), dt, generator)}


def mla_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str, rope,
            cache=None, pos: int | None = None):
    """MLA (``repro/models/layers.py::mla_fwd``). Returns (out, cache). The
    cache holds the latents, {'c_kv' (B, S_max, kv_lora), 'k_rope' (B,
    S_max, rope_dim)}, updated in place.

    mode 'causal' (prefill, training; the reference's 'prefill' too):
    per-head K = concat(c_kv W_uk, the shared k_rope) and V = c_kv W_uv are
    materialised and go through ``_sdpa`` (the flash kernel, q k over nope
    + rope, p v over the value width, scale 1/sqrt(nope + rope)); with a
    cache, c_kv and k_rope are written to its first S rows. 'decode': the
    reference's absorbed attention, W_uk folded into q (``q_lat``), scores
    over the latent cache (two bf16 einsums added in bf16, then fp32 times
    the scale), masked with -1e30 at ``t >= pos + S`` only (no causal mask
    among the new tokens, as the reference's), an fp32 softmax rounded to
    bf16, the context in latent space, then W_uv. No K or V is
    materialised. The projections are matmuls on the (in, out) weights
    reshaped as the reference's einsums read them, so K and V come out
    contiguous for the kernel."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kvl = cfg.mla_kv_lora
    dt = x.dtype
    sin, cos = rope

    cq = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"].to(dt)).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], sin, cos)

    dkv = x @ p["w_dkv"].to(dt)
    c_kv = rms_norm(dkv[..., :kvl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., kvl:][:, :, None, :], sin, cos)[:, :, 0, :]
    scale = 1.0 / math.sqrt(nd + rd)

    if mode in ("causal", "prefill"):
        k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, nd)
        v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, vd)
        kr = k_rope[:, :, None, :].expand(B, S, H, rd)
        k_full = torch.cat([k_nope, kr], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        ctx = _sdpa(q_full, k_full, v, causal=True)
        if cache is not None:  # prefill into a bigger cache
            cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
    elif mode == "decode":
        cache["c_kv"][:, pos:pos + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos:pos + S] = k_rope.to(cache["k_rope"].dtype)
        ckv, kr = cache["c_kv"].to(dt), cache["k_rope"].to(dt)
        w_uk = p["w_uk"].to(dt).reshape(kvl, H, nd)
        q_lat = torch.einsum("bshn,khn->bshk", q_nope, w_uk)  # absorb W_uk
        scores = (torch.einsum("bshk,btk->bhst", q_lat, ckv) +
                  torch.einsum("bshr,btr->bhst", q_rope, kr))
        scores = scores.float() * scale
        tpos = torch.arange(ckv.shape[1], device=x.device)
        scores = scores.masked_fill(tpos >= pos + S, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx_lat = torch.einsum("bhst,btk->bshk", probs, ckv)
        ctx = torch.einsum("bshk,khv->bshv", ctx_lat,
                           p["w_uv"].to(dt).reshape(kvl, H, vd))
    else:
        raise NotImplementedError(f"MLA mode {mode!r} is not ported")
    return ctx.reshape(B, S, H * vd) @ p["wo"].to(dt), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=None) -> dict[str, torch.Tensor]:
    dtype = dtype or cfg.dtype
    return {"c_kv": torch.zeros((batch, max_len, cfg.mla_kv_lora),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.mla_rope_dim),
                                  dtype=dtype, device=device)}
