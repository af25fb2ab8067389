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
otherwise. Left for later: the chunked paths for S > 8192.

Seq-sharded decode (flash-decoding, the reference's ``shard_map`` bodies
``_flash_decode_shard`` and ``_mla_flash_decode_shard``): given a mesh
(``core/mesh.NamedMesh``) whose ``model`` axis is larger than 1, and
``cfg.decode_seq_shard`` (GQA) or ``cfg.mla_seq_shard`` (MLA), decode
splits the cache's T rows into the n shards of ``common.decode_layout``'s
sequence axes: a ``(B, n, T/n, ...)`` view of the one cache. Every shard's
softmax statistics ``(m, l, o)`` are computed at once, batched over the
shard axis, and merged by the log-sum-exp reduction through the mesh's
``pmax`` and ``psum``, in the reference's order and rounding. ``T % n !=
0`` raises ``ValueError``: there is no fallback to the plain decode.
Prefill and training never read the mesh: their arithmetic is the same
on any mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    MODEL_AXIS, ModelConfig, ShardingRules, decode_layout, spec)

NEG_INF = -1e30  # the reference's mask value (``_mask_scores``)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dense(shape, dtype, generator: torch.Generator, scale=None) -> torch.Tensor:
    """Normal(0, 1) in fp32 times ``scale`` (1/sqrt(fan_in), fan-in the
    second-to-last dim), cast to ``dtype``, on the generator's device. On
    the ``meta`` device (``factory.build_model(cfg, "meta")``) nothing is
    drawn: an empty tensor of the shape and dtype."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def embed_spec(cfg: ModelConfig, rules: ShardingRules) -> tuple:
    return rules.embed(cfg.padded_vocab, cfg.d_model)


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


def mlp_specs(d: int, d_ff: int, rules: ShardingRules,
              kind: str = "swiglu") -> dict[str, tuple]:
    if kind == "swiglu":
        return {"wi": rules.col(d, d_ff), "wg": rules.col(d, d_ff),
                "wo": rules.row(d_ff, d)}
    return {"wi": rules.col(d, d_ff), "wo": rules.row(d_ff, d)}


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


def attention_specs(cfg: ModelConfig, rules: ShardingRules
                    ) -> dict[str, tuple]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {"wq": rules.col(d, H * hd), "wk": rules.col(d, KV * hd),
            "wv": rules.col(d, KV * hd), "wo": rules.row(H * hd, d)}


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
                  x_kv: torch.Tensor | None = None, mesh=None):
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
    back from the device. mesh: a ``NamedMesh`` or None; 'decode' on a
    mesh of model axis > 1 with ``cfg.decode_seq_shard`` attends through
    :func:`_flash_decode_sharded` (the cache write stays the whole
    cache's).
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
        shards = _seq_shards(mesh, cfg.decode_seq_shard, B,
                             cache["k"].shape[1])
        if shards is not None:
            out = _flash_decode_sharded(
                q.reshape(B, S, KV, H // KV, hd), cache["k"].to(dt),
                cache["v"].to(dt), pos + S, shards)
        else:
            out = _sdpa(q, cache["k"].to(dt), cache["v"].to(dt), causal=True,
                        q_offset=pos, kv_len=pos + S)
    else:
        raise ValueError(f"attention mode {mode!r}")
    return out.reshape(B, S, H * hd) @ p["wo"].to(dt), cache


def _seq_shards(mesh, seq_shard: bool, batch: int, t: int):
    """The one-axis view of the decode's sequence shards, or None where
    the reference decodes unsharded (no mesh, model axis 1, the flag off).
    Raises ``ValueError`` when the cache's ``t`` rows do not split evenly."""
    if mesh is None or not seq_shard or mesh.axis_size(MODEL_AXIS) <= 1:
        return None
    _, seq_axes = decode_layout(mesh.shape, batch, seq_shard)
    view = mesh.view(seq_axes)
    if t % view.axis_size:
        raise ValueError(f"a decode cache of {t} rows does not split into "
                         f"the {view.axis_size} shards of {seq_axes} on a "
                         f"mesh {mesh.shape}")
    return view


def _flash_decode_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: int, shards) -> torch.Tensor:
    """The reference's ``_flash_decode_shard`` over every shard at once.

    q (B, S, KV, G, hd); k, v (B, T, KV, hd), the whole cache, taken as n
    = ``shards.axis_size`` slices of T/n rows (shard i holds global rows
    [i T/n, (i+1) T/n)). Each shard's scores come from the grouped einsum
    (each KV head read once, not repeated to H), in fp32 over sqrt(hd),
    masked at global row >= ``kv_len``; its max m, the sum l of e = exp(s
    - m), and o = e (rounded to q's dtype) times v. The merge: M = pmax(m),
    corr = exp(m - M), l_g = psum(l corr), o_g = psum(o corr) with corr
    rounded to q's dtype, and o_g / l_g in q's dtype -> (B, S, KV * G,
    hd)."""
    b, s, kv, g, hd = q.shape
    t = k.shape[1]
    n = shards.axis_size
    t_loc = t // n
    ks = k.view(b, n, t_loc, kv, hd)
    vs = v.view(b, n, t_loc, kv, hd)
    scores = torch.einsum("bskgh,bntkh->nbkgst", q, ks).float() / math.sqrt(hd)
    tpos = torch.arange(t, device=q.device).view(n, 1, 1, 1, 1, t_loc)
    scores = scores.masked_fill(tpos >= kv_len, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)        # (n, B, KV, G, S, 1)
    e = torch.exp(scores - m)
    l = e.sum(-1, keepdim=True)
    o = torch.einsum("nbkgst,bntkh->nbskgh", e.to(q.dtype), vs)
    big_m = shards.pmax(m)
    corr = torch.exp(m - big_m)
    l_g = shards.psum(l * corr)                         # (B, KV, G, S, 1)
    o_g = shards.psum(o * corr.permute(0, 1, 4, 2, 3, 5).to(q.dtype))
    out = o_g / l_g.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(b, s, kv * g, hd)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    dtype=None) -> dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                     ) -> dict[str, tuple]:
    """One layer's KV cache: batch over the dp axes and the sequence over
    ``model`` (flash-decoding); a small batch at long context puts the
    sequence over every axis."""
    b, seq = rules.decode_layout(batch, cfg.decode_seq_shard)
    return {"k": spec(b, seq, None, None), "v": spec(b, seq, None, None)}


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


def mla_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, tuple]:
    d, H = cfg.d_model, cfg.num_heads
    ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {"w_dq": rules.col(d, ql), "q_norm": rules.vec(),
            "w_uq": rules.col(ql, H * (nd + rd)),
            "w_dkv": spec(None, None), "kv_norm": rules.vec(),
            "w_uk": rules.col(kvl, H * nd), "w_uv": rules.col(kvl, H * vd),
            "wo": rules.row(H * vd, d)}


def mla_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str, rope,
            cache=None, pos: int | None = None, mesh=None):
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
    contiguous for the kernel. On a mesh of model axis > 1 with
    ``cfg.mla_seq_shard``, decode runs :func:`_mla_flash_decode_sharded`
    (the latent caches split on T, the latent context merged across
    shards, W_uv after the merge)."""
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
        w_uk = p["w_uk"].to(dt).reshape(kvl, H, nd)
        q_lat = torch.einsum("bshn,khn->bshk", q_nope, w_uk)  # absorb W_uk
        shards = _seq_shards(mesh, cfg.mla_seq_shard, B,
                             cache["c_kv"].shape[1])
        if shards is not None:
            ctx_lat = _mla_flash_decode_sharded(
                q_lat, q_rope, c_kv, k_rope, cache, pos, scale, shards)
            ctx = torch.einsum("bshk,khv->bshv", ctx_lat,
                               p["w_uv"].to(dt).reshape(kvl, H, vd))
            return ctx.reshape(B, S, H * vd) @ p["wo"].to(dt), cache
        cache["c_kv"][:, pos:pos + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos:pos + S] = k_rope.to(cache["k_rope"].dtype)
        ckv, kr = cache["c_kv"].to(dt), cache["k_rope"].to(dt)
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


def _mla_flash_decode_sharded(q_lat, q_rope, ckv_new, kr_new, cache,
                              pos: int, scale: float, shards) -> torch.Tensor:
    """The reference's ``_mla_flash_decode_shard`` over every shard at once.

    The latent caches ``cache['c_kv']`` (B, T, kv_lora) and
    ``cache['k_rope']`` (B, T, rope) are taken as n = ``shards.axis_size``
    slices of T/n rows. The write lands on one shard: shard i (rows from
    lo = i T/n) takes the new rows at ``pos - lo`` clipped into its slice,
    where 0 <= pos - lo < T/n (the start clamped so that the S rows fit,
    as ``dynamic_update_slice`` clamps it), and every other shard keeps its
    rows; the write is made in place. Scores: the two latent einsums in
    q's dtype, added, then fp32 times ``scale``, masked at global row >=
    pos + 1 (the reference's bound), the shard's (m, l, o) with the
    *latent* c_kv as the value, and the log-sum-exp merge through
    ``pmax``/``psum`` as the GQA merge. Returns the merged latent context
    (B, S, H, kv_lora); W_uv is applied by the caller, after the merge."""
    b, s, h, kvl = q_lat.shape
    dt = q_lat.dtype
    t = cache["c_kv"].shape[1]
    n = shards.axis_size
    t_loc = t // n
    views = {name: cache[name].view(b, n, t_loc, cache[name].shape[-1])
             for name in ("c_kv", "k_rope")}
    for idx in range(n):
        lp = pos - idx * t_loc
        if 0 <= lp < t_loc:
            at = min(lp, t_loc - s)
            views["c_kv"][:, idx, at:at + s] = ckv_new.to(cache["c_kv"].dtype)
            views["k_rope"][:, idx, at:at + s] = kr_new.to(cache["k_rope"].dtype)
    ckv, kr = views["c_kv"].to(dt), views["k_rope"].to(dt)
    scores = (torch.einsum("bshk,bntk->nbhst", q_lat, ckv) +
              torch.einsum("bshr,bntr->nbhst", q_rope, kr))
    scores = scores.float() * scale
    tpos = torch.arange(t, device=q_lat.device).view(n, 1, 1, 1, t_loc)
    scores = scores.masked_fill(tpos >= pos + 1, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)        # (n, B, H, S, 1)
    e = torch.exp(scores - m)
    l = e.sum(-1, keepdim=True)
    o = torch.einsum("nbhst,bntk->nbshk", e.to(dt), ckv)
    big_m = shards.pmax(m)
    corr = torch.exp(m - big_m)
    l_g = shards.psum(l * corr)                         # (B, H, S, 1)
    o_g = shards.psum(o * corr.permute(0, 1, 3, 2, 4).to(dt))
    return o_g / l_g.permute(0, 2, 1, 3).to(dt)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=None) -> dict[str, torch.Tensor]:
    dtype = dtype or cfg.dtype
    return {"c_kv": torch.zeros((batch, max_len, cfg.mla_kv_lora),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.mla_rope_dim),
                                  dtype=dtype, device=device)}


def mla_cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                    ) -> dict[str, tuple]:
    b, seq = rules.decode_layout(batch, cfg.mla_seq_shard)
    return {"c_kv": spec(b, seq, None), "k_rope": spec(b, seq, None)}
