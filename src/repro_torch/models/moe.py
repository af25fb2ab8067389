"""Mixture-of-Experts layer of the port (``repro/models/moe.py``): expert
dispatch is the relational shuffle.

Tokens are routed (the router's top-k) and packed into equal-capacity
per-expert buckets by ``core/repartition.pack_by_partition``, the packing
the relational shuffle uses (its ``bucket_histogram`` kernel counts the
experts' tokens on the card), run through their experts' SwiGLU, and
scattered back. Overflow past a bucket's capacity is dropped and counted
(``moe_dropped``), as the shuffle counts bucket overflow.

Three paths, chosen as the reference's ``moe_fwd`` chooses them:

- local (no mesh, one shard, ``ep_shuffle`` off or ``layout == "fsdp"``):
  one pack over all tokens, no collective. The model on one card runs
  this one.
- expert parallel (``_shuffle_body``): over a
  :class:`~repro_torch.core.mesh.VirtualMesh` as the model axis, the
  sequence split into its shards; each shard routes and packs its own
  tokens, the buckets ride ``staged_all_to_all`` to the shard holding
  their experts and back.
- decode psum (``_psum_body``, when the sequence does not split): each
  shard runs its own experts over every token and the shards' outputs are
  summed.

Capacities come from shapes (Python ints) and the aux values stay tensors
on the device: a forward reads nothing back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.mesh import VirtualMesh, issued
from repro_torch.core.repartition import pack_by_partition, staged_all_to_all
from repro_torch.core.stats import pick_stages
from repro_torch.models.common import ModelConfig, ShardingRules, spec
from repro_torch.models.layers import _dense, mlp_fwd, silu
from repro_torch.utils import ceil_div, round_up

ROUTED = ("router", "wi", "wg", "wo")


def padded_experts(cfg: ModelConfig, model_size: int) -> int:
    """Experts padded up so the model axis divides them (qwen2: 60 -> 64 on
    16 shards; 60 on one)."""
    return round_up(cfg.moe_num_experts, max(model_size, 1))


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             model_size: int = 1) -> dict:
    """The router ``(d, moe_num_experts)`` in fp32 whatever ``param_dtype``
    is; ``wi``/``wg`` ``(e_pad, d, ff)`` and ``wo`` ``(e_pad, ff, d)``, each
    N(0, 1/fan_in) over its second-to-last dim; with ``moe_num_shared``, a
    plain SwiGLU ``shared`` of width ``moe_num_shared * moe_d_ff``."""
    d, ff, dt = cfg.d_model, cfg.moe_d_ff, cfg.param_dtype
    e_pad = padded_experts(cfg, model_size)
    p = {"router": _dense((d, cfg.moe_num_experts), torch.float32, generator),
         "wi": _dense((e_pad, d, ff), dt, generator),
         "wg": _dense((e_pad, d, ff), dt, generator),
         "wo": _dense((e_pad, ff, d), dt, generator)}
    if cfg.moe_num_shared:
        sh_ff = cfg.moe_num_shared * ff
        p["shared"] = {"wi": _dense((d, sh_ff), dt, generator),
                       "wg": _dense((d, sh_ff), dt, generator),
                       "wo": _dense((sh_ff, d), dt, generator)}
    return p


def moe_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    """The router replicated, the experts over ``model`` (EP), the shared
    expert Megatron-paired, as ``init_moe``'s tree."""
    d, ff = cfg.d_model, cfg.moe_d_ff
    e_pad = padded_experts(cfg, rules.model)
    s = {"router": spec(None, None),
         "wi": rules.expert_col(e_pad, d, ff),
         "wg": rules.expert_col(e_pad, d, ff),
         "wo": rules.expert_row(e_pad, ff, d)}
    if cfg.moe_num_shared:
        sh_ff = cfg.moe_num_shared * ff
        s["shared"] = {"wi": rules.col(d, sh_ff), "wg": rules.col(d, sh_ff),
                       "wo": rules.row(sh_ff, d)}
    return s


def _route(router_w: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """Top-k experts, their combine weights and the load-balance aux.

    fp32 logits and softmax; the k largest probabilities in
    ``jax.lax.top_k``'s order (descending, the lower expert first on a tie:
    a stable descending sort); then :func:`routed`."""
    probs = router_probs(router_w, xt)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return routed(probs, idx[:, :cfg.moe_top_k], cfg)


def router_probs(router_w: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """(T, E) fp32 softmax of the fp32 product of the tokens and router."""
    return torch.softmax(xt.float() @ router_w.float(), dim=-1)


def routed(probs: torch.Tensor, topi: torch.Tensor, cfg: ModelConfig):
    """(topi, topw, aux) of the routes ``topi`` (T, k): the chosen
    probabilities normalised by their clamped sum, and the aux ``E * sum_e
    frac_tokens_e * frac_probs_e`` (switch style), frac_tokens a
    scatter-add of ``1 / (t * k)`` at every chosen expert."""
    topw = probs.gather(1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    e = cfg.moe_num_experts
    flat = topi.reshape(-1)
    frac_tokens = torch.zeros(e, dtype=torch.float32, device=probs.device) \
        .index_add_(0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                                        dtype=torch.float32,
                                        device=probs.device))
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return topi, topw, aux


def _expert_ffn(wi, wg, wo, toks: torch.Tensor) -> torch.Tensor:
    """(E_loc, C, d) tokens through per-expert SwiGLU (SiLU rounded as the
    reference's, ``layers.silu``), the weights cast to the tokens' dtype."""
    dt = toks.dtype
    h = torch.bmm(toks, wi.to(dt))
    g = torch.bmm(toks, wg.to(dt))
    return torch.bmm(silu(g) * h, wo.to(dt))


def _bucket_capacity(tokens: int, e_pad: int, cfg: ModelConfig) -> int:
    c = ceil_div(int(tokens * cfg.moe_top_k * cfg.moe_capacity_factor), e_pad)
    return max(8, round_up(c, 8))


def _slots(xt: torch.Tensor, send_idx: torch.Tensor, k: int) -> torch.Tensor:
    """(E, cap, d): each slot's token (row ``send_idx // k`` of xt), zeros in
    vacant slots."""
    t = xt.shape[0]
    tok = torch.clamp(torch.div(send_idx, k, rounding_mode="floor"), 0, t - 1)
    return torch.where((send_idx >= 0)[..., None], xt[tok],
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _combine(back: torch.Tensor, send_idx: torch.Tensor, topw: torch.Tensor,
             t: int, k: int) -> torch.Tensor:
    """Processed slots (E, cap, d) back to their (t * k) entries, weighted
    and summed over the k choices -> (t, d).

    The reference's scatter with ``mode="drop"`` sends every vacant slot to
    index t * k: here they land in one extra row of a (t * k + 1, d) buffer
    that is dropped (``index_copy``; only that row sees duplicate indices,
    so only it could take another value on another run). The bf16
    products of outputs and weights are summed over k in fp32, as the
    reference's ``jnp.sum`` accumulates."""
    d = back.shape[-1]
    dest = torch.where(send_idx >= 0, send_idx, t * k).reshape(-1)
    flat = torch.zeros((t * k + 1, d), dtype=back.dtype, device=back.device) \
        .index_copy(0, dest, back.reshape(-1, d))[:t * k]
    prod = flat.reshape(t, k, d) * topw[..., None].to(back.dtype)
    return prod.sum(1, dtype=torch.float32).to(back.dtype)


def _dispatch(router_w, xt: torch.Tensor, cfg: ModelConfig, e_pad: int,
              cap: int):
    """Route one shard's tokens and pack them: (buf (E, cap, d), send_idx,
    hist, topw, aux)."""
    topi, topw, aux = _route(router_w, xt, cfg)
    flat_e = topi.reshape(-1).to(torch.int32)
    send_idx, hist = pack_by_partition(flat_e, e_pad, cap)  # (E, cap)
    return _slots(xt, send_idx, cfg.moe_top_k), send_idx, hist, topw, aux


def _dropped(hist: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.clamp(hist - cap, min=0).sum().float()


def _dispatch_compute_combine(p, xt: torch.Tensor, cfg: ModelConfig,
                              e_pad: int):
    """The local path: route, pack, the experts, scatter back, combine.
    xt (T, d) -> (y (T, d), {"moe_aux", "moe_dropped"})."""
    t = xt.shape[0]
    cap = _bucket_capacity(t, e_pad, cfg)
    buf, send_idx, hist, topw, aux = _dispatch(p["router"], xt, cfg, e_pad, cap)
    back = _expert_ffn(p["wi"], p["wg"], p["wo"], buf)
    y = _combine(back, send_idx, topw, t, cfg.moe_top_k)
    return y, {"moe_aux": aux, "moe_dropped": _dropped(hist, cap)}


def _shuffle_body(p, x: torch.Tensor, *, cfg: ModelConfig, e_pad: int,
                  mesh: VirtualMesh):
    """Expert parallelism over ``mesh`` (the model axis): x (B, S, d) split
    along S into its m shards, each routing and packing its B * S/m
    tokens. Shard i's buckets of the experts shard j holds (e_loc = e_pad /
    m of them) are stacked as ``(m_src, m_dst, e_loc * cap, d)`` and
    exchanged by ``staged_all_to_all``; shard j runs its experts over what
    every shard sent, and the outputs ride the same exchange back. The aux
    values are the mean over the shards (the reference's ``pmean``)."""
    b, s, d = x.shape
    m = mesh.axis_size
    s_loc, e_loc, k = s // m, e_pad // m, cfg.moe_top_k
    t = b * s_loc
    cap = _bucket_capacity(t, e_pad, cfg)
    shards = [x[:, i * s_loc:(i + 1) * s_loc].reshape(t, d) for i in range(m)]
    packed = [_dispatch(p["router"], xt, cfg, e_pad, cap) for xt in shards]
    send = torch.stack([buf.reshape(m, e_loc * cap, d)
                        for buf, *_ in packed])
    stages = cfg.moe_shuffle_stages
    if stages is None:
        stages = pick_stages(m * m * e_loc * cap * d * send.element_size(),
                             e_loc * cap)
    recv = staged_all_to_all(send, mesh, stages=stages,
                             shuffle_mode=cfg.moe_shuffle_mode)
    outs = []
    for j in range(m):  # (m_src, e_loc*cap, d) -> (e_loc, m_src*cap, d)
        lo = j * e_loc
        toks = recv[j].reshape(m, e_loc, cap, d).transpose(0, 1) \
            .reshape(e_loc, m * cap, d)
        out = _expert_ffn(p["wi"][lo:lo + e_loc], p["wg"][lo:lo + e_loc],
                          p["wo"][lo:lo + e_loc], toks)
        outs.append(out.reshape(e_loc, m, cap, d).transpose(0, 1)
                    .reshape(m, e_loc * cap, d))
    back = staged_all_to_all(torch.stack(outs), mesh, stages=stages,
                             shuffle_mode=cfg.moe_shuffle_mode)
    ys, auxes, drops = [], [], []
    for i, (_, send_idx, hist, topw, aux) in enumerate(packed):
        y = _combine(back[i].reshape(e_pad, cap, d), send_idx, topw, t, k)
        ys.append(y.reshape(b, s_loc, d))
        auxes.append(aux)
        drops.append(_dropped(hist, cap))
    return torch.cat(ys, 1), {"moe_aux": sum(auxes) / m,
                              "moe_dropped": sum(drops) / m}


def _psum_body(p, x: torch.Tensor, *, cfg: ModelConfig, e_pad: int,
               mesh: VirtualMesh):
    """The decode path over ``mesh``: every shard takes all B * S tokens
    and only its own e_loc experts (other experts' ids set to -1, capacity
    ``max(8, round_up(t * k, 8))``: no drops), and the shards' outputs are
    summed in shard order (the reference's ``psum``). The router is
    replicated, so every shard's routes are the one computed here."""
    b, s, d = x.shape
    t, k, m = b * s, cfg.moe_top_k, mesh.axis_size
    e_loc = e_pad // m
    xt = x.reshape(t, d)
    topi, topw, aux = _route(p["router"], xt, cfg)
    flat = topi.reshape(t * k).to(torch.int32)
    cap = max(8, round_up(t * k, 8))
    y = None
    for shard in range(m):
        lo = mesh.axis_index(shard) * e_loc
        local = flat - lo
        local = torch.where((local >= 0) & (local < e_loc), local, -1)
        send_idx, _ = pack_by_partition(local, e_loc, cap)
        out = _expert_ffn(p["wi"][lo:lo + e_loc], p["wg"][lo:lo + e_loc],
                          p["wo"][lo:lo + e_loc], _slots(xt, send_idx, k))
        part = _combine(out, send_idx, topw, t, k)
        # the reference's psum, in shard order: one collective told to a
        # step counter (``roofline.analysis.StepCost``) with the first
        # shard, not to ``mesh.counts``; its adds are the collective's
        first = y is None
        with issued("psum", m * part.numel() * part.element_size()
                    if first else 0, count=int(first)):
            y = part if first else y + part
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.reshape(b, s, d), {"moe_aux": aux, "moe_dropped": zero}


def moe_fwd(p, x: torch.Tensor, cfg: ModelConfig,
            mesh: VirtualMesh | None = None):
    """MoE layer forward. x (B, S, d) -> (y (B, S, d), {"moe_aux",
    "moe_dropped"}: fp32 scalar tensors). ``p``: ``init_moe``'s tree (any
    mapping of its names); ``mesh``: the model axis, or None (one card)."""
    b, s, d = x.shape
    m = mesh.axis_size if mesh is not None else 1
    e_pad = padded_experts(cfg, m)
    if p["wi"].shape[0] != e_pad:
        raise ValueError(f"{p['wi'].shape[0]} experts' weights, padded for "
                         f"another model axis than this one of {m} "
                         f"({e_pad} experts)")
    routed = {name: p[name] for name in ROUTED}
    if mesh is None or m == 1 or not cfg.ep_shuffle or cfg.layout == "fsdp":
        y, aux = _dispatch_compute_combine(routed, x.reshape(b * s, d), cfg,
                                           e_pad)
        y = y.reshape(b, s, d)
    elif s % m == 0 and s >= m:
        y, aux = _shuffle_body(routed, x, cfg=cfg, e_pad=e_pad, mesh=mesh)
    else:  # decode (S == 1): psum over the shards' local experts
        y, aux = _psum_body(routed, x, cfg=cfg, e_pad=e_pad, mesh=mesh)
    if cfg.moe_num_shared:
        y = y + mlp_fwd(p["shared"], x)
    return y, aux
