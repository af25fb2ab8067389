"""Chunked gated linear attention (the engine of Mamba2's SSD form and of
xLSTM's mLSTM), the sLSTM scan and the causal depthwise conv: the port of
``repro/models/recurrent.py``, plain PyTorch.

Per head, the GLA computes

    y_t = q_t · h_t,   h_t = a_t * h_{t-1} + k_t v_tᵀ,   a_t = exp(log_a_t)

chunkwise: within a chunk of Q steps a dense Q×Q decay-weighted masked
product, across chunks a recurrence over the (K, V) state, S/Q steps of
it in a Python loop. The roundings are the reference's: the score and
``y_intra`` products in the activation dtype, the decay, the per-chunk
states and the inter-chunk terms in fp32. The reference's
``time_unroll`` (unroll the chunk loop so its cost model sees every
chunk) would change nothing here: the loop runs eagerly, chunk by chunk,
so ``chunked_gla`` has no ``unroll`` argument.

One departure, in the gradient only: the reference takes
``exp(cum_t - cum_s)`` over the whole Q×Q square and masks the product
after it. Above the diagonal that exponent is positive and, once a chunk's
summed decay passes ~88 (zamba2's chunk of 256 at its random-weight Δ),
overflows to inf; the forward masks it to 0, but its gradient is
0 · inf = NaN. The port sets the exponent to -inf above the diagonal
before the exp: the same values where the mask keeps them, 0 where it does
not, and a gradient that stays finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along dim 1."""
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, *, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Gated linear attention, chunkwise-parallel.

    q, k (B, S, H, K); v (B, S, H, V); log_a (B, S, H) with log_a <= 0.
    Returns (y (B, S, H, V) in q's dtype, final state (B, H, K, V) fp32).
    S is padded to a chunk multiple with zero rows (k = 0 rows add nothing
    to the state, log_a = 0 keeps it) and the padding cut from y.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        y, h_final = chunked_gla(_pad_time(q, pad), _pad_time(k, pad),
                                 _pad_time(v, pad), _pad_time(log_a, pad),
                                 chunk=chunk, initial_state=initial_state)
        return y[:, :s], h_final
    nc, cq = s // chunk, chunk
    dt = q.dtype

    qc = q.reshape(b, nc, cq, h, dk)
    kc = k.reshape(b, nc, cq, h, dk)
    vc = v.reshape(b, nc, cq, h, dv)
    cum = torch.cumsum(log_a.reshape(b, nc, cq, h).float(), dim=2)
    total = cum[:, :, -1, :]                              # (B, NC, H)

    # intra-chunk: w[t, s] = (q_t · k_s) exp(cum_t - cum_s) for s <= t
    scores = torch.einsum("bnqhk,bnshk->bnhqs", qc, kc).float()
    ct = cum.transpose(2, 3)                              # (B, NC, H, Q)
    mask = torch.tril(torch.ones((cq, cq), dtype=torch.bool, device=q.device))
    diff = torch.where(mask, ct[..., :, None] - ct[..., None, :],
                       float("-inf"))
    w = scores * torch.exp(diff)
    y_intra = torch.einsum("bnhqs,bnshv->bnqhv", w.to(dt), vc)

    # each chunk's state contribution, S_n = sum_s exp(total_n - cum_s) k_s v_sᵀ
    kd = kc.float() * torch.exp(total[:, :, None] - cum)[..., None]
    s_chunk = torch.einsum("bnshk,bnshv->bnhkv", kd, vc.float())

    h_prev = initial_state if initial_state is not None else \
        torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for n in range(nc):
        qd = qc[:, n].float() * torch.exp(cum[:, n])[..., None]
        ys.append(torch.einsum("bqhk,bhkv->bqhv", qd, h_prev))
        h_prev = torch.exp(total[:, n])[..., None, None] * h_prev + s_chunk[:, n]
    y_inter = torch.stack(ys, 1).reshape(b, s, h, dv)
    y = y_intra.reshape(b, s, h, dv) + y_inter.to(dt)
    return y, h_prev


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_a: torch.Tensor, state: torch.Tensor):
    """One recurrent step. q, k (B, H, K), v (B, H, V), log_a (B, H),
    state (B, H, K, V) fp32. Returns (y (B, H, V) in q's dtype, new state)."""
    a = torch.exp(log_a.float())[..., None, None]
    new_state = a * state + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", q.float(), new_state)
    return y.to(q.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM: the scalar-memory recurrence
# ---------------------------------------------------------------------------


def slstm_scan(i: torch.Tensor, f: torch.Tensor, z: torch.Tensor,
               o: torch.Tensor, c0: torch.Tensor | None = None,
               n0: torch.Tensor | None = None):
    """The stabilised scalar LSTM recurrence, parallel over time:

        c_t = f_t c_{t-1} + i_t z_t,   n_t = f_t n_{t-1} + i_t,
        h_t = o_t c_t / max(n_t, 1)

    i, f in (0, 1), z, o (B, S, D). The two linear recurrences run as one
    log-step (Hillis-Steele) inclusive scan over the stacked (c, n) pair
    with the reference's combine, (a1, u1) then (a2, u2) -> (a1 a2,
    a2 u1 + u2), in fp32; the reference's associative scan composes the
    same elements in another tree, so the two agree to fp32 rounding.
    Returns (h (B, S, D) in i's dtype, (c_S, n_S) each (B, D) fp32)."""
    s = i.shape[1]
    ff = f.float()
    ii = i.float()
    a = torch.stack([ff, ff], 0)                          # (2, B, S, D)
    u = torch.stack([ii * z.float(), ii], 0)
    if c0 is not None:  # the initial state folded into the first input
        u = u.clone()
        u[:, :, 0, :] += a[:, :, 0, :] * torch.stack([c0, n0], 0).float()
    d = 1
    while d < s:
        a_prev, u_prev = a[:, :, :-d], u[:, :, :-d]
        a_cur, u_cur = a[:, :, d:], u[:, :, d:]
        u = torch.cat([u[:, :, :d], a_cur * u_prev + u_cur], 2)
        a = torch.cat([a[:, :, :d], a_prev * a_cur], 2)
        d *= 2
    c, n = u[0], u[1]
    h = o.float() * c / torch.clamp(n, min=1.0)
    return h.to(i.dtype), (c[:, -1], n[:, -1])


def slstm_decode_step(i, f, z, o, state):
    """One sLSTM step. Gates (B, D); state (c, n) each (B, D) fp32."""
    c, n = state
    ii, ff = i.float(), f.float()
    c = ff * c + ii * z.float()
    n = ff * n + ii
    h = o.float() * c / torch.clamp(n, min=1.0)
    return h.to(i.dtype), (c, n)


# ---------------------------------------------------------------------------
# causal depthwise conv (Mamba2's and mLSTM's short conv)
# ---------------------------------------------------------------------------


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          cache: torch.Tensor | None = None):
    """x (B, S, C), w (K, C): a depthwise causal conv in x's dtype.

    ``cache`` (B, K-1, C) holds the trailing rows of the previous call
    (decode); zeros without one. Returns (y (B, S, C), new cache (B, K-1,
    C)): the K taps added in order, as the reference's unrolled adds."""
    b, s, c = x.shape
    kk = w.shape[0]
    head = torch.zeros((b, kk - 1, c), dtype=x.dtype, device=x.device) \
        if cache is None else cache.to(x.dtype)
    xp = torch.cat([head, x], 1)
    y = torch.zeros_like(x)
    for j in range(kk):
        y = y + xp[:, j:j + s, :] * w[j].to(x.dtype)
    return y, xp[:, xp.shape[1] - (kk - 1):, :]
