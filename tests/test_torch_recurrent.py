"""The port's ``models/recurrent.py`` (chunked gated linear attention, its
decode step, the causal depthwise conv, the sLSTM scan and step) against
the JAX package's ``repro/models/recurrent.py``, on the CPU.

The same numpy inputs go through both. fp32 within 1e-5 (the same fp32
math, sums in another order: measured maxima 9.5e-7 for ``chunked_gla``
and the conv, 2.4e-7 for the sLSTM scan, whose log-step scan composes the
pairs in another tree than the reference's associative scan); bf16 within
5e-2, the reference's own serving tolerance for zamba2
(``tests/test_serve.py``; measured 0 for y, 2.4e-7 for the fp32 state).
The decode steps stepped S times equal the chunked form and the sLSTM scan
within 1e-5 (measured 3.6e-7). The
gradient of ``chunked_gla`` equals ``jax.grad`` of the reference's where
the reference's is finite; at a chunk whose summed decay passes ~88 the
reference's gradient is NaN (0 · inf above the diagonal) and the port's
finite, with the same forward.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as JR  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 5e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _gla_inputs(b, s, h, dk, dv, seed, decay=0.3):
    """q, k, v standard normal / sqrt(dk); log_a = -decay * softplus(N)."""
    r = np.random.default_rng(seed)
    q = (r.standard_normal((b, s, h, dk)) / np.sqrt(dk)).astype(np.float32)
    k = (r.standard_normal((b, s, h, dk)) / np.sqrt(dk)).astype(np.float32)
    v = r.standard_normal((b, s, h, dv)).astype(np.float32)
    la = (-decay * np.log1p(np.exp(r.standard_normal((b, s, h))))) \
        .astype(np.float32)
    return q, k, v, la


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# a chunk multiple, a padded S, a non-zero initial state; one bf16 case
GLA_CASES = [("multiple", 32, 8, False, "f32"), ("padded", 29, 8, False, "f32"),
             ("state", 24, 8, True, "f32"), ("one_chunk", 5, 8, True, "f32"),
             ("bf16", 29, 8, True, "bf16")]


@pytest.mark.parametrize("name,s,chunk,with_state,dt", GLA_CASES,
                         ids=[c[0] for c in GLA_CASES])
def test_chunked_gla_matches_reference(name, s, chunk, with_state, dt):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    b, h, dk, dv = 2, 3, 4, 5
    q, k, v, la = _gla_inputs(b, s, h, dk, dv, seed=len(name))
    (jq, jk, jv, _), (tq, tk, tv, _) = _both((q, k, v, la), jdt, tdt)
    jla, tla = jnp.asarray(la), torch.from_numpy(la)
    h0 = np.random.default_rng(9).standard_normal((b, h, dk, dv)) \
        .astype(np.float32) if with_state else None
    jy, jh = jax.jit(functools.partial(JR.chunked_gla, chunk=chunk))(
        jq, jk, jv, jla, initial_state=None if h0 is None else jnp.asarray(h0))
    ty, th = TR.chunked_gla(tq, tk, tv, tla, chunk=chunk, initial_state=(
        None if h0 is None else torch.from_numpy(h0)))
    assert ty.dtype == tdt and th.dtype == torch.float32
    assert ty.shape == (b, s, h, dv) and th.shape == (b, h, dk, dv)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    _close(ty, jy, tol, "y")
    _close(th, jh, tol, "final state")


def test_gla_decode_step_stepped_equals_the_chunked_form_and_reference():
    b, s, h, dk, dv = 2, 13, 3, 4, 5
    q, k, v, la = _gla_inputs(b, s, h, dk, dv, seed=3)
    tq, tk, tv, tla = (torch.from_numpy(a) for a in (q, k, v, la))
    want, want_h = TR.chunked_gla(tq, tk, tv, tla, chunk=4)
    state = torch.zeros((b, h, dk, dv))
    jstate = jnp.zeros((b, h, dk, dv))
    for t in range(s):
        y, state = TR.gla_decode_step(tq[:, t], tk[:, t], tv[:, t], tla[:, t],
                                      state)
        jy, jstate = JR.gla_decode_step(*(jnp.asarray(a[:, t])
                                          for a in (q, k, v, la)), jstate)
        assert float((y - want[:, t]).abs().max()) <= F32_TOL, t
        _close(y, jy, F32_TOL, f"step {t}")
        _close(state, jstate, F32_TOL, f"state {t}")
    assert float((state - want_h).abs().max()) <= F32_TOL


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_depthwise_conv_matches_reference(with_cache):
    r = np.random.default_rng(4)
    b, s, c, kk = 2, 7, 6, 4
    x = r.standard_normal((b, s, c)).astype(np.float32)
    w = r.standard_normal((kk, c)).astype(np.float32)
    cache = r.standard_normal((b, kk - 1, c)).astype(np.float32) \
        if with_cache else None
    jy, jc = JR.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), (
        None if cache is None else jnp.asarray(cache)))
    ty, tc = TR.causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), (
        None if cache is None else torch.from_numpy(cache)))
    _close(ty, jy, F32_TOL, "y")
    _close(tc, jc, 0.0, "the trailing rows, exactly")
    # one token at a time through the cache gives the same outputs
    run = None if cache is None else torch.from_numpy(cache)
    for t in range(s):
        yt, run = TR.causal_depthwise_conv(torch.from_numpy(x[:, t:t + 1]),
                                           torch.from_numpy(w), run)
        assert float((yt[:, 0] - ty[:, t]).abs().max()) <= F32_TOL, t


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 6, 17])
def test_slstm_scan_matches_its_steps_and_reference(s, with_state):
    r = np.random.default_rng(s)
    b, d = 2, 5
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)  # noqa: E731
    i, f = sig(r.standard_normal((b, s, d))), sig(r.standard_normal((b, s, d)) + 2)
    z, o = (r.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    c0 = n0 = None
    if with_state:
        c0 = r.standard_normal((b, d)).astype(np.float32)
        n0 = r.uniform(0.5, 3.0, (b, d)).astype(np.float32)
    jh, (jc, jn) = jax.jit(JR.slstm_scan)(
        *(jnp.asarray(a) for a in (i, f, z, o)),
        c0=None if c0 is None else jnp.asarray(c0),
        n0=None if n0 is None else jnp.asarray(n0))
    tg = [torch.from_numpy(a) for a in (i, f, z, o)]
    th, (tc, tn) = TR.slstm_scan(*tg,
                                 c0=None if c0 is None else torch.from_numpy(c0),
                                 n0=None if n0 is None else torch.from_numpy(n0))
    _close(th, jh, F32_TOL, "h")
    _close(tc, jc, F32_TOL, "c")
    _close(tn, jn, F32_TOL, "n")
    state = (torch.zeros((b, d)), torch.zeros((b, d))) if c0 is None else \
        (torch.from_numpy(c0), torch.from_numpy(n0))
    for t in range(s):
        h, state = TR.slstm_decode_step(*(g[:, t] for g in tg), state)
        assert float((h - th[:, t]).abs().max()) <= F32_TOL, t
    assert float((state[0] - tc).abs().max()) <= F32_TOL
    assert float((state[1] - tn).abs().max()) <= F32_TOL


def _gla_loss_grads(q, k, v, la, chunk):
    """(port loss, port grads, reference loss, reference grads) of
    sum(y * g) for a fixed g."""
    g = np.random.default_rng(1).standard_normal(q.shape[:3] + v.shape[-1:]) \
        .astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, la)]
    y, _ = TR.chunked_gla(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(g)).sum()
    tg = torch.autograd.grad(loss, leaves)

    def jloss(q, k, v, la):
        y, _ = JR.chunked_gla(q, k, v, la, chunk=chunk)
        return jnp.sum(y * g)

    args = [jnp.asarray(a) for a in (q, k, v, la)]
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(*args)
    return loss, tg, jl, jg


def test_chunked_gla_gradient_matches_reference_and_stays_finite_past_it():
    q, k, v, la = _gla_inputs(2, 24, 2, 4, 3, seed=5)
    loss, tg, jl, jg = _gla_loss_grads(q, k, v, la, chunk=8)
    assert abs(float(loss.detach()) - float(jl)) <= F32_TOL * abs(float(jl))
    for name, t, j in zip("q k v log_a".split(), tg, jg):
        scale = max(float(np.abs(_np(j)).max()), 1e-30)
        assert float(np.abs(t.numpy() - _np(j)).max()) <= F32_TOL * scale, name
    # 64 steps of a decay ~2 a step: exp(+128) above the diagonal overflows
    q, k, v, la = _gla_inputs(1, 64, 2, 4, 3, seed=6, decay=3.0)
    assert float(-la.sum(1).min()) > 100
    loss, tg, jl, jg = _gla_loss_grads(q, k, v, la, chunk=64)
    assert abs(float(loss.detach()) - float(jl)) <= F32_TOL * abs(float(jl))
    assert not all(np.isfinite(_np(j)).all() for j in jg)  # the reference's NaN
    assert all(bool(torch.isfinite(t).all()) for t in tg)
