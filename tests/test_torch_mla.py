"""minicpm3-4b's multi-head latent attention (MLA) on the port, against the
JAX package's, on the CPU.

The same numpy inputs and the same weights (the reference's, carried over
by ``models/convert.py``) go through both, at the reference's TINY config
and at a narrower variant (d_model 32, 2 heads, q k width 16, p v width 8).
The reference runs with ``mesh=None`` through its plain einsum attention.
Tolerances are ``tests/test_torch_models.py``'s: fp32 within 1e-5 (the same
fp32 math, sums in another order), bf16 within 3e-2 (the port's prefill
attention keeps fp32 scores and probabilities where the reference's einsum
rounds them to bf16). The absorbed decode runs the reference's own einsum
math in both, so its bf16 outputs are held within 1e-2, as the GQA decode
is there. Compared: ``mla_fwd``'s prefill (output and the latent cache it
writes) and absorbed decode at several positions; the plain attention with
a p v width apart from q k (``attention_ref``, its log-sum-exp and its
gradient, through the flash wrappers' CPU path and the ``ops.attention``
seam) against ``_sdpa`` and ``jax.grad`` of it; the whole model's logits,
prefill and decode steps, loss, every gradient leaf and a train step; the
parameters, train state and a checkpoint across packages; the launchers.
Then chip_smoke.py's phase 20 and the decode tolerance it states,
rehearsed on the CPU. (The configs field for field are in
``tests/test_torch_models.py``, phase 18's loss tolerance at this arch in
``tests/test_torch_stablelm.py``.)
"""
import functools
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JNN  # noqa: E402
from repro.models.common import ShardingRules  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TNN  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "minicpm3-4b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
DECODE_TOL = {"f32": 1e-5, "bf16": 1e-2}
# the reference's TINY config, and a narrower one (q k 16, p v 8 wide)
VARIANTS = {"tiny": {},
            "narrow": dict(d_model=32, num_heads=2, num_kv_heads=2,
                           d_ff=64, mla_q_lora=16, mla_kv_lora=8,
                           mla_rope_dim=8, mla_nope_dim=8, mla_v_dim=8)}
RULES = ShardingRules({}, False)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, dt, **kw):
    jdt, tdt = DTYPES[dt]
    kw = {**VARIANTS[variant], **kw}
    return (jconfigs.get_tiny(ARCH).replace(dtype=jdt, param_dtype=jdt, **kw),
            tconfigs.get_tiny(ARCH).replace(dtype=tdt, param_dtype=tdt, **kw))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _tokens(b, s, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)) \
        .astype(np.int32)


# --- configs ----------------------------------------------------------------------


def test_mla_with_experts_or_a_frontend_still_raises():
    cfg = tconfigs.get_tiny(ARCH)
    with pytest.raises(NotImplementedError, match="MLA"):
        build_model(cfg.replace(family="moe", moe_num_experts=4, moe_top_k=2,
                                moe_d_ff=32), "cpu")
    with pytest.raises(NotImplementedError):
        build_model(cfg.replace(frontend="vision_stub"), "cpu")


# --- the layer ----------------------------------------------------------------------


def _layer(variant, dt, seed=5):
    jcfg, tcfg = _cfgs(variant, dt)
    p, _ = JNN.init_mla(jax.random.PRNGKey(seed), jcfg, RULES)
    tp = {k: _t(_np(v), DTYPES[dt][1]) for k, v in p.items()}
    return jcfg, tcfg, p, tp


def _ropes(cfg_j, cfg_t, positions):
    pos = np.asarray(positions, np.int32)
    return (JNN.rope_tables(jnp.asarray(pos), cfg_j.mla_rope_dim,
                            cfg_j.rope_theta),
            TNN.rope_tables(torch.from_numpy(pos), cfg_t.mla_rope_dim,
                            cfg_t.rope_theta))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_prefill_writes_the_latent_cache_as_reference(variant, dt):
    jcfg, tcfg, p, tp = _layer(variant, dt)
    jdt, tdt = DTYPES[dt]
    B, S, S_max = 2, 9, 12
    x = np.random.default_rng(6).standard_normal((B, S, jcfg.d_model))
    rope_j, rope_t = _ropes(jcfg, tcfg, range(S))
    jc = JNN.init_mla_cache(jcfg, B, S_max)
    tc = TNN.init_mla_cache(tcfg, B, S_max, "cpu")
    jo, jc = jax.jit(lambda p, x, r, c: JNN.mla_fwd(
        p, x, jcfg, mode="causal", rope=r, cache=c))(
        p, jnp.asarray(x, jdt), rope_j, jc)
    to, tc2 = TNN.mla_fwd(tp, _t(x, tdt), tcfg, mode="causal", rope=rope_t,
                          cache=tc)
    assert tc2 is tc and to.shape == (B, S, jcfg.d_model)
    _close(to, jo, TOL[dt], "prefill out")
    # the latents involve no attention: the same projections and norm
    _close(tc["c_kv"], jc["c_kv"], DECODE_TOL[dt], "c_kv")
    _close(tc["k_rope"], jc["k_rope"], DECODE_TOL[dt], "k_rope")
    assert not tc["c_kv"][:, S:].any() and not tc["k_rope"][:, S:].any()
    # without a cache (training), the same output
    to2, none = TNN.mla_fwd(tp, _t(x, tdt), tcfg, mode="causal", rope=rope_t)
    assert none is None and torch.equal(to2, to)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos,s_new", [(3, 1), (9, 1), (11, 1), (5, 2)])
def test_mla_absorbed_decode_matches_reference(variant, dt, pos, s_new):
    """Decode against a cache holding random latents: the new tokens are
    written at ``pos`` and attend over ``t < pos + S`` (two new tokens see
    each other both ways, as the reference's mask has it)."""
    jcfg, tcfg, p, tp = _layer(variant, dt)
    jdt, tdt = DTYPES[dt]
    B, S_max = 2, 12
    r = np.random.default_rng(7 + pos)
    ckv = r.standard_normal((B, S_max, jcfg.mla_kv_lora))
    kr = r.standard_normal((B, S_max, jcfg.mla_rope_dim))
    x = r.standard_normal((B, s_new, jcfg.d_model))
    jc = {"c_kv": jnp.asarray(ckv, jdt), "k_rope": jnp.asarray(kr, jdt)}
    tc = {"c_kv": _t(ckv, tdt), "k_rope": _t(kr, tdt)}
    rope_j, rope_t = _ropes(jcfg, tcfg, np.arange(s_new) + pos)
    jo, jc = jax.jit(lambda p, x, r, c, q: JNN.mla_fwd(
        p, x, jcfg, mode="decode", rope=r, cache=c, pos=q))(
        p, jnp.asarray(x, jdt), rope_j, jc, jnp.int32(pos))
    to, tc = TNN.mla_fwd(tp, _t(x, tdt), tcfg, mode="decode", rope=rope_t,
                         cache=tc, pos=pos)
    _close(to, jo, DECODE_TOL[dt], "decode out")
    _close(tc["c_kv"], jc["c_kv"], DECODE_TOL[dt], "decode c_kv")
    _close(tc["k_rope"], jc["k_rope"], DECODE_TOL[dt], "decode k_rope")
    with pytest.raises(NotImplementedError, match="mode"):
        TNN.mla_fwd(tp, _t(x, tdt), tcfg, mode="bidir", rope=rope_t)


def test_mla_prefill_runs_the_flash_seam_at_its_width_pair(monkeypatch):
    """Prefill's attention is one ``ops.attention`` call on contiguous
    (B, S, H, nope + rope) q and k and (B, S, H, v) v: the flash kernel's
    input on the card."""
    jcfg, tcfg, _, tp = _layer("tiny", "bf16")
    seen = []
    real = tops.attention

    def spy(q, k, v, *, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), causal,
                     q.is_contiguous() and k.is_contiguous() and
                     v.is_contiguous()))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tops, "attention", spy)
    _, rope_t = _ropes(jcfg, tcfg, range(5))
    x = _t(np.random.default_rng(8).standard_normal((2, 5, 64)),
           torch.bfloat16)
    TNN.mla_fwd(tp, x, tcfg, mode="causal", rope=rope_t)
    assert seen == [((2, 5, 4, 24), (2, 5, 4, 24), (2, 5, 4, 16), True, True)]


# --- the plain attention at two widths --------------------------------------------


def _qkv(b, s, h, kv, dqk, dv, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, dqk)).astype(np.float32),
            r.standard_normal((b, s, kv, dqk)).astype(np.float32),
            r.standard_normal((b, s, kv, dv)).astype(np.float32),
            r.standard_normal((b, s, h, dv)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv,dqk,dv", [(7, 4, 4, 24, 16), (33, 4, 2, 96, 64),
                                           (9, 2, 1, 16, 8)])
def test_plain_attention_with_a_narrower_v_matches_reference(causal, s, h,
                                                            kv, dqk, dv):
    """``attention_ref`` (the flash wrappers' CPU path) against the
    reference's ``_sdpa`` (scale 1/sqrt(q's width)), its log-sum-exp against
    a float64 logsumexp, and the gradient through the wrappers and through
    the ``ops.attention`` seam against ``jax.grad`` of ``_sdpa``, fp32,
    within 1e-5 (of the largest gradient for the gradients)."""
    q, k, v, do = _qkv(2, s, h, kv, dqk, dv, seed=s + dqk)
    want = JNN._sdpa(q, k, v, causal=causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    assert out.shape == (2, s, h, dv)
    _close(out, want, 1e-5)
    _close(fa.flash_attention(tq, tk, tv, causal=causal), want, 1e-5)
    kr = np.repeat(k, h // kv, axis=2).astype(np.float64)
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kr) / math.sqrt(dqk)
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        JNN._sdpa(q, k, v, causal=causal) * do), argnums=(0, 1, 2))(q, k, v)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads)
    plain = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    seam = torch.autograd.grad(tops.attention(*leaves, causal=causal), leaves,
                               tdo)
    for got in (plain, seam, tref.attention_bwd_ref(tq, tk, tv, tdo,
                                                     causal=causal)):
        for a, w in zip(got, grads):
            assert a.shape == np.asarray(w).shape
            assert float(np.abs(a.numpy() - np.asarray(w)).max()) <= 1e-5 * scale


def test_flash_wrappers_check_the_width_pair():
    """v may differ from k in its last dim only; on the CPU any widths take
    the plain version."""
    q, k, v, do = map(torch.from_numpy, _qkv(1, 4, 2, 2, 24, 16, seed=1))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[:, :, :1])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :16], v)
    out, lse = fa.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="fit q"):
        fa.flash_attention_bwd(q, k, v, q, lse, q)
    assert all(g.shape == x.shape for g, x in zip(
        fa.flash_attention_bwd(q, k, v, out, lse, do), (q, k, v)))
    assert fa.flash_attention(q[..., :20], k[..., :20], v).shape == (1, 4, 2, 16)


# --- the whole model ------------------------------------------------------------------


@functools.cache
def _models(variant, dt):
    """(jax model, its TrainState, port model with the state's weights, the
    port's state)."""
    jcfg, tcfg = _cfgs(variant, dt)
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    ts = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tcfg))
    return jm, js, tm, ts


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_forward_logits_match_reference(variant, dt):
    jm, js, tm, _ = _models(variant, dt)
    toks = _tokens(2, 12, seed=0)
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, tokens=t, mode="causal",
                                               cache=None, pos=None))(
        js.params, jnp.asarray(toks))
    tl, _, aux = tm.forward(tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 12, tm.cfg.padded_vocab)
    assert float(aux["moe_aux"]) == 0.0
    _close(tl, jl, TOL[dt])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_steps_match_reference(variant, dt):
    jm, js, tm, _ = _models(variant, dt)
    B, S_p, S_gen = 2, 8, 4
    toks = _tokens(B, S_p + S_gen, seed=1)
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    cfg = tm.cfg
    assert sorted(tc) == ["c_kv", "k_rope"]
    assert tc["c_kv"].shape == (cfg.num_layers, B, S_p + S_gen, cfg.mla_kv_lora)
    assert tc["k_rope"].shape == (cfg.num_layers, B, S_p + S_gen,
                                  cfg.mla_rope_dim)
    _close(tl, jl, TOL[dt], "prefill")
    _close(tc["c_kv"], jc["c_kv"], TOL[dt], "prefill cache")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        _close(tl, jl, TOL[dt], f"decode step {i}")
        _close(tc["k_rope"], jc["k_rope"], TOL[dt], f"decode step {i} cache")


def _batch(b=4, s=16, seed=0):
    r = np.random.default_rng(seed)
    toks = _tokens(b, s, seed)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_gradient_leaf_match_jax_grad(variant):
    jm, js, tm, ts = _models(variant, "f32")
    jb, tb = _batch()
    jl, _ = jax.jit(jm.loss_fn)(js.params, jb)
    tl, _ = tm.loss_fn(tb)
    assert abs(float(tl) - float(jl)) <= TOL["f32"] * abs(float(jl))
    assert abs(float(tl) - math.log(tm.cfg.padded_vocab)) < 0.5
    jg = jax.jit(jax.grad(lambda p: jm.loss_fn(p, jb)[0]))(js.params)
    tg, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want)
    assert {n.split(".", 3)[-1] for n in tg if ".attn." in n} == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= TOL["f32"] * scale, name
        assert float(g.abs().max()) > 0, name


def test_train_step_matches_reference_over_microbatches():
    """Two microbatches at TINY, fp32: the metrics, the grad norm, and every
    leaf's moments and master after the step (held as
    tests/test_torch_moe.py's train step: the first AdamW step moves a
    near-zero-gradient element by up to lr on the sign of its gradient, so
    the masters are held to 0.01 lr where the moment is large, 0.1 lr
    elsewhere)."""
    jm, js, tm, _ = _models("tiny", "f32")
    jb, tb = _batch(seed=2)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    js2, jmet = jax.jit(jsteps.make_train_step(
        jm, JOptConfig(**ocfg), microbatches=2))(js, jb)
    fresh = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tm.cfg))
    ts2, tmet = tsteps.make_train_step(tm, OptConfig(**ocfg),
                                       microbatches=2)(fresh, tb)
    for k in ("loss", "grad_norm", "tokens"):
        w = float(jmet[k])
        assert abs(float(tmet[k]) - w) <= 1e-5 * max(abs(w), 1.0), k
    want = train_state_from_jax(jax.tree.map(np.asarray, js2), tm.cfg)
    lr = float(jmet["lr"])
    for name, wm in want.opt.m.items():
        for got, w in ((ts2.opt.m[name], wm), (ts2.opt.v[name],
                                                want.opt.v[name])):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((got - w).abs().max()) <= 2e-5 * scale, name
        d = (ts2.opt.master[name] - want.opt.master[name]).abs()
        big = wm.abs() > 0.05 * wm.abs().max()
        assert float(torch.where(big, d, 0).max()) <= 0.01 * lr + 1e-7, name
        assert float(d.max()) <= 0.1 * lr, name
    assert int(ts2.step) == int(js2.step) == 1


# --- weights, train state and checkpoints across packages --------------------------


def test_params_and_train_state_carry_every_mla_leaf_exactly():
    jcfg, tcfg = _cfgs("tiny", "bf16")
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, js)
    tm = build_model(tcfg, "cpu")
    sd = params_from_jax(tree.params, tcfg)
    tm.lm.load_state_dict(sd)  # every name and shape of the module
    state = train_state_from_jax(tree, tcfg)
    attn = tree.params["layers"]["attn"]
    assert sorted(attn) == sorted(["w_dq", "q_norm", "w_uq", "w_dkv",
                                   "kv_norm", "w_uk", "w_uv", "wo"])
    for i in range(tcfg.num_layers):
        for name, leaf in attn.items():
            got = sd[f"layers.{i}.attn.{name}"]
            assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.float().numpy(), _np(leaf[i]))
            for part in ("master", "m", "v"):
                np.testing.assert_array_equal(
                    getattr(state.opt, part)[f"layers.{i}.attn.{name}"].numpy(),
                    np.asarray(getattr(tree.opt, part)["layers"]["attn"][name][i],
                               np.float32))
    assert int(state.step) == int(tree.step)


def _numpy_tree(tree):
    """A train state's tensors as numpy (bf16 as ml_dtypes' bfloat16)."""
    import ml_dtypes

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return jax.tree.map(leaf, tree)


def test_mla_checkpoint_reads_across_packages(tmp_path):
    """A bf16 MLA train state saved by the port verifies and loads in the
    reference, and the reference's save of it loads back into the port bit
    for bit."""
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu")
    state = tsteps.init_train_state(tm, 0)
    _, tb = _batch(seed=4)
    state, _ = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1))(
        state, tb)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    assert "params_layers.0.attn.w_uk" in names
    assert "opt_master_layers.1.attn.kv_norm" in names
    saved = [t.clone() for _, t in ckpt._leaf_paths(state)]
    d = str(tmp_path / "port")
    ckpt.save(d, 1, state)
    like = jsteps.TrainState(params=_numpy_tree(dict(state.params)),
                             opt=_numpy_tree(JOptState(*state.opt)),
                             step=_numpy_tree(state.step), ef=None)
    got = jckpt.restore(d, 1, like)
    for (name, t), j in zip(ckpt._leaf_paths(state), jax.tree.leaves(got)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert np.array_equal(j.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), name
        else:
            assert np.array_equal(j, t.numpy()), name
    jd = str(tmp_path / "ref")
    jckpt.save(jd, 2, got)
    restored = ckpt.restore(jd, 2, tsteps.init_train_state(tm, 7))
    for (name, a), b in zip(ckpt._leaf_paths(restored), saved):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_mla_launchers_run_on_the_cpu(capsys):
    from repro_torch.launch import serve, train

    res = serve.main(["--arch", ARCH, "--tiny", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    hist = train.main(["--arch", ARCH, "--tiny", "--steps", "2", "--batch",
                       "4", "--seq", "16", "--log-every", "1", "--device",
                       "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and "tok/s" in out[0]
    assert out[1].startswith("generated token ids (first row): [")
    assert out[-1].startswith("final loss: ")
    assert res.tokens.shape == (2, 3) and len(hist) == 2
    assert sorted(res.cache) == ["c_kv", "k_rope"]
    assert all(math.isfinite(h["loss"]) for h in hist)


# --- chip_smoke.py's phase 20 and its tolerances, on the CPU ------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_wrapper_calls(monkeypatch, smoke):
    """A CPU tensor launches nothing: count each flash wrapper's call as its
    launch, route training through ``FlashAttentionFn`` (whose wrappers take
    their plain versions here), as on the card, and stub the CUDA-only
    calls."""
    counted = {n: smoke.KERNELS[n][0] for n in smoke.LM_KERNELS}
    real = {n: getattr(fa, n) for n in counted}

    def counting(name):
        def launch(*a, **kw):
            counted[name].launches += 1
            return real[name](*a, **kw)
        return launch

    for name in counted:
        monkeypatch.setattr(fa, name, counting(name))
    real_attention = tops.attention

    def attention(q, k, v, *, causal=True):
        if not tops.oracle_only() and torch.is_grad_enabled() and q.requires_grad:
            return fa.FlashAttentionFn.apply(q, k, v, causal)
        if tops.oracle_only():
            return real_attention(q, k, v, causal=causal)
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(tops, "attention", attention)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return real


def test_chip_smoke_mla_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 20 at minicpm3-4b's TINY size (widths 24/16; the card runs
    96/64): serving with one flash call a layer in the prefill and none a
    decode step, the plain run and the causal forward within their
    tolerances, a bidirectional mask moving the logits past them; training
    at 2 layers with the kernel-against-plain check, 2 x layers x 8 LSE
    forwards and layers x 8 backwards a step; a wrong count fails it."""
    smoke = _load_smoke()
    real = _count_wrapper_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "MLA_TRAIN_LAYERS", 2)

    def profiled(name, call, top=8):  # the card's trace, stubbed
        call()
        return {"wall_ms": 1.0, "device_ms": 1.0, "busy_share": 1.0,
                "ported_kernels_ms": 0.5, "ported": {}, "host_ops": 1,
                "top": [("flash_fwd_bf16", 0.5)]}

    monkeypatch.setattr(smoke, "profiled", profiled)
    cpu = torch.device("cpu")
    serve = smoke.phase_big_serve(cpu, profile=True, arch=smoke.MLA_ARCH,
                                  causal_tol=smoke.MLA_DECODE_TOL)
    smoke.say_big_serve(20, serve, "card", 1.0, "MLA, ")
    assert serve["arch"] == smoke.MLA_ARCH and serve["widths"] == [24, 16]
    assert serve["launches"]["flash_attention"] == 2
    assert serve["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert serve["causal_max_abs_err"] <= smoke.MLA_DECODE_TOL
    assert serve["wrong_mask_max_abs_err"] > 3 * smoke.MLA_DECODE_TOL
    train = smoke.phase_big_train(cpu, profiled, smoke.MLA_ARCH,
                                  smoke.MLA_TRAIN_LAYERS)
    smoke.say_big_train(20, train, "card", 1.0)
    k = tconfigs.train_microbatches(smoke.MLA_ARCH)
    assert k == 8 and train["microbatches"] == k
    assert train["launches_per_step"]["flash_attention_lse"] == 2 * 2 * k
    assert train["launches_per_step"]["flash_attention_bwd"] == 2 * k
    assert train["plain"]["loss_rel_err"] == 0.0
    assert all(math.isfinite(x) for x in train["loss"])
    # attention's products a token: 3 x (2 x 24 + 2 x 16) FLOPs over (S + 1)
    # / 2 keys, 4 heads, 2 layers
    n_mm = train["parameters"] - 512 * 64
    assert train["flops_per_token"] == 6 * n_mm + 3 * 2 * 4 * (24 + 16) * (
        smoke.TRAIN_SEQ + 1)
    monkeypatch.setattr(fa, "flash_attention_bwd", real["flash_attention_bwd"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_big_train(cpu, arch=smoke.MLA_ARCH,
                              layers=smoke.MLA_TRAIN_LAYERS)


def test_chip_smoke_lists_mla_in_the_tiny_commands():
    smoke = _load_smoke()
    assert ARCH in smoke.TINY_SERVE_ARCHS and ARCH in smoke.TINY_TRAIN_ARCHS
    assert smoke.attn_widths(tconfigs.get_config(ARCH)) == (96, 64)
    assert smoke.attn_widths(tconfigs.get_tiny(ARCH)) == (24, 16)
    assert smoke.attn_widths(tconfigs.get_config("llama3-8b")) == (128, 128)


def test_decode_tolerance_tells_a_wrong_mask_from_the_absorbed_path():
    """Phase 20's ``MLA_DECODE_TOL`` at the reference's TINY config in bf16
    (its own serving test's 8e-2): prefill + absorbed decode against one
    causal forward stays well inside it, while the same forward with a
    bidirectional prefill mask moves the logits by more than three times
    it."""
    tol = _load_smoke().MLA_DECODE_TOL
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu",
                     generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, 24, seed=9))
    S_p = 16
    with torch.no_grad():
        full, _, _ = tm.forward(tokens=toks)
        logits, cache = make_prefill_step(tm, 24)({"tokens": toks[:, :S_p]})
        errs = [float((logits.float() - full[:, S_p - 1].float()).abs().max())]
        dec = make_decode_step(tm)
        for i in range(24 - S_p):
            lg, cache = dec(cache, toks[:, S_p + i:S_p + i + 1], S_p + i)
            errs.append(float((lg.float() - full[:, S_p + i, :512].float())
                              .abs().max()))
        real = tops.attention
        try:
            tops.attention = lambda q, k, v, causal=True: real(q, k, v,
                                                               causal=False)
            wrong, _, _ = tm.forward(tokens=toks)
        finally:
            tops.attention = real
    assert max(errs) < tol / 2, errs
    assert float((wrong.float() - full.float()).abs().max()) > 3 * tol
