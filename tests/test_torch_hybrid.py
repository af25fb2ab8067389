"""zamba2-1.2b's Mamba2 hybrid on the port (``repro_torch.models.zamba``)
against the JAX package's (``repro/models/zamba.py``), on the CPU.

The reference's TINY config: 8 Mamba2 blocks, the shared block every 3
(two periods and two trailing blocks), d_model 64, state 16, chunk 8. The
same numpy inputs and the same weights (the reference's, carried over by
``models/convert.py``) go through both; the reference runs with
``mesh=None``.

Tolerances. fp32 within 1e-5 (the same fp32 math, sums in another order;
measured: the Mamba block 9.5e-7, logits 4.2e-6, prefill 2.4e-6 and decode
7.4e-6, caches and states 4.8e-6 of their largest value), but the
gradient leaves and the optimizer's moments, held within 5e-5 of their
largest value: the Mamba blocks' ``D`` and ``dt_bias`` gradients are sums
over every (token, channel) with much cancellation, and differ by up to
2.1e-5 of their largest (the moments 3.4e-5; every other leaf under
1.1e-5), in forward and backward order alike (a sequential cumsum moves
them no closer). bf16 within the reference's own serving tolerance for
zamba2 (``tests/test_serve.py``: atol and rtol 5e-2) for one forward's
logits and prefill (measured 0.043; the prefill's states 0.030 of their
largest), and within 1e-1 for the decode steps after it: the
reference's own prefill + decode drifts from its causal forward by up to
0.075 here (max abs), and the port's prefill attention keeps fp32
probabilities where the reference's einsum rounds them to bf16, so the
two runs carry different bf16 states into decode. With SiLU rounded as
the reference's everywhere (``layers.silu``) that gap reaches 0.184 at one
element of decode step 1; with the prefill's attention rounded as the
reference's too it is 0.082 (the rest is matmul order), so the decode
test runs that attention in bf16. The Mamba block alone matches the
reference bit for bit in bf16 here.

Compared: the Mamba block leaf for leaf (chunked, with a cache, one decode
step), the whole model's logits, prefill and decode steps with their
caches, the loss and every gradient leaf (the shared block's summed over
its invocations), one AdamW step over two microbatches from
``train_state_from_jax``, the parameters and a checkpoint across packages,
the launchers, and chip_smoke.py's phase 21 rehearsed on the CPU with its
serving tolerances' two sides.
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
from repro.models import zamba as JZ  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import zamba as TZ  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "zamba2-1.2b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 5e-2}
DECODE_TOL = {"f32": 1e-5, "bf16": 1e-1}
GRAD_TOL = 5e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAMBA_LEAVES = ["A_log", "D", "conv_w", "dt_bias", "in_proj", "ln", "norm",
                "out_proj"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dt, **kw):
    jdt, tdt = DTYPES[dt]
    return (jconfigs.get_tiny(ARCH).replace(dtype=jdt, param_dtype=jdt, **kw),
            tconfigs.get_tiny(ARCH).replace(dtype=tdt, param_dtype=tdt, **kw))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _close_state(got, want, tol, msg=""):
    """A cache or state held within ``tol`` of its largest value (a
    later layer's conv rows reach ~3, where fp32 sums in another order
    leave ~1e-5)."""
    scale = max(float(np.abs(_np(want)).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=tol * scale, rtol=0, err_msg=msg)


def _tokens(b, s, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)) \
        .astype(np.int32)


@functools.cache
def _models(dt):
    """(jax model, its TrainState, port model with the state's weights, the
    port's state)."""
    jcfg, tcfg = _cfgs(dt)
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    ts = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tcfg))
    return jm, js, tm, ts


# --- the config and the structure ---------------------------------------------------


def test_hybrid_layout_follows_the_reference_periods():
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.d_inner, cfg.n_ssm_heads) == (4096, 64)
    assert TZ.period_counts(cfg) == (6, 2)
    assert TZ._mamba_dims(cfg) == JZ._mamba_dims(jconfigs.get_config(ARCH))
    tiny = tconfigs.get_tiny(ARCH)
    assert TZ.period_counts(tiny) == (2, 2)
    cache = TZ.init_hybrid_cache(tiny, 3, 20, "cpu")
    want = jax.eval_shape(lambda: JZ.init_hybrid_cache(
        jconfigs.get_tiny(ARCH), 3, 20))
    for group in ("mamba", "attn"):
        for name, t in cache[group].items():
            assert tuple(t.shape) == want[group][name].shape, (group, name)
            assert (t.dtype == torch.float32) == (
                want[group][name].dtype == jnp.float32), (group, name)
    with pytest.raises(NotImplementedError):
        build_model(tiny.replace(attn_every=0), "cpu")


# --- the Mamba2 block, leaf for leaf ------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_block_matches_reference(dt):
    """Chunked without a cache (S 11, padded to the chunk; the reference
    run from its zero cache, the same function), then chunked into a cache
    and one decode step from it."""
    jm, js, tm, _ = _models(dt)
    jcfg, tcfg = jm.cfg, tm.cfg
    jp = jax.tree.map(lambda v: v[1], js.params["mamba"])
    block = tm.lm.mamba[1]
    for name in MAMBA_LEAVES:
        np.testing.assert_array_equal(block[name].float().numpy(), _np(jp[name]))
    tdt = DTYPES[dt][1]
    x = np.random.default_rng(2).standard_normal((2, 11, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.dtype), _t(x, tdt)
    fwd = jax.jit(functools.partial(JZ.mamba_fwd, cfg=jcfg),
                  static_argnames="decode")
    jc0, tc0 = JZ.init_mamba_cache(jcfg, 2), TZ.init_mamba_cache(tcfg, 2, "cpu")
    jy, jc = fwd(jp, jx, cache=jc0)
    ty, none = block(tx)
    assert none is None
    _close(ty, jy, TOL[dt], "chunked")
    ty, tc = block(tx, cache=tc0)
    _close(ty, jy, TOL[dt], "chunked into a cache")
    for name in ("conv", "ssm"):
        _close_state(tc[name], jc[name], TOL[dt], f"cache {name}")
    x1 = x[:, :1] + 0.5
    jy, jc = fwd(jp, jnp.asarray(x1, jcfg.dtype), cache=jc, decode=True)
    ty, tc = block(_t(x1, tdt), cache=tc, decode=True)
    _close(ty, jy, TOL[dt], "decode step")
    _close_state(tc["ssm"], jc["ssm"], TOL[dt], "decode state")


# --- the whole model ------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hybrid_logits_match_reference(dt):
    jm, js, tm, _ = _models(dt)
    toks = _tokens(2, 20, seed=0)
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, tokens=t, mode="causal",
                                               cache=None, pos=None))(
        js.params, jnp.asarray(toks))
    tl, _, aux = tm.forward(tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 20, tm.cfg.padded_vocab)
    assert float(aux["moe_aux"]) == 0.0 and float(aux["moe_dropped"]) == 0.0
    _close(tl, jl, TOL[dt])


def _attention_rounding_as_reference(q, k, v, *, causal=True):
    """The reference's einsum attention with its roundings: scores rounded
    to q's dtype, fp32 softmax, probabilities rounded to q's dtype."""
    b, s, h, hd = q.shape
    kr, vr = (x.repeat_interleave(h // k.shape[2], 2) for x in (k, v))
    sc = torch.einsum("bshd,bthd->bhst", q, kr).float() / math.sqrt(hd)
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -1e30)
    p = torch.softmax(sc, -1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", p, vr)


def _f32_copy(tm):
    """The port's model in fp32 on ``tm``'s weights, cast up."""
    m32 = build_model(_cfgs("f32")[1], "cpu")
    m32.load_state_dict({k: v.float() for k, v in tm.state_dict().items()})
    return m32


@pytest.mark.parametrize("dt", ["f32", "bf16", "bf16-reference-attention"])
def test_prefill_and_decode_steps_match_reference(dt, monkeypatch):
    """Prefill and decode steps against the reference's, the caches with
    them. ``f32`` and ``bf16`` run the port's own attention; in
    ``bf16-reference-attention`` the port's prefill attention rounds as the
    reference's einsums do (``_attention_rounding_as_reference``).

    bf16 decode logits. The port's own plain attention keeps fp32
    probabilities where the reference's einsum rounds them to bf16, and 8
    blocks carry that into the decode steps: with SiLU rounded as the
    reference's, the port's own run stands 0.184 from the reference's at
    one element of decode step 1 (0.019-0.063 at the other steps), over
    ``DECODE_TOL``; with the reference's attention rounding it is 0.082,
    the rest matmul order. Both runs are rounding around the same fp32
    function: against the fp32 run of the same weights (which the ``f32``
    case holds to the reference's within 1e-5), the port's own bf16 run is
    0.041-0.147 away a step and the reference's 0.044-0.079; its conv
    cache stands 0.105 of its largest from the reference's at steps 1-3
    (over ``DECODE_TOL``), 0.067 from the fp32 run's where the reference's
    is 0.044. So ``bf16`` holds each decode step's logits, conv cache and
    attention cache to at most ``HYBRID_NOISE_RATIO`` (the card's phase 21
    ratio) times the reference's own distance from that fp32 run at the
    step (worst 1.94 x, the logits at step 1; the conv cache 1.51 x), and
    the reference-rounded case holds them to the reference's within
    ``DECODE_TOL``. A wrong mask or a lost state carry moves them by
    0.95-1.43 (``test_serving_tolerances_tell_a_wrong_mask_or_a_lost_state_carry``)."""
    own = dt != "bf16-reference-attention"
    dt = "bf16" if not own else dt
    jm, js, tm, _ = _models(dt)
    if not own:
        monkeypatch.setattr(tops, "attention", _attention_rounding_as_reference)
    B, S_p, S_gen = 2, 12, 5
    toks = _tokens(B, S_p + S_gen, seed=1)
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    assert sorted(tc) == ["attn", "mamba"]
    assert tc["attn"]["k"].shape == (2, B, S_p + S_gen, 4, 16)
    assert tc["mamba"]["ssm"].dtype == torch.float32
    _close(tl, jl, TOL[dt], "prefill")
    _close_state(tc["mamba"]["ssm"], jc["mamba"]["ssm"], TOL[dt],
                 "prefill ssm")
    _close_state(tc["attn"]["k"], jc["attn"]["k"], TOL[dt], "prefill k")
    noise = dt == "bf16" and own
    if noise:
        ratio = _load_smoke().HYBRID_NOISE_RATIO
        m32 = _f32_copy(tm)
        _, c32 = make_prefill_step(m32, S_p + S_gen)(
            {"tokens": torch.from_numpy(toks[:, :S_p])})
        dec32 = make_decode_step(m32)
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        got = {"logits": tl, "conv": tc["mamba"]["conv"], "v": tc["attn"]["v"]}
        want = {"logits": jl, "conv": jc["mamba"]["conv"], "v": jc["attn"]["v"]}
        if noise:
            l32, c32 = dec32(c32, torch.from_numpy(fed), S_p + i)
            f32 = {"logits": l32, "conv": c32["mamba"]["conv"],
                   "v": c32["attn"]["v"]}
            for name, g in got.items():
                anchor = f32[name].numpy()
                port_err = float(np.abs(g.float().numpy() - anchor).max())
                ref_err = float(np.abs(_np(want[name]) - anchor).max())
                assert port_err <= ratio * ref_err, (i, name, port_err, ref_err)
            continue
        _close(tl, jl, DECODE_TOL[dt], f"decode step {i}")
        _close_state(got["conv"], want["conv"], DECODE_TOL[dt],
                     f"decode step {i} conv")
        _close_state(got["v"], want["v"], DECODE_TOL[dt], f"decode step {i} v")


def _serving_errors(tm, toks, s_p, *, attention=None, drop_state=False):
    """Largest |prefill + decode logits - one causal forward's| over the
    steps; ``attention`` replaces the prefill's attention, ``drop_state``
    zeroes the Mamba states after prefill (the carry lost)."""
    s = toks.shape[1]
    with torch.no_grad():
        full, _, _ = tm.forward(tokens=toks)
        real = tops.attention
        if attention is not None:
            tops.attention = attention
        try:
            last, cache = make_prefill_step(tm, s)({"tokens": toks[:, :s_p]})
        finally:
            tops.attention = real
        if drop_state:
            cache["mamba"]["ssm"].zero_()
        errs = [float((last.float() - full[:, s_p - 1].float()).abs().max())]
        dec = make_decode_step(tm)
        for i in range(s - s_p):
            lg, cache = dec(cache, toks[:, s_p + i:s_p + i + 1], s_p + i)
            errs.append(float((lg.float() - full[:, s_p + i, :512].float())
                              .abs().max()))
    return max(errs)


def test_serving_tolerances_tell_a_wrong_mask_or_a_lost_state_carry():
    """Phase 21's serving tolerances at the TINY config, 4 x 24 tokens
    (16 prompt, 8 decoded), through the port's plain attention. In bf16 a
    bidirectional prefill mask (measured 0.95) or the Mamba states zeroed
    after the prefill (1.43) move the logits by more than 3 x
    ``HYBRID_PLAIN_TOL``, while the bf16 prefill + decode drifts from its
    own causal forward by 0.071 (rounding: the reference's own run reaches
    0.075 at 4 x 40 tokens). The same weights in fp32 keep prefill + decode
    within ``HYBRID_F32_TOL`` of the causal forward (measured 2.0e-6), a
    lost carry moving them by 1.42; and the bf16 serving logits are as far
    from the fp32 causal forward as the bf16 causal forward is (0.128 both:
    the prefill's last row is the causal forward's), within
    ``HYBRID_NOISE_RATIO`` of it."""
    smoke = _load_smoke()
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu",
                     generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, 24, seed=9))
    real = tops.attention
    wrong = _serving_errors(tm, toks, 16, attention=lambda q, k, v, causal=True:
                            real(q, k, v, causal=False))
    lost = _serving_errors(tm, toks, 16, drop_state=True)
    assert min(wrong, lost) > 3 * smoke.HYBRID_PLAIN_TOL, (wrong, lost)
    assert _serving_errors(tm, toks, 16) <= smoke.HYBRID_PLAIN_TOL
    m32 = build_model(tm.cfg.replace(dtype=torch.float32,
                                     param_dtype=torch.float32), "cpu")
    m32.lm.load_state_dict({k: t.float() for k, t in tm.lm.state_dict().items()})
    assert _serving_errors(m32, toks, 16) <= smoke.HYBRID_F32_TOL
    assert _serving_errors(m32, toks, 16, drop_state=True) > \
        3 * smoke.HYBRID_F32_TOL
    with torch.no_grad():
        full32 = m32.forward(tokens=toks)[0][:, 15:, :512]
        full16 = tm.forward(tokens=toks)[0][:, 15:, :512].float()
        last, cache = make_prefill_step(tm, 24)({"tokens": toks[:, :16]})
        served = [last[:, :512].float()]
        dec = make_decode_step(tm)
        for i in range(8):
            lg, cache = dec(cache, toks[:, 16 + i:17 + i], 16 + i)
            served.append(lg.float())
    causal_noise = float((full16 - full32).abs().max())
    serve_noise = max(float((g - full32[:, i]).abs().max())
                      for i, g in enumerate(served))
    assert serve_noise <= smoke.HYBRID_NOISE_RATIO * causal_noise, \
        (serve_noise, causal_noise)


def _batch(b=4, s=16, seed=0):
    r = np.random.default_rng(seed)
    toks = _tokens(b, s, seed)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)})


def test_loss_and_every_gradient_leaf_match_jax_grad():
    """fp32, a 20-token batch (two Mamba chunks and a padded third): every
    leaf, the shared block's gradient being the sum over its two
    invocations in both packages."""
    jm, js, tm, ts = _models("f32")
    jb, tb = _batch(s=20)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, jb)[0]))(
        js.params)
    tg, met = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    tl = met["loss"]
    assert abs(float(tl) - float(jl)) <= TOL["f32"] * abs(float(jl))
    assert abs(float(tl) - math.log(tm.cfg.padded_vocab)) < 0.5
    assert float(met["moe_aux"]) == 0.0
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want) == set(dict(tm.lm.named_parameters()))
    assert {n.split(".", 2)[-1] for n in tg if n.startswith("mamba.")} == \
        set(MAMBA_LEAVES)
    assert {n for n in tg if n.startswith("shared.")} == {
        "shared.ln1", "shared.ln2", "shared.attn.wq", "shared.attn.wk",
        "shared.attn.wv", "shared.attn.wo", "shared.mlp.wi", "shared.mlp.wg",
        "shared.mlp.wo"}
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= GRAD_TOL * scale, name
        assert float(g.abs().max()) > 0, name


def test_train_step_matches_reference_over_microbatches():
    """Two microbatches, fp32: the metrics, the grad norm, and every leaf's
    moments and master after the step (held as tests/test_torch_mla.py's
    train step: the first AdamW step moves a near-zero-gradient element by
    up to lr on the sign of its gradient, so the masters are held to 0.01
    lr where the moment is large, 0.1 lr elsewhere). Weight decay follows
    the reference's stacked ranks: the Mamba blocks' vectors are decayed
    (stacked (L, h) there), the shared block's norms are not."""
    jm, js, tm, _ = _models("f32")
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
            assert float((got - w).abs().max()) <= GRAD_TOL * scale, name
        d = (ts2.opt.master[name] - want.opt.master[name]).abs()
        big = wm.abs() > 0.05 * wm.abs().max()
        assert float(torch.where(big, d, 0).max()) <= 0.01 * lr + 1e-7, name
        assert float(d.max()) <= 0.1 * lr, name
    assert int(ts2.step) == int(js2.step) == 1


# --- weights, train state and checkpoints across packages --------------------------


def test_params_and_train_state_carry_every_hybrid_leaf_exactly():
    jcfg, tcfg = _cfgs("bf16")
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, js)
    tm = build_model(tcfg, "cpu")
    sd = params_from_jax(tree.params, tcfg)
    tm.lm.load_state_dict(sd)  # every name and shape of the module
    state = train_state_from_jax(tree, tcfg)
    assert sorted(tree.params["mamba"]) == MAMBA_LEAVES
    for i in range(tcfg.num_layers):
        for name, leaf in tree.params["mamba"].items():
            got = sd[f"mamba.{i}.{name}"]
            assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.float().numpy(), _np(leaf[i]))
            np.testing.assert_array_equal(
                state.opt.master[f"mamba.{i}.{name}"].numpy(),
                np.asarray(tree.opt.master["mamba"][name][i], np.float32))
    np.testing.assert_array_equal(sd["shared.attn.wq"].float().numpy(),
                                  _np(tree.params["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(sd["lm_head"].float().numpy(),
                                  _np(tree.params["lm_head"]))
    assert int(state.step) == int(tree.step)


def _numpy_tree(tree):
    """A train state's tensors as numpy (bf16 as ml_dtypes' bfloat16)."""
    import ml_dtypes

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return jax.tree.map(leaf, tree)


def test_hybrid_checkpoint_reads_across_packages(tmp_path):
    """A bf16 hybrid train state saved by the port verifies and loads in the
    reference, and the reference's save of it loads back into the port bit
    for bit; a resume from it carries on as the uninterrupted state."""
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu")
    state = tsteps.init_train_state(tm, 0)
    _, tb = _batch(seed=4)
    step = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1))
    state, _ = step(state, tb)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    assert "params_mamba.0.A_log" in names
    assert "opt_master_shared.attn.wq" in names
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
    again, _ = step(state, tb)
    want = [t.clone() for _, t in ckpt._leaf_paths(again)]
    restored = ckpt.restore(jd, 2, tsteps.init_train_state(tm, 7))
    for (name, a), b in zip(ckpt._leaf_paths(restored), saved):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    resumed, _ = step(restored, tb)
    for (name, a), b in zip(ckpt._leaf_paths(resumed), want):
        assert torch.equal(a, b), name


def test_hybrid_launchers_run_on_the_cpu(capsys):
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
    assert sorted(res.cache) == ["attn", "mamba"]
    assert all(math.isfinite(h["loss"]) for h in hist)


# --- chip_smoke.py's phase 21, on the CPU -------------------------------------------


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
    calls (as tests/test_torch_mla.py does)."""
    from repro_torch.kernels import flash_attention as fa

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
    return fa, real


def test_chip_smoke_hybrid_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 21 at zamba2's TINY size (8 blocks, the shared block every 3):
    serving with one flash call a period in the prefill (2) and none a
    decode step, the plain run within ``LM_TOL``, the causal forward within
    ``HYBRID_PLAIN_TOL`` (the plain run: the same plain math twice), the
    fp32 invariant within ``HYBRID_F32_TOL``, a bidirectional mask and the
    lost state carry moving the logits past 3 x ``HYBRID_PLAIN_TOL``, the
    P-rounded plain run within it and each prefill call's kernel stand-in
    (here the emulation itself) equal to its emulation;
    training uncut at this size with the
    kernel-against-plain check at 2 periods (6 blocks), 2 x 2 periods x 4
    microbatches LSE forwards and 2 x 4 backwards a step (the shared block
    recomputed with its period); a wrong count fails it."""
    smoke = _load_smoke()
    fa, real = _count_wrapper_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)

    def profiled(name, call, top=8):  # the card's trace, stubbed
        call()
        return {"wall_ms": 1.0, "device_ms": 1.0, "busy_share": 1.0,
                "ported_kernels_ms": 0.5, "ported": {}, "host_ops": 1,
                "top": [("flash_fwd_bf16", 0.5)]}

    monkeypatch.setattr(smoke, "profiled", profiled)
    # the per-call account holds the kernel against its emulation: on the
    # CPU the emulation stands in for the kernel there
    from repro_torch.kernels import ref as tref
    monkeypatch.setattr(smoke, "flash_attention", tref.attention_rounding_p)
    cpu = torch.device("cpu")
    serve = smoke.phase_big_serve(cpu, profile=True, arch=smoke.HYBRID_ARCH,
                                  causal_tol=smoke.HYBRID_PLAIN_TOL)
    smoke.say_big_serve(21, serve, "card", 1.0, "Mamba2 hybrid, ")
    assert serve["launches"]["flash_attention"] == 2
    assert serve["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert serve["f32_causal_max_abs_err"] <= smoke.HYBRID_F32_TOL
    assert serve["bf16_serving_vs_f32"] <= \
        smoke.HYBRID_NOISE_RATIO * serve["bf16_causal_vs_f32"]
    assert serve["wrong_mask_max_abs_err"] > 3 * smoke.HYBRID_PLAIN_TOL
    assert serve["lost_carry_max_abs_err"] > 3 * smoke.HYBRID_PLAIN_TOL
    assert 0 < serve["rounded_vs_plain"] <= smoke.HYBRID_PLAIN_TOL
    assert len(serve["per_call"]) == 2 and all(
        c["kernel_vs_rounded_share"] == 0 < c["rounded_vs_plain_share"]
        for c in serve["per_call"])
    train = smoke.phase_big_train(cpu, profiled, smoke.HYBRID_ARCH, 8)
    smoke.say_big_train(21, train, "card", 1.0)
    k = tconfigs.train_microbatches(smoke.HYBRID_ARCH)
    assert k == 4 and train["plain"]["layers"] == 6
    assert train["launches_per_step"]["flash_attention_lse"] == 2 * 2 * k
    assert train["launches_per_step"]["flash_attention_bwd"] == 2 * k
    assert train["plain"]["loss_rel_err"] == 0.0
    assert all(math.isfinite(x) for x in train["loss"] + train["grad_norm"])
    full = tconfigs.get_config(ARCH)
    assert smoke.attn_layers(full) == 6 and smoke.plain_layers(full) == 12
    want = smoke.train_launches(full, 4)
    assert (want["flash_attention_lse"], want["flash_attention_bwd"]) == (48, 24)
    assert ARCH in smoke.TINY_SERVE_ARCHS and ARCH in smoke.TINY_TRAIN_ARCHS
    monkeypatch.setattr(fa, "flash_attention_bwd", real["flash_attention_bwd"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_big_train(cpu, arch=smoke.HYBRID_ARCH, layers=8)


def test_p_rounding_not_a_wrong_mask_accounts_for_the_kernels_distance():
    """Phase 21's account of the hybrid's kernel-vs-plain distance, at TINY
    in bf16 (4 x 16-token prompts, 8 tokens teacher-forced): serving
    through the plain attention with the kernel's P rounding
    (``ref.attention_rounding_p``) moves the logits from the plain run by
    the rounding's own size, under ``LM_TOL``, which the card's kernel run
    is held to against that rounded run; a bidirectional prefill mask moves
    them by more than 3 x ``HYBRID_PLAIN_TOL``. So a distance of the
    rounding's size is rounding, and a wrong mask is not."""
    from repro_torch.kernels import ref as tref
    from repro_torch.launch.serve import generate

    smoke = _load_smoke()
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu",
                     generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, 24, seed=9))
    real = tops.attention

    def served(attention):
        tops.attention = attention
        try:
            return generate(tm, toks[:, :16], 8, forced=toks[:, 16:],
                            keep_logits=True).logits
        finally:
            tops.attention = real

    def dist(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    plain = served(real)
    rounded = dist(served(tref.attention_rounding_p), plain)
    wrong = dist(served(lambda q, k, v, causal=True:
                        real(q, k, v, causal=False)), plain)
    assert 0 < rounded <= smoke.LM_TOL, rounded
    assert wrong > 3 * smoke.HYBRID_PLAIN_TOL, wrong
