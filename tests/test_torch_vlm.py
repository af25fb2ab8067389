"""internvl2-76b's VLM front on the port (``vision_stub``: ``front_proj``
and the ``embeds`` rows put before the text) against the JAX package's, on
the CPU.

The reference's TINY config (2 layers, d_model 64, 4/2 heads of 16, 8
front rows). The same numpy inputs and the same weights (the reference's,
carried over by ``models/convert.py``) go through both; the reference runs
with ``mesh=None``. fp32 within 1e-5 (measured: logits 1.3e-6, prefill
2.0e-6, decode 1.1e-6, the caches 2.1e-6, each gradient leaf 1.5e-6 of its
largest); bf16 within 3e-2, the reference's own VLM serving tolerance
(``tests/test_serve.py``: atol and rtol 3e-2; measured 0.027 for logits,
0.031 for prefill and its cache, 0.012 for decode). Compared:
the logits with embeds, prefill and decode at ``nf + S_p + i`` into a cache
of ``nf + S_p + S_gen`` rows against the reference's model functions as
its serving test calls them, the loss over the text tokens and every
gradient leaf (``front_proj``'s among them), a train step whose
microbatches carry the embeds, the parameters across packages, the
launchers, the reference launcher's fault (its cache forgets the front
rows) that the port does not share, and chip_smoke.py's phase 22
rehearsed on the CPU.
"""
import functools
import importlib.util
import math
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "internvl2-76b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
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


def _cfgs(dt):
    jdt, tdt = DTYPES[dt]
    return (jconfigs.get_tiny(ARCH).replace(dtype=jdt, param_dtype=jdt),
            tconfigs.get_tiny(ARCH).replace(dtype=tdt, param_dtype=tdt))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _inputs(b, s, seed):
    """(tokens (B, S) int32, embeds (B, 8, 64) float32), numpy."""
    r = np.random.default_rng(seed)
    toks = r.integers(1, 512, (b, s)).astype(np.int32)
    return toks, r.standard_normal((b, 8, 64)).astype(np.float32)


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


# --- the front, the families that still raise -----------------------------------


def test_front_proj_is_carried_and_only_the_vision_front_is_ported():
    jm, js, tm, _ = _models("bf16")
    sd = params_from_jax(jax.tree.map(np.asarray, js.params), tm.cfg)
    assert sd["front_proj"].shape == (64, 64)
    np.testing.assert_array_equal(tm.lm.front_proj.float().numpy(),
                                  _np(js.params["front_proj"]))
    # the audio front is the encoder-decoder's, not the decoder-only
    # transformer's; the encoder-decoder takes no vision front
    cfg = tconfigs.get_tiny(ARCH)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(cfg.replace(frontend="audio_stub"), "cpu")
    with pytest.raises(NotImplementedError, match="audio_stub"):
        build_model(cfg.replace(family="audio"), "cpu")
    for arch, family in (("xlstm-1.3b", "ssm"), ("whisper-base", "audio")):
        assert tconfigs.get_config(arch).family == family
    plain = build_model(tconfigs.get_tiny("llama3-8b"), "cpu")
    toks, emb = _inputs(1, 4, 0)
    with pytest.raises(ValueError, match="front"):
        plain.forward(tokens=torch.from_numpy(toks),
                      embeds=torch.from_numpy(emb))


# --- the model ------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_logits_with_embeds_match_reference(dt):
    jm, js, tm, _ = _models(dt)
    toks, emb = _inputs(2, 12, seed=0)
    jl, _, _ = jax.jit(lambda p, t, e: jm.forward(
        p, tokens=t, embeds=e, mode="causal", cache=None, pos=None))(
        js.params, jnp.asarray(toks), jnp.asarray(emb))
    tl, _, _ = tm.forward(tokens=torch.from_numpy(toks),
                          embeds=torch.from_numpy(emb))
    assert tl.shape == (2, 8 + 12, tm.cfg.padded_vocab)
    _close(tl, jl, TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_at_the_front_offset_match_reference(dt):
    """As the reference's ``test_vlm_prefill_decode`` calls its model: a
    cache of nf + S_p + S_gen rows, decode at nf + S_p + i; the port's
    prefill and decode against the reference's and against its causal
    forward's text rows."""
    jm, js, tm, _ = _models(dt)
    B, S_p, S_gen, nf = 2, 8, 3, 8
    toks, emb = _inputs(B, S_p + S_gen, seed=1)
    jfull, _, _ = jax.jit(lambda p, t, e: jm.forward(
        p, tokens=t, embeds=e, mode="causal", cache=None, pos=None))(
        js.params, jnp.asarray(toks), jnp.asarray(emb))
    ref = _np(jfull)[:, nf:, :512]
    jl, jc = jax.jit(j_prefill(jm, nf + S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p]),
                    "embeds": jnp.asarray(emb)})
    tl, tc = make_prefill_step(tm, nf + S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p]),
         "embeds": torch.from_numpy(emb)})
    assert tc["k"].shape == (2, B, nf + S_p + S_gen, 2, 16)
    _close(tl, jl, TOL[dt], "prefill")
    _close(tl[:, :512], ref[:, S_p - 1], TOL[dt], "prefill vs causal")
    _close(tc["k"], jc["k"], TOL[dt], "prefill cache")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(nf + S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), nf + S_p + i)
        _close(tl, jl, TOL[dt], f"decode step {i}")
        _close(tl, ref[:, S_p + i], TOL[dt], f"decode step {i} vs causal")
    _close(tc["v"], jc["v"], TOL[dt], "cache after decode")


def _batch(b=4, s=12, seed=0):
    r = np.random.default_rng(seed + 100)
    toks, emb = _inputs(b, s, seed)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w),
             "embeds": jnp.asarray(emb)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w),
             "embeds": torch.from_numpy(emb)})


def test_loss_over_embeds_and_every_gradient_leaf_match_jax_grad():
    jm, js, tm, ts = _models("f32")
    jb, tb = _batch()
    jl, jmet = jax.jit(jm.loss_fn)(js.params, jb)
    tl, tmet = tm.loss_fn(tb)
    assert abs(float(tl) - float(jl)) <= TOL["f32"] * abs(float(jl))
    # the weighted count of the text's labels (none of the front rows)
    assert abs(float(tmet["tokens"]) - float(jmet["tokens"])) <= \
        1e-6 * float(jmet["tokens"])
    text_only, _ = tm.loss_fn({k: v for k, v in tb.items() if k != "embeds"})
    assert abs(float(text_only) - float(tl)) > 1e-4
    jg = jax.jit(jax.grad(lambda p: jm.loss_fn(p, jb)[0]))(js.params)
    tg, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want) and "front_proj" in tg
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= TOL["f32"] * scale, name
        assert float(g.abs().max()) > 0, name


def test_train_step_carries_the_embeds_into_each_microbatch():
    """Two microbatches whose rows carry their embeds, fp32: the metrics
    and every leaf's master after the step (held as tests/test_torch_mla.py's
    train step)."""
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
        d = (ts2.opt.master[name] - want.opt.master[name]).abs()
        big = wm.abs() > 0.05 * wm.abs().max()
        assert float(torch.where(big, d, 0).max()) <= 0.01 * lr + 1e-7, name
        assert float(d.max()) <= 0.1 * lr, name


# --- the launchers ----------------------------------------------------------------------


def test_serve_launcher_counts_the_front_rows(capsys, monkeypatch):
    """``--prompt-len 8 --gen 4`` serves 4 tokens: a cache of 8 + 8 + 4
    rows, decode at 16 + i, the same tokens as ``generate`` on the
    launcher's inputs."""
    from repro_torch.launch import serve

    seen = []
    real = serve.make_decode_step

    def spy(model):
        step = real(model)

        def at(cache, tokens, pos):
            seen.append(pos)
            return step(cache, tokens, pos)
        return at

    monkeypatch.setattr(serve, "make_decode_step", spy)
    res = serve.main(["--arch", ARCH, "--tiny", "--prompt-len", "8", "--gen",
                      "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and "tok/s" in out[0]
    assert res.tokens.shape == (4, 4)
    assert res.cache["k"].shape[2] == 8 + 8 + 4
    assert seen == [16, 17, 18]
    cfg = tconfigs.get_tiny(ARCH)
    tokens, embeds = serve.prompt_inputs(cfg, 4, 8, 0, "cpu")
    assert embeds.shape == (4, 8, 64) and embeds.dtype == torch.float32
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    again = serve.generate(model, tokens, 4, embeds=embeds)
    assert torch.equal(again.tokens, res.tokens)


def test_reference_launcher_forgets_the_front_rows(monkeypatch):
    """The reference launcher's cache holds prompt_len + gen rows, so its
    prefill of 8 front + 8 prompt rows into 12 raises (a fault of the
    reference's launcher, which the port's does not share)."""
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--tiny", "--prompt-len", "8", "--gen", "4"])
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jserve.main()


def test_train_launcher_trains_the_text_path(capsys):
    from repro_torch.launch import train

    hist = train.main(["--arch", ARCH, "--tiny", "--steps", "2", "--batch",
                       "4", "--seq", "16", "--log-every", "1", "--device",
                       "cpu"])
    err = capsys.readouterr().err
    assert "note: vlm frontend is a stub" in err
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)


# --- chip_smoke.py's phase 22, on the CPU -------------------------------------------


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


def _profiled(name, call, top=8):  # the card's trace, stubbed
    call()
    return {"wall_ms": 1.0, "device_ms": 1.0, "busy_share": 1.0,
            "ported_kernels_ms": 0.5, "ported": {}, "host_ops": 1,
            "top": [("flash_fwd_bf16", 0.5)]}


def test_chip_smoke_vlm_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 22 at the TINY widths (2 layers for the card's 8): serving
    with the launcher's front embeddings, one flash call a layer in the
    prefill (at S 8 + 16) and none a decode step, the plain run and the
    causal forward within ``LM_TOL``; the loss over embeds with every
    gradient leaf through the kernels against the plain attention, 2 x 2 x
    16 LSE forwards and 2 x 16 backwards a step; ``front_proj`` reached."""
    smoke = _load_smoke()
    _count_wrapper_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "profiled", _profiled)
    cpu = torch.device("cpu")
    serve = smoke.phase_big_serve(cpu, profile=True, arch=smoke.VLM_ARCH,
                                  layers=2)
    smoke.say_big_serve(22, serve, "card", 1.0, "VLM, ")
    assert serve["front_rows"] == 8 and serve["layers"] == 2
    assert serve["launches"]["flash_attention"] == 2
    assert serve["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert serve["causal_max_abs_err"] <= smoke.LM_TOL
    assert serve["wrong_mask_max_abs_err"] > 3 * smoke.LM_TOL
    monkeypatch.setattr(smoke, "VLM_TINY_SEQ", 16)
    train = smoke.phase_vlm_tiny_train(cpu)
    assert train["launches_per_step"]["flash_attention_lse"] == 2 * 2 * 16
    assert train["launches_per_step"]["flash_attention_bwd"] == 2 * 16
    assert train["loss_rel_err"] == 0.0 and train["front_proj_grad_max"] > 0
    assert abs(train["loss_text_only"] - train["loss_with_embeds"]) > 1e-4
    assert smoke.attn_layers(tconfigs.get_config(ARCH)) == 80
    assert ARCH in smoke.TINY_SERVE_ARCHS
