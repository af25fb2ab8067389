"""whisper-base's training and launchers on the port against the JAX
package's, on the CPU, and chip_smoke.py's phase 24 rehearsed
(``tests/test_torch_encdec.py`` holds the layers, logits and serving).

The reference's TINY config: 2 encoder and 2 decoder blocks, d_model 64,
4/4 heads of 16, d_ff 128, vocab 512, a tied head and the 32768-row
learned position table. The same numpy inputs (frame embeddings and
tokens) and the same weights (the reference's, carried over by
``models/convert.py``) go through both; the reference runs with
``mesh=None``.

Tolerances, fp32: the loss within 1e-5 (relative), every gradient leaf
and the optimizer's moments within ``GRAD_TOL`` of their largest value.

Compared: the loss over frames and tokens and every gradient leaf, one
AdamW step over two microbatches, the launchers (the reference's train
launcher's fault beside the port's clear error), and chip_smoke.py's
phase 24 on the CPU.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ARCH = "whisper-base"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
GRAD_TOL = 5e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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


def _tokens(b, s, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)) \
        .astype(np.int32)


def _frames(b, s, seed, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


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


def _batch(b=4, s=16, seed=0):
    r = np.random.default_rng(seed)
    toks = _tokens(b, s, seed)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    e = _frames(b, 12, seed)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w),
             "embeds": jnp.asarray(e)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w),
             "embeds": torch.from_numpy(e)})


def test_loss_and_every_gradient_leaf_match_jax_grad():
    """fp32, 12 frames and 16 tokens: every leaf, ``dec_pos``'s rows past
    the tokens' zero in both."""
    jm, js, tm, ts = _models("f32")
    jb, tb = _batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, jb)[0]))(
        js.params)
    tg, met = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    assert abs(float(met["loss"]) - float(jl)) <= TOL["f32"] * abs(float(jl))
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want) == set(dict(tm.lm.named_parameters()))
    assert {n.split(".", 2)[-1] for n in tg if n.startswith("dec_layers.")} \
        == {"ln1", "ln2", "ln3", "self.wq", "self.wk", "self.wv", "self.wo",
            "cross.wq", "cross.wk", "cross.wv", "cross.wo", "mlp.wi",
            "mlp.wo"}
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= GRAD_TOL * scale, name
        assert float(g.abs().max()) > 0, name
    assert float(tg["dec_pos"][16:].abs().max()) == 0.0


def test_train_step_matches_reference_over_microbatches():
    """Two microbatches with frames, fp32 (held as
    tests/test_torch_hybrid.py holds its step)."""
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


# --- the launchers ---------------------------------------------------------------------------


def test_encdec_serve_launcher_runs_on_the_cpu(capsys):
    """The frames are drawn after the tokens, ``prompt_len`` of them, as the
    reference launcher draws them: they fill the cross cache, and the
    decode positions count the prompt only."""
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--tiny", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and "tok/s" in out[0]
    assert res.tokens.shape == (2, 4)
    assert res.cache["cross"]["k"].shape == (2, 2, 8, 4, 16)
    assert res.cache["self"]["k"].shape == (2, 2, 12, 4, 16)
    tokens, frames = serve.prompt_inputs(tconfigs.get_tiny(ARCH), 2, 8, 0,
                                         "cpu")
    r = np.random.default_rng(0)
    np.testing.assert_array_equal(tokens.numpy(), r.integers(1, 512, (2, 8)))
    np.testing.assert_array_equal(
        frames.numpy(), r.standard_normal((2, 8, 64)).astype(np.float32))


def test_train_launcher_refuses_whisper_where_the_reference_crashes(
        monkeypatch):
    """The reference's train launcher feeds tokens only and fails in the
    encoder (``AttributeError`` on the missing embeds); the port's raises
    a clear ``ValueError`` before drawing a weight, and
    ``make_train_step`` trains the model on a batch with frames."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--tiny", "--steps", "1", "--batch", "2",
        "--seq", "16"])
    with pytest.raises(AttributeError, match="astype"):
        jtrain.main()
    with pytest.raises(ValueError, match="embeds"):
        train.main(["--arch", ARCH, "--tiny", "--steps", "1", "--device",
                    "cpu"])
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu")
    step = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1))
    _, tb = _batch(seed=6)
    state, m = step(tsteps.init_train_state(tm, 0), tb)
    assert math.isfinite(float(m["loss"])) and int(state.step) == 1


# --- chip_smoke.py's phase 24, on the CPU ---------------------------------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_wrapper_calls(monkeypatch, smoke):
    """A CPU tensor launches nothing: count each flash wrapper's call as its
    launch, route training through ``FlashAttentionFn``, and stub the
    CUDA-only calls (as tests/test_torch_hybrid.py does)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as tops

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


def test_chip_smoke_encdec_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 24 at whisper's TINY size: serving with flash 2 + 2 + 2 times a
    prefill (encoder, decoder, cross at S == T) and none a decode step, the
    plain run and the causal forward within ``LM_TOL``, a bidirectional
    mask and a causal encoder each moving the logits past 3 ``LM_TOL``;
    the prefill at Whisper's shape (cut here to 40 frames and 12 tokens:
    cross-attention plain, 4 launches); training uncut at this size with
    frames, 2 x 6 LSE forwards and 6 backwards a step; the gradients'
    rounding account at its full depth (here the kernel's stand-in is the
    plain math: the kernel and plain runs equal, the kernel no further
    from the fp32 run than the plain run); a wrong count fails it."""
    smoke = _load_smoke()
    fa, real = _count_wrapper_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "WHISPER_FRAMES", 40)
    monkeypatch.setattr(smoke, "WHISPER_TEXT", 12)

    def profiled(name, call, top=8):  # the card's trace, stubbed
        call()
        return {"wall_ms": 1.0, "device_ms": 1.0, "busy_share": 1.0,
                "ported_kernels_ms": 0.5, "ported": {}, "host_ops": 1,
                "top": [("flash_fwd_bf16", 0.5)]}

    monkeypatch.setattr(smoke, "profiled", profiled)
    cpu = torch.device("cpu")
    r = smoke.phase_whisper(cpu, profiled)
    s, lp, t = r["serve"], r["long_prefill"], r["train"]
    smoke.say_big_serve(24, s, "card", 1.0, "encoder-decoder, ")
    smoke.say_big_train(24, t, "card", 1.0)
    assert s["launches"]["flash_attention"] == 6
    assert s["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert s["causal_max_abs_err"] <= smoke.LM_TOL
    assert s["wrong_mask_max_abs_err"] > 3 * smoke.LM_TOL
    assert s["causal_encoder_max_abs_err"] > 3 * smoke.LM_TOL
    assert lp["launches"]["flash_attention"] == 4
    assert lp["plain_max_abs_err"] == 0.0
    assert tconfigs.train_microbatches(ARCH) == 1
    assert t["launches_per_step"]["flash_attention_lse"] == 2 * 6
    assert t["launches_per_step"]["flash_attention_bwd"] == 6
    assert t["plain"]["loss_rel_err"] == 0.0
    ga = r["grad_account"]
    assert ga["layers"] == [2, 2] and ga["kernel_vs_plain"]["rel_err"] == 0.0
    assert 0 < ga["kernel_vs_f32"]["rel_err"] == ga["plain_vs_f32"]["rel_err"]
    assert 0 < ga["rounded_vs_plain"]["rel_err"] <= smoke.TRAIN_GRAD_TOL
    assert all(math.isfinite(x) for x in t["loss"] + t["grad_norm"])
    full = tconfigs.get_config(ARCH)
    assert smoke.attn_layers(full) == 18 and smoke.attn_layers(full, False) == 12
    want = smoke.train_launches(full, 1)
    assert (want["flash_attention_lse"], want["flash_attention_bwd"]) == (36, 18)
    assert ARCH in smoke.TINY_SERVE_ARCHS and ARCH not in smoke.TINY_TRAIN_ARCHS
    monkeypatch.setattr(fa, "flash_attention_bwd", real["flash_attention_bwd"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_whisper(cpu, profiled)
