"""The port's LM serving path (repro_torch.models, train.steps,
launch.serve) against the JAX package's, on the CPU at tiny size.

The same numpy inputs and the same weights (the reference's params,
carried over by ``params_from_jax``) go through both. Tolerances:
- fp32 configs (``dtype`` and ``param_dtype`` float32): 1e-5 absolute and
  relative on logits of std ~0.2-0.4 (the two run the same fp32 math; sums
  over d_model run in another order), 1e-5 on the layers.
- bf16 (the served dtype): 3e-2, as ``tests/test_serve.py``. The port's
  prefill attention runs the flash kernel's function (``attention_ref`` on
  the CPU) in fp32, where the reference's einsum attention rounds its
  scores and probabilities to bf16, so prefill logits differ at the bf16
  level.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JNN  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import ShardingRules  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TNN  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCHS = ["llama3-8b", "granite-3-2b", "stablelm-12b"]
# the MoE family's archs: tests/test_torch_moe.py holds their models
MOE_ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
# the MLA arch: tests/test_torch_mla.py holds its model
MLA_ARCHS = ["minicpm3-4b"]
# the VLM and the Mamba2 hybrid: tests/test_torch_vlm.py and
# tests/test_torch_hybrid.py hold their models
VLM_HYBRID_ARCHS = ["internvl2-76b", "zamba2-1.2b"]
# xLSTM and the encoder-decoder: tests/test_torch_xlstm.py and
# tests/test_torch_encdec.py hold their models
SSM_AUDIO_ARCHS = ["xlstm-1.3b", "whisper-base"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _cfgs(arch, dt):
    jdt, tdt = DTYPES[dt]
    return (jconfigs.get_tiny(arch).replace(dtype=jdt, param_dtype=jdt),
            tconfigs.get_tiny(arch).replace(dtype=tdt, param_dtype=tdt))


@functools.cache
def _models(arch, dt):
    """(jax model, jax params, port model with the same weights)."""
    jcfg, tcfg = _cfgs(arch, dt)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tm.lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg))
    return jm, params, tm


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)) \
        .astype(np.int32)


# --- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + MLA_ARCHS +
                         VLM_HYBRID_ARCHS + SSM_AUDIO_ARCHS)
@pytest.mark.parametrize("which", ["get_config", "get_tiny"])
def test_config_copies_the_reference_value_for_value(arch, which):
    j = getattr(jconfigs, which)(arch)
    t = getattr(tconfigs, which)(arch)
    for f in dataclasses.fields(JModelConfig):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(tv).endswith(jnp.dtype(jv).name), f.name
        else:
            assert tv == jv, f.name
    assert (t.hd, t.padded_vocab) == (j.hd, j.padded_vocab)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]


def test_every_ported_config_has_flash_kernel_instances():
    """The card's attention has an instance for the head dims of every
    ported arch with attention (all but xLSTM's), full size and TINY: (hd,
    hd), or MLA's (nope + rope, v); a pair without one raises there."""
    from repro_torch.kernels.flash_attention import KERNEL_HEAD_DIMS

    assert sorted(tconfigs.ARCH_IDS) == sorted(
        ARCHS + MOE_ARCHS + MLA_ARCHS + VLM_HYBRID_ARCHS + SSM_AUDIO_ARCHS)
    for arch in tconfigs.ARCH_IDS:
        if tconfigs.get_config(arch).family == "ssm":
            continue
        for cfg in (tconfigs.get_config(arch), tconfigs.get_tiny(arch)):
            widths = ((cfg.mla_nope_dim + cfg.mla_rope_dim, cfg.mla_v_dim)
                      if cfg.attn_kind == "mla" else (cfg.hd, cfg.hd))
            assert widths in KERNEL_HEAD_DIMS, (arch, widths)


def test_unported_arch_raises_naming_the_roadmap():
    """Every arch of the reference is registered; pod compression on a
    model without a pod axis raises ``ValueError`` (the reference asserts a
    multi-pod mesh), an unknown arch raises ``KeyError`` and an unknown
    family ``ValueError``."""
    from repro_torch.models.factory import network
    from repro_torch.train import steps as tsteps

    assert sorted(tconfigs.ARCH_IDS) == sorted(jconfigs.ARCH_IDS)
    with pytest.raises(ValueError, match="family"):
        network(tconfigs.get_tiny("llama3-8b").replace(family="no-such"),
                torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pod"):
        tsteps.make_train_step(build_model(tconfigs.get_tiny("llama3-8b"),
                                           "cpu"), None, compress_pod=True)
    with pytest.raises(KeyError):
        tconfigs.get_tiny("no-such-arch")


# --- layers, leaf for leaf ------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_matches_reference(dt):
    jdt, tdt = DTYPES[dt]
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 5, 64)) * 3
    scale = 1 + 0.1 * r.standard_normal(64)
    want = JNN.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), 1e-5)
    got = TNN.rms_norm(_t(x, tdt), _t(scale, tdt), 1e-5)
    assert got.dtype == tdt
    # bf16: the elementwise products round to bf16 in both; one ulp apart
    # at most where the fp32 statistics differ in their last bit
    _close(got, want, 1e-5 if dt == "f32" else 1e-2)


@pytest.mark.parametrize("theta,dim", [(500000.0, 128), (10000.0, 64)])
def test_rope_matches_reference(theta, dim):
    r = np.random.default_rng(2)
    pos = np.array([0, 1, 7, 1023, 1055], np.int32)
    js, jc = JNN.rope_tables(jnp.asarray(pos), dim, theta)
    ts, tc = TNN.rope_tables(torch.from_numpy(pos), dim, theta)
    # fp32 sin/cos of angles up to ~1e3: an ulp of the angle
    _close(ts, js, 1e-4)
    _close(tc, jc, 1e-4)
    x = r.standard_normal((2, len(pos), 4, dim))
    for jdt, tdt in DTYPES.values():
        want = JNN.apply_rope(jnp.asarray(x, jdt), js, jc)
        got = TNN.apply_rope(_t(x, tdt), _t(np.asarray(js), torch.float32),
                             _t(np.asarray(jc), torch.float32))
        assert got.dtype == tdt
        _close(got, want, 1e-5 if tdt == torch.float32 else 1e-2)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_matches_reference(kind, dt):
    jdt, tdt = DTYPES[dt]
    jcfg = jconfigs.get_tiny("llama3-8b").replace(param_dtype=jdt)
    p, _ = JNN.init_mlp(jax.random.PRNGKey(3), 64, 128, jcfg,
                        ShardingRules({}, False), kind=kind)
    x = np.random.default_rng(3).standard_normal((2, 5, 64))
    want = JNN.mlp_fwd(p, jnp.asarray(x, jdt))
    got = TNN.mlp_fwd({k: _t(_np(v), tdt) for k, v in p.items()}, _t(x, tdt))
    _close(got, want, TOL[dt])


def _llama_geometry(dt):
    """llama3-8b's head geometry (H 32, KV 8, hd 128) at a narrow d_model."""
    jdt, tdt = DTYPES[dt]
    kw = dict(num_layers=1, d_model=64, d_ff=128, vocab_size=512)
    return (jconfigs.get_config("llama3-8b").replace(dtype=jdt, param_dtype=jdt,
                                                     **kw),
            tconfigs.get_config("llama3-8b").replace(dtype=tdt, param_dtype=tdt,
                                                     **kw))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_causal_with_cache_then_decode_matches_reference(dt):
    jcfg, tcfg = _llama_geometry(dt)
    jdt, tdt = DTYPES[dt]
    p, _ = JNN.init_attention(jax.random.PRNGKey(4), jcfg, ShardingRules({}, False))
    tp = {k: _t(_np(v), tdt) for k, v in p.items()}
    r = np.random.default_rng(4)
    B, S, S_max = 2, 9, 12
    x = r.standard_normal((B, S, 64))
    xd = r.standard_normal((B, 1, 64))
    tol = TOL[dt]

    # causal prefill into a bigger cache
    rope_j = JNN.rope_tables(jnp.arange(S), jcfg.hd, jcfg.rope_theta)
    rope_t = TNN.rope_tables(torch.arange(S), tcfg.hd, tcfg.rope_theta)
    jc = JNN.init_attn_cache(jcfg, B, S_max)
    tc = TNN.init_attn_cache(tcfg, B, S_max, "cpu")
    jo, jc = jax.jit(lambda *a: JNN.attention_fwd(
        *a[:2], jcfg, mode="causal", rope=a[2], cache=a[3]))(
        p, jnp.asarray(x, jdt), rope_j, jc)
    to, tc2 = TNN.attention_fwd(tp, _t(x, tdt), tcfg, mode="causal",
                                rope=rope_t, cache=tc)
    assert tc2 is tc  # written in place
    _close(to, jo, tol, "causal out")
    _close(tc["k"], jc["k"], tol, "cache k")
    _close(tc["v"], jc["v"], tol, "cache v")
    assert not tc["k"][:, S:].any()

    # decode one token at pos S, against the reference's own cache
    tc = {n: _t(_np(v), tdt) for n, v in jc.items()}
    rope_j = JNN.rope_tables(jnp.arange(1) + S, jcfg.hd, jcfg.rope_theta)
    rope_t = TNN.rope_tables(torch.arange(1) + S, tcfg.hd, tcfg.rope_theta)
    jo, jc = jax.jit(lambda *a: JNN.attention_fwd(
        *a[:2], jcfg, mode="decode", rope=a[2], cache=a[3], pos=a[4]))(
        p, jnp.asarray(xd, jdt), rope_j, jc, jnp.int32(S))
    to, tc = TNN.attention_fwd(tp, _t(xd, tdt), tcfg, mode="decode",
                               rope=rope_t, cache=tc, pos=S)
    # decode runs the reference's einsum math in both: bf16 to its ulp
    _close(to, jo, 1e-5 if dt == "f32" else 1e-2, "decode out")
    _close(tc["k"], jc["k"], 1e-5 if dt == "f32" else 1e-2, "decode cache k")


# --- params, init ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_loads_every_leaf_exactly(arch):
    jm, params, tm = _models(arch, "bf16")
    sd = tm.lm.state_dict()
    tree = jax.tree.map(np.asarray, params)
    assert set(sd) == set(params_from_jax(tree, tm.cfg))
    L = tm.cfg.num_layers
    per_layer = len(jax.tree.leaves(params["layers"]))
    top = len(jax.tree.leaves(params)) - per_layer
    assert len(sd) == per_layer * L + top
    for i in range(L):
        for name, leaf in params["layers"]["attn"].items():
            got = sd[f"layers.{i}.attn.{name}"]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), _np(leaf[i]))
    np.testing.assert_array_equal(sd["embed"].float().numpy(),
                                  _np(params["embed"]["table"]))


def test_init_leaves_follow_the_reference_distributions():
    cfg = tconfigs.get_tiny("llama3-8b").replace(vocab_size=4000, d_ff=256)
    g = torch.Generator().manual_seed(7)
    m = build_model(cfg, "cpu", generator=g)
    sd = m.lm.state_dict()
    jcfg = jconfigs.get_tiny("llama3-8b").replace(vocab_size=4000, d_ff=256)
    jp = jax.eval_shape(lambda k: jbuild(jcfg).init(k), jax.random.PRNGKey(0))
    assert set(sd) == set(params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jp), cfg))
    want_std = {"embed": 0.02, "lm_head": 1 / math.sqrt(cfg.padded_vocab),
                "attn.wq": 1 / 8, "attn.wk": 1 / 8, "attn.wv": 1 / 8,
                "attn.wo": 1 / 8, "mlp.wi": 1 / 8, "mlp.wg": 1 / 8,
                "mlp.wo": 1 / 16}
    for name, t in sd.items():
        assert t.dtype == torch.bfloat16 and not t.requires_grad, name
        if name.endswith(("ln1", "ln2", "final_norm")):
            assert torch.equal(t, torch.ones_like(t)), name
            continue
        std = next(v for k, v in want_std.items() if name.endswith(k))
        n = t.numel()
        got = float(t.float().std())
        # sample std of n normals: relative error ~ 1/sqrt(2n); 5 sigma
        assert abs(got / std - 1) < 5 / math.sqrt(2 * n) + 0.01, (name, got, std)
        assert abs(float(t.float().mean())) < 5 * std / math.sqrt(n), name
    # the untied head's fan-in is its first dim, the padded vocab
    assert sd["lm_head"].shape == (cfg.padded_vocab, cfg.d_model)
    assert cfg.padded_vocab == 4096
    # the same seed gives the same weights; another gives others
    again = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(again.lm.state_dict()[k], v) for k, v in sd.items())
    other = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(8)) \
        .lm.state_dict()
    assert not torch.equal(other["embed"], sd["embed"])


def test_build_model_needs_a_card_unless_asked_for_the_cpu():
    cfg = tconfigs.get_tiny("llama3-8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present, so 'cuda' resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(NotImplementedError):
        build_model(cfg.replace(family="ssm"), "cpu")


# --- the whole model ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_forward_logits_match_reference(arch, dt):
    jm, params, tm = _models(arch, dt)
    toks = _tokens(tm.cfg, 2, 12)
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, tokens=t, mode="causal",
                                               cache=None, pos=None))(
        params, jnp.asarray(toks))
    tl, cache, _ = tm.forward(tokens=torch.from_numpy(toks))
    assert cache is None and tl.shape == (2, 12, tm.cfg.padded_vocab)
    _close(tl, jl, TOL[dt])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_steps_match_reference(arch, dt):
    jm, params, tm = _models(arch, dt)
    B, S_p, S_gen = 2, 8, 4
    toks = _tokens(tm.cfg, B, S_p + S_gen, seed=1)
    tol = TOL[dt]
    # jitted, as the reference launcher runs them
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    assert tl.shape == (B, tm.cfg.padded_vocab)  # untrimmed, as the reference
    assert tc["k"].shape == (tm.cfg.num_layers, B, S_p + S_gen,
                             tm.cfg.num_kv_heads, tm.cfg.hd)
    _close(tl, jl, tol, "prefill")
    _close(tc["k"], jc["k"], tol, "prefill cache")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        assert tl.shape == (B, tm.cfg.vocab_size)  # trimmed
        _close(tl, jl, tol, f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_the_reference_serve_loop(arch):
    jm, params, tm = _models(arch, "f32")
    B, S, gen = 2, 8, 6
    toks = _tokens(tm.cfg, B, S, seed=2)
    # the reference launcher's loop (launch/serve.py), jitted as it is there
    prefill = jax.jit(j_prefill(jm, S + gen))
    decode = jax.jit(j_decode(jm))
    logits, cache = prefill(params, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok, jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
    res = serve.generate(tm, torch.from_numpy(toks), gen, keep_logits=True)
    np.testing.assert_array_equal(res.tokens.numpy(), np.concatenate(want, 1))
    assert res.tokens.dtype == torch.int32 and len(res.logits) == gen
    assert res.logits[0].shape[-1] == tm.cfg.padded_vocab
    assert res.logits[1].shape[-1] == tm.cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_port_prefill_decode_matches_its_causal_forward(arch, dt):
    """tests/test_serve.py's invariant on the port: prefill + decode logits
    equal one causal forward over prompt + fed tokens, teacher-forced."""
    _, _, tm = _models(arch, dt)
    B, S_p, gen = 2, 8, 5
    toks = torch.from_numpy(_tokens(tm.cfg, B, S_p + gen, seed=3))
    res = serve.generate(tm, toks[:, :S_p], gen, forced=toks[:, S_p:],
                         keep_logits=True)
    full, _, _ = tm.forward(tokens=toks[:, :S_p + gen - 1])
    V = tm.cfg.vocab_size
    for i, got in enumerate(res.logits):
        np.testing.assert_allclose(
            got[:, :V].float().numpy(), full[:, S_p - 1 + i, :V].float().numpy(),
            atol=TOL[dt], rtol=TOL[dt], err_msg=f"step {i}")
    # teacher forcing fed the given tokens: the cache holds their keys
    res2 = serve.generate(tm, toks[:, :S_p], gen, forced=toks[:, S_p:])
    assert torch.equal(res2.cache["k"], res.cache["k"])


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "granite-3-2b", "--tiny", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and "tok/s" in out[0]
    assert out[1].startswith("generated token ids (first row): [")


def test_prefill_runs_the_seam_once_a_layer_and_decode_never(monkeypatch):
    _, _, tm = _models("llama3-8b", "bf16")
    calls = []
    real = tops.attention
    monkeypatch.setattr(tops, "attention", lambda *a, **kw: calls.append(
        tuple(a[0].shape)) or real(*a, **kw))
    res = serve.generate(tm, torch.ones((2, 8), dtype=torch.int32), 4)
    assert calls == [(2, 8, 4, 16)] * tm.cfg.num_layers
    assert res.tokens.shape == (2, 4)
    # CPU tensors take the plain version: no launch counted
    assert flash_attention.launches == 0


def test_chip_smoke_serving_phases_rehearse_on_the_cpu(monkeypatch):
    """chip_smoke.py's serving phases (8-10 but the traces) at tiny size on
    the CPU: the plain version on both sides, with the kernel wrapper's
    count simulated (a CPU tensor launches nothing), so the launch checks,
    the teacher-forced comparison and the causal invariant run as on the
    card; and a wrong count or a wrong logit fails them."""
    import importlib.util
    import os

    from repro_torch.kernels import flash_attention as fa_module

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counted = smoke.KERNELS["flash_attention"][0]
    real = fa_module.flash_attention

    def launch(*a, **kw):
        counted.launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(fa_module, "flash_attention", launch)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cpu = torch.device("cpu")
    model, tokens, gen, counts, _, _, n_params = smoke.phase_serve(cpu)
    assert counts["flash_attention"] == model.cfg.num_layers == 2
    assert n_params == sum(p.numel() for p in model.lm.state_dict().values())
    agree = smoke.phase_serve_plain(model, tokens, gen)
    assert agree["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert agree["causal_max_abs_err"] <= smoke.LM_TOL
    assert agree["plain_same_greedy_tokens"] == 2 * 4
    assert agree["tokens_checked"] <= 2 * 4
    times = smoke.phase_serve_times(model, tokens, reps=1)
    assert times["prefill_ms"] > 0 and times["decode_tokens_per_s"] > 0
    gen.logits[3] = gen.logits[3] + 1.0  # one step's logits off
    with pytest.raises(smoke.CheckFailed):
        smoke.phase_serve_plain(model, tokens, gen)
    monkeypatch.setattr(fa_module, "flash_attention", real)  # no count
    with pytest.raises(smoke.CheckFailed, match="once a layer"):
        smoke.phase_serve(cpu)
