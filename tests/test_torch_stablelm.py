"""stablelm-12b on the port: its head dim, 160, is the flash kernels' widest.

The reference's TINY configs have head dim 16 (``tests/test_torch_models.py``
holds stablelm-12b's TINY beside llama3-8b's and granite-3-2b's), so a
narrow stablelm-shaped model keeps the real head dim: 2 layers, d_model
320, 2/1 heads of 160, d_ff 256, vocab 512, fp32. The reference's
parameters and train state are carried across by ``models/convert.py``;
logits, prefill, decode steps, the loss and every gradient leaf are held
against the JAX package within 1e-5 (the two run the same fp32 math, sums
in another order; of the largest value for the gradients), and the plain
attention backward at hd 160 against ``jax.grad`` of the reference's
einsum attention within 1e-5 of the largest gradient. Then chip_smoke.py's
phases 17 (stablelm-12b served and trained) and 18 (the ``--tiny``
launcher commands) rehearse on the CPU at the TINY size.
"""
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
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "stablelm-12b"
NARROW = dict(num_layers=2, d_model=320, num_heads=2, num_kv_heads=1,
              head_dim=160, d_ff=256, vocab_size=512)
TOL = 1e-5
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


def _cfgs():
    j = jconfigs.get_config(ARCH).replace(**NARROW, dtype=jnp.float32,
                                           param_dtype=jnp.float32)
    t = tconfigs.get_config(ARCH).replace(**NARROW, dtype=torch.float32,
                                           param_dtype=torch.float32)
    return j, t


def _setup():
    """(jax model, its TrainState, port model, the port's state from it)."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    ts = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tcfg))
    return jm, js, tm, ts


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        1, NARROW["vocab_size"], (b, s)).astype(np.int32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


def test_narrow_model_keeps_the_kernels_widest_head_dim():
    _, tcfg = _cfgs()
    assert tcfg.hd == 160 == tconfigs.get_config(ARCH).hd
    assert (tcfg.hd, tcfg.hd) in fa.KERNEL_HEAD_DIMS and not tcfg.tie_embeddings


def test_narrow_logits_match_reference():
    jm, js, tm, _ = _setup()
    toks = _tokens(2, 12, seed=0)
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, tokens=t, mode="causal",
                                               cache=None, pos=None))(
        js.params, jnp.asarray(toks))
    tl, _, _ = tm.forward(tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 12, tm.cfg.padded_vocab)
    _close(tl, jl)


def test_narrow_prefill_and_decode_steps_match_reference():
    jm, js, tm, _ = _setup()
    B, S_p, S_gen = 2, 8, 4
    toks = _tokens(B, S_p + S_gen, seed=1)
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    assert tc["k"].shape == (2, B, S_p + S_gen, 1, 160)
    _close(tl, jl, "prefill")
    _close(tc["k"], jc["k"], "prefill cache")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        _close(tl, jl, f"decode step {i}")


def test_narrow_loss_and_every_gradient_leaf_match_jax_grad():
    jm, js, tm, ts = _setup()
    r = np.random.default_rng(2)
    toks = _tokens(4, 16, seed=3)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, 4).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)}
    tb = {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)}
    jl, _ = jm.loss_fn(js.params, jb)
    tl, _ = tm.loss_fn(tb)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    assert abs(float(tl) - math.log(tm.cfg.padded_vocab)) < 0.5
    jg = jax.grad(lambda p: jm.loss_fn(p, jb)[0])(js.params)
    tg, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want) and "lm_head" in tg  # untied
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= TOL * scale, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv", [(7, 2, 1), (33, 4, 2)])
def test_plain_backward_at_hd160_matches_jax_grad(causal, s, h, kv):
    """The plain backward the wrappers take on the CPU (``attention_bwd_ref``
    under ``flash_attention_bwd``) and autograd through the seam, at hd 160,
    against ``jax.grad`` of the reference's einsum attention."""
    r = np.random.default_rng(s + h)
    q, k, v, do = (r.standard_normal(shape).astype(np.float32) for shape in (
        (2, s, h, 160), (2, s, kv, 160), (2, s, kv, 160), (2, s, h, 160)))
    want = jax.grad(lambda q, k, v: jnp.sum(
        JNN._sdpa(q, k, v, causal=causal) * do), argnums=(0, 1, 2))(q, k, v)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    plain = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    seam = torch.autograd.grad(tops.attention(*leaves, causal=causal), leaves,
                               tdo)
    for got in (plain, seam):
        for a, w in zip(got, want):
            assert float(np.abs(a.numpy() - np.asarray(w)).max()) <= TOL * scale


# --- chip_smoke.py's phases 17 and 18, rehearsed -----------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_wrapper_calls(monkeypatch, smoke):
    """A CPU tensor launches nothing: count each flash wrapper's calls, and
    the histogram's (the MoE archs' dispatch), as their launches, and route
    training through ``FlashAttentionFn`` (whose wrappers take their plain
    versions here), as on the card."""
    from repro_torch.kernels import histogram

    counted = {n: smoke.KERNELS[n][0] for n in smoke.LM_KERNELS +
               ("bucket_histogram",)}
    modules = {n: fa for n in smoke.LM_KERNELS}
    modules["bucket_histogram"] = histogram
    real = {n: getattr(modules[n], n) for n in counted}

    def counting(name):
        def launch(*a, **kw):
            counted[name].launches += 1
            return real[name](*a, **kw)
        return launch

    for name in counted:
        monkeypatch.setattr(modules[name], name, counting(name))
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


def test_chip_smoke_stablelm_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 17 at stablelm-12b's TINY size (head dim 16 here; the card runs
    160): serving with one flash call a layer and none a decode step,
    logits against the plain run; training at 2 of the layers with the
    kernel-against-plain check, 2 x layers x 8 LSE forwards and layers x 8
    backwards a step; a wrong count fails it."""
    smoke = _load_smoke()
    real = _count_wrapper_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "BIG_TRAIN_LAYERS", 2)
    cpu = torch.device("cpu")
    serve = smoke.phase_big_serve(cpu)
    assert serve["arch"] == smoke.BIG_ARCH
    assert serve["launches"]["flash_attention"] == 2
    assert serve["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert serve["prefill_logit_std"] > 3 * smoke.LM_TOL
    train = smoke.phase_big_train(cpu)
    k = tconfigs.train_microbatches(smoke.BIG_ARCH)
    assert k == 8 and train["microbatches"] == k
    assert train["launches_per_step"]["flash_attention_lse"] == 2 * 2 * k
    assert train["launches_per_step"]["flash_attention_bwd"] == 2 * k
    assert train["launches"]["flash_attention_lse"] == \
        smoke.BIG_TRAIN_STEPS * 2 * 2 * k
    assert train["plain"]["loss_rel_err"] == 0.0
    assert all(math.isfinite(x) for x in train["loss"])
    # untied: the input embedding (a gather) is not counted in 6N
    assert train["flops_per_token"] < 6 * train["parameters"] + \
        6 * 2 * 4 * 16 * (smoke.TRAIN_SEQ + 1)
    monkeypatch.setattr(fa, "flash_attention_bwd", real["flash_attention_bwd"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_big_train(cpu)


def test_chip_smoke_tiny_commands_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 18 on the CPU: the launchers' ``cuda`` resolved to the CPU for
    the 'card' side, so both runs are the same plain math and agree
    exactly; the launch checks run as on the card, and a wrong count or a
    wrong loss fails them."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    smoke = _load_smoke()
    real = _count_wrapper_calls(monkeypatch, smoke)
    cpu = torch.device("cpu")
    for mod in (serve_cli, train_cli):
        monkeypatch.setattr(mod, "resolve_device", lambda d: cpu)
    monkeypatch.setattr(smoke, "TINY_TRAIN_STEPS", 2)
    real_main = train_cli.main
    # the launcher's default batch and sequence, cut for the CPU
    monkeypatch.setattr(train_cli, "main", lambda argv: real_main(
        argv + ["--batch", "4", "--seq", "32"]))
    out = smoke.phase_tiny(cpu)
    assert sorted(out["serve"]) == sorted(smoke.TINY_SERVE_ARCHS)
    # flash once an attention layer: 2 for the TINY transformers and the
    # hybrid's two periods, none for xLSTM, 2 + 2 + 2 for the
    # encoder-decoder (encoder, decoder, cross at as many frames as tokens)
    for arch, r in out["serve"].items():
        n = smoke.attn_layers(tconfigs.get_tiny(arch))
        assert n == {"xlstm-1.3b": 0, "whisper-base": 6}.get(arch, 2)
        assert r["hd"] == 16 and r["launches"]["flash_attention"] == n
        assert r["prefill_max_abs_err"] == 0.0 and r["same_tokens"] == r["tokens"]
    for arch, r in out["train"].items():
        n = smoke.attn_layers(tconfigs.get_tiny(arch))
        assert r["hd"] == 16 and r["max_loss_diff"] == 0.0
        assert r["launches"]["flash_attention_lse"] == 2 * n * 2
        assert r["launches"]["flash_attention_bwd"] == n * 2
        assert len(r["loss"]) == 2
    monkeypatch.setattr(smoke, "TINY_LOSS_TOL", -1.0)
    with pytest.raises(smoke.CheckFailed, match="losses"):
        smoke.phase_tiny(cpu)
    monkeypatch.setattr(fa, "flash_attention", real["flash_attention"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_tiny(cpu)


@pytest.mark.parametrize("arch", ["granite-3-2b", "stablelm-12b", "minicpm3-4b"])
def test_tiny_loss_tolerance_tells_a_wrong_mask_from_the_kernels_rounding(
        arch, monkeypatch):
    """Phase 18's ``TINY_LOSS_TOL`` on the command it checks (``launch.train
    --tiny --steps 3`` at its default batch and sequence, CPU): the
    kernel's rounding of P to bf16 moves each step's loss by less than a
    third of it, a bidirectional mask by more than twice it."""
    from repro_torch.launch import train as train_cli

    tol = _load_smoke().TINY_LOSS_TOL
    real = tops.attention

    def losses(attention):
        monkeypatch.setattr(tops, "attention", attention)
        hist = train_cli.main(["--arch", arch, "--tiny", "--steps", "3",
                               "--log-every", "1", "--device", "cpu"])
        return np.array([m["loss"] for m in hist])

    plain = losses(real)
    rounded = losses(tref.attention_rounding_p)
    unmasked = losses(lambda q, k, v, causal=True: real(q, k, v, causal=False))
    assert np.abs(rounded - plain).max() < tol / 3
    assert np.abs(unmasked - plain).max() > 2 * tol
