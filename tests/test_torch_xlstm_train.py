"""xlstm-1.3b's training, checkpoints and launchers on the port against the
JAX package's, on the CPU, and chip_smoke.py's phase 23 rehearsed
(``tests/test_torch_xlstm.py`` holds the blocks, logits and serving).

The reference's TINY config: 6 blocks in 2 periods of 2 mLSTM blocks and
1 sLSTM block (``slstm_every`` 3), d_model 64, 4 heads (mLSTM head dim
32), chunk 8; and the same with 7 blocks (``REM``), whose last mLSTM block
trails the periods, as neither CONFIG nor TINY has one. The same numpy
inputs and the same weights (the reference's, carried over by
``models/convert.py``) go through both; the reference runs with
``mesh=None``.

Tolerances, fp32: the loss within 1e-5 (relative), every gradient leaf
and the optimizer's moments within ``GRAD_TOL`` of their largest value
(sums in another order).

Compared: the loss and every gradient leaf, one AdamW step over two
microbatches from ``train_state_from_jax``, a checkpoint across
packages, the launchers, and chip_smoke.py's phase 23 on the CPU.
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
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ARCH = "xlstm-1.3b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 5e-2}
GRAD_TOL = 5e-5
REM = {"num_layers": 7}  # 2 periods and one trailing mLSTM block
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLSTM_LEAVES = ["b_fg", "b_ig", "conv_w", "down", "gnorm", "ln", "skip", "up",
                "w_fg", "w_ig", "wk", "wq"]
SLSTM_LEAVES = ["b_f", "b_i", "gnorm", "ln", "ln2", "mlp.wg", "mlp.wi",
                "mlp.wo", "wf", "wi", "wo", "wz"]


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


@functools.cache
def _models(dt, rem=False):
    """(jax model, its TrainState, port model with the state's weights, the
    port's state)."""
    jcfg, tcfg = _cfgs(dt, **(REM if rem else {}))
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
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)})


@pytest.mark.parametrize("rem", [False, True])
def test_loss_and_every_gradient_leaf_match_jax_grad(rem):
    """fp32, a 20-token batch (two chunks and a padded third), every leaf."""
    jm, js, tm, ts = _models("f32", rem)
    jb, tb = _batch(s=20)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, jb)[0]))(
        js.params)
    tg, met = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    tl = met["loss"]
    assert abs(float(tl) - float(jl)) <= TOL["f32"] * abs(float(jl))
    assert abs(float(tl) - math.log(tm.cfg.padded_vocab)) < 0.5
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want) == set(dict(tm.lm.named_parameters()))
    assert {n.split(".", 2)[-1] for n in tg if n.startswith("mlstm.")} == \
        set(MLSTM_LEAVES)
    assert {n.split(".", 2)[-1] for n in tg if n.startswith("slstm.")} == \
        set(SLSTM_LEAVES)
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= GRAD_TOL * scale, name
        assert float(g.abs().max()) > 0, name


def test_train_step_matches_reference_over_microbatches():
    """Two microbatches, fp32: the metrics, the grad norm, and every leaf's
    moments and master after the step (the masters held as
    tests/test_torch_hybrid.py holds them). Weight decay follows the
    reference's stacked ranks: the per-head gate biases (H,) and the
    per-block norms are decayed (stacked there), ``final_norm`` is not."""
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


# --- checkpoints across packages, the launchers ----------------------------------------


def _numpy_tree(tree):
    import ml_dtypes

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return jax.tree.map(leaf, tree)


def test_xlstm_checkpoint_reads_across_packages(tmp_path):
    """A bf16 xLSTM train state saved by the port loads in the reference, and
    the reference's save of it loads back into the port bit for bit."""
    tm = build_model(tconfigs.get_tiny(ARCH), "cpu")
    state = tsteps.init_train_state(tm, 0)
    _, tb = _batch(seed=4)
    state, _ = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1))(
        state, tb)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    assert "params_mlstm.0.wq" in names and "opt_m_slstm.1.mlp.wo" in names
    saved = [t.clone() for _, t in ckpt._leaf_paths(state)]
    d = str(tmp_path / "port")
    ckpt.save(d, 1, state)
    like = jsteps.TrainState(params=_numpy_tree(dict(state.params)),
                             opt=_numpy_tree(JOptState(*state.opt)),
                             step=_numpy_tree(state.step), ef=None)
    got = jckpt.restore(d, 1, like)
    jd = str(tmp_path / "ref")
    jckpt.save(jd, 2, got)
    restored = ckpt.restore(jd, 2, tsteps.init_train_state(tm, 7))
    for (name, a), b in zip(ckpt._leaf_paths(restored), saved):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_xlstm_launchers_run_on_the_cpu(capsys):
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
    assert sorted(res.cache) == ["mlstm", "slstm"]
    assert all(math.isfinite(h["loss"]) for h in hist)


# --- chip_smoke.py's phase 23, on the CPU -------------------------------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _stub_cuda(monkeypatch):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_chip_smoke_xlstm_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 23 at xLSTM's TINY size: serving launches nothing, the fp32
    invariant within ``XLSTM_F32_TOL`` (measured here 5.5e-7), the states
    zeroed after the prefill moving the bf16 logits past 3 ``LM_TOL`` and
    the fp32 ones past 3 ``XLSTM_F32_TOL``, the bf16 serving logits within
    ``HYBRID_NOISE_RATIO`` of the bf16 causal forward's own distance from
    fp32; training uncut at this size in its 4 microbatches, no launch, the
    first loss near ln 512."""
    smoke = _load_smoke()
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)

    def profiled(name, call, top=8):  # the card's trace, stubbed
        call()
        return {"wall_ms": 1.0, "device_ms": 1.0, "busy_share": 1.0,
                "ported_kernels_ms": 0.0, "ported": {}, "host_ops": 1,
                "top": [("gemm", 0.5)]}

    monkeypatch.setattr(smoke, "profiled", profiled)
    cpu = torch.device("cpu")
    r = smoke.phase_xlstm(cpu, profiled)
    smoke.say_xlstm(r, "card", 1.0)
    s, t = r["serve"], r["train"]
    assert all(v == 0 for v in s["launches"].values())
    assert s["f32_causal_max_abs_err"] <= smoke.XLSTM_F32_TOL
    assert s["lost_carry_max_abs_err"] > 3 * smoke.LM_TOL
    assert s["bf16_serving_vs_f32"] <= \
        smoke.HYBRID_NOISE_RATIO * s["bf16_causal_vs_f32"]
    assert t["microbatches"] == 4 and len(t["loss"]) == 3
    assert all(v == 0 for v in t["launches"].values())
    assert all(math.isfinite(x) for x in t["loss"] + t["grad_norm"])
    full = tconfigs.get_config(ARCH)
    assert smoke.attn_layers(full) == 0
    assert ARCH in smoke.TINY_SERVE_ARCHS and ARCH in smoke.TINY_TRAIN_ARCHS
    monkeypatch.setattr(smoke, "XLSTM_F32_TOL", -1.0)
    with pytest.raises(smoke.CheckFailed, match="fp32"):
        smoke.phase_xlstm(cpu, profiled)
