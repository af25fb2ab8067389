"""xlstm-1.3b's xLSTM on the port (``repro_torch.models.xlstm``) against the
JAX package's (``repro/models/xlstm.py``), on the CPU.

The reference's TINY config: 6 blocks in 2 periods of 2 mLSTM blocks and
1 sLSTM block (``slstm_every`` 3), d_model 64, 4 heads (mLSTM head dim
32), chunk 8; and the same with 7 blocks (``REM``), whose last mLSTM block
trails the periods, as neither CONFIG nor TINY has one. The same numpy
inputs and the same weights (the reference's, carried over by
``models/convert.py``) go through both; the reference runs with
``mesh=None``.

Tolerances. fp32 within 1e-5 (the same math, sums in another order;
measured: the blocks 1.4e-6, logits 3.7e-6), the gradient leaves and the
optimizer's moments within ``GRAD_TOL`` of their largest value. bf16
within 5e-2 (measured: logits 0.023 at one element, their std 0.35; the
mLSTM block bit for bit; the sLSTM block 0.047 at one element of its
residual stream, its scan's fp32 sums composed in another tree): sigmoid,
SiLU and the normalizer round as the reference's, the bf16 chunk products
sum in another order, and 6 blocks carry it.

Compared here: each block leaf for leaf (chunked, with a cache, one
decode step), the whole model's logits, prefill and decode steps with
their states, and the parameters and train state across packages;
``tests/test_torch_xlstm_train.py`` holds the loss and gradients, the
train step, checkpoints, the launchers and phase 23's rehearsal.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "xlstm-1.3b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 5e-2}
GRAD_TOL = 5e-5
REM = {"num_layers": 7}  # 2 periods and one trailing mLSTM block
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


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _close_state(got, want, tol, msg=""):
    """A cache or state within ``tol`` of its largest value."""
    scale = max(float(np.abs(_np(want)).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=tol * scale, rtol=0, err_msg=msg)


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


# --- the config and the structure ---------------------------------------------------


def test_xlstm_layout_follows_the_reference_periods():
    cfg = tconfigs.get_config(ARCH)
    jcfg = jconfigs.get_config(ARCH)
    assert TX.xl_counts(cfg) == JX._xl_counts(jcfg) == (6, 7, 0)
    assert TX._mlstm_dims(cfg) == JX._mlstm_dims(jcfg) == (4096, 4, 1024)
    assert TX._slstm_ff(cfg) == JX._slstm_ff(jcfg) == 2816
    for kw in ({}, REM):
        tiny = tconfigs.get_tiny(ARCH).replace(**kw)
        assert TX.xl_counts(tiny) == JX._xl_counts(
            jconfigs.get_tiny(ARCH).replace(**kw))
        cache = TX.init_xlstm_cache(tiny, 3, "cpu")
        want = jax.eval_shape(lambda: JX.init_xlstm_cache(
            jconfigs.get_tiny(ARCH).replace(**kw), 3, 20))
        for group in ("mlstm", "slstm"):
            assert sorted(cache[group]) == sorted(want[group])
            for name, t in cache[group].items():
                assert tuple(t.shape) == want[group][name].shape, (group, name)
                assert (t.dtype == torch.float32) == (
                    want[group][name].dtype == jnp.float32), (group, name)
    assert TX.xl_counts(tconfigs.get_tiny(ARCH).replace(**REM)) == (2, 2, 1)
    with pytest.raises(NotImplementedError):
        build_model(tconfigs.get_tiny(ARCH).replace(slstm_every=0), "cpu")
    with pytest.raises(NotImplementedError):
        build_model(tconfigs.get_tiny(ARCH), "cpu").forward(
            tokens=torch.ones((1, 2), dtype=torch.int32),
            embeds=torch.zeros((1, 1, 64)))


def test_full_size_parameter_count_is_the_references():
    """1.82 B parameters, from the reference's shapes (no weights drawn)."""
    jcfg = jconfigs.get_config(ARCH)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert 1.80e9 < n < 1.84e9
    periods, m_per, rem = TX.xl_counts(tconfigs.get_config(ARCH))
    assert jax.tree.leaves(shapes["mlstm"])[0].shape[0] == periods * m_per + rem


# --- the blocks, leaf for leaf --------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlstm_block_matches_reference(dt):
    """Chunked without a cache (S 11, padded to the chunk), chunked into a
    cache, then one decode step from it."""
    jm, js, tm, _ = _models(dt)
    jcfg, tcfg = jm.cfg, tm.cfg
    jp = jax.tree.map(lambda v: v[1], js.params["mlstm"])
    block = tm.lm.mlstm[1]
    for name in MLSTM_LEAVES:
        np.testing.assert_array_equal(block[name].float().numpy(), _np(jp[name]))
    tdt = DTYPES[dt][1]
    x = np.random.default_rng(2).standard_normal((2, 11, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.dtype), _t(x, tdt)
    fwd = jax.jit(functools.partial(JX.mlstm_fwd, cfg=jcfg),
                  static_argnames="decode")
    jc0 = JX.init_mlstm_cache(jcfg, 2)
    tc0 = {k: v[0] for k, v in TX.init_xlstm_cache(tcfg, 2, "cpu")["mlstm"]
           .items()}
    jy, jc = fwd(jp, jx, cache=jc0)
    ty, none = block(tx)
    assert none is None
    _close(ty, jy, TOL[dt], "chunked")
    ty, tc = block(tx, cache=tc0)
    _close(ty, jy, TOL[dt], "chunked into a cache")
    for name in ("conv", "state"):
        _close_state(tc[name], jc[name], TOL[dt], f"cache {name}")
    x1 = x[:, :1] + 0.5
    jy, jc = fwd(jp, jnp.asarray(x1, jcfg.dtype), cache=jc, decode=True)
    ty, tc = block(_t(x1, tdt), cache=tc, decode=True)
    _close(ty, jy, TOL[dt], "decode step")
    _close_state(tc["state"], jc["state"], TOL[dt], "decode state")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_block_matches_reference(dt):
    jm, js, tm, _ = _models(dt)
    jcfg, tcfg = jm.cfg, tm.cfg
    jp = jax.tree.map(lambda v: v[0], js.params["slstm"])
    block = tm.lm.slstm[0]
    sd = dict(block.named_parameters())
    for name in SLSTM_LEAVES:
        group, _, leaf = name.rpartition(".")
        want = jp[group][leaf] if group else jp[name]
        np.testing.assert_array_equal(sd[name].float().numpy(), _np(want))
    tdt = DTYPES[dt][1]
    x = np.random.default_rng(3).standard_normal((2, 11, 64)).astype(np.float32)
    fwd = jax.jit(functools.partial(JX.slstm_fwd, cfg=jcfg),
                  static_argnames="decode")
    jc0 = JX.init_slstm_cache(jcfg, 2)
    jy, jc = fwd(jp, jnp.asarray(x, jcfg.dtype), cache=jc0)
    ty, tc = block(_t(x, tdt), cache={
        k: torch.zeros((2, 64), dtype=torch.float32) for k in ("c", "n")})
    _close(ty, jy, TOL[dt], "scan")
    for name in ("c", "n"):
        _close_state(tc[name], jc[name], TOL[dt], f"state {name}")
    x1 = x[:, :1] - 0.5
    jy, jc = fwd(jp, jnp.asarray(x1, jcfg.dtype), cache=jc, decode=True)
    ty, tc = block(_t(x1, tdt), cache=tc, decode=True)
    _close(ty, jy, TOL[dt], "decode step")
    _close_state(tc["c"], jc["c"], TOL[dt], "decode c")


# --- the whole model ---------------------------------------------------------------------


@pytest.mark.parametrize("dt,rem", [("f32", False), ("bf16", False),
                                    ("f32", True)])
def test_xlstm_logits_match_reference(dt, rem):
    jm, js, tm, _ = _models(dt, rem)
    toks = _tokens(2, 20, seed=0)
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, tokens=t, mode="causal",
                                               cache=None, pos=None))(
        js.params, jnp.asarray(toks))
    tl, _, aux = tm.forward(tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 20, tm.cfg.padded_vocab)
    assert float(aux["moe_aux"]) == 0.0 and float(aux["moe_dropped"]) == 0.0
    _close(tl, jl, TOL[dt])


@pytest.mark.parametrize("dt,rem", [("f32", False), ("bf16", False),
                                    ("f32", True)])
def test_prefill_and_decode_steps_match_reference(dt, rem):
    jm, js, tm, _ = _models(dt, rem)
    B, S_p, S_gen = 2, 12, 5
    toks = _tokens(B, S_p + S_gen, seed=1)
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    assert sorted(tc) == ["mlstm", "slstm"]
    n_m = len(tm.lm.mlstm)
    assert tc["mlstm"]["state"].shape == (n_m, B, 4, 32, 33)
    _close(tl, jl, TOL[dt], "prefill")
    for group, name in (("mlstm", "state"), ("mlstm", "conv"), ("slstm", "c"),
                        ("slstm", "n")):
        _close_state(tc[group][name], jc[group][name], TOL[dt],
                     f"prefill {group} {name}")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        _close(tl, jl, TOL[dt], f"decode step {i}")
        _close_state(tc["mlstm"]["state"], jc["mlstm"]["state"], TOL[dt],
                     f"decode step {i} state")


# --- weights, train state and checkpoints across packages ----------------------------


@pytest.mark.parametrize("rem", [False, True])
def test_params_and_train_state_carry_every_xlstm_leaf_exactly(rem):
    """The reference's stacked mLSTM index j is the port's ``mlstm.<j>``:
    period j // m_per's blocks first, the trailing ones last."""
    _, js, tm, _ = _models("bf16", rem)
    tcfg = tm.cfg
    tree = jax.tree.map(np.asarray, js)
    sd = params_from_jax(tree.params, tcfg)
    tm.lm.load_state_dict(sd)  # every name and shape of the module
    state = train_state_from_jax(tree, tcfg)
    periods, m_per, n_rem = TX.xl_counts(tcfg)
    assert n_rem == (1 if rem else 0)
    for j in range(periods * m_per + n_rem):
        for name, leaf in tree.params["mlstm"].items():
            got = sd[f"mlstm.{j}.{name}"]
            assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.float().numpy(), _np(leaf[j]))
            np.testing.assert_array_equal(
                state.opt.master[f"mlstm.{j}.{name}"].numpy(),
                np.asarray(tree.opt.master["mlstm"][name][j], np.float32))
    for i in range(periods):
        np.testing.assert_array_equal(sd[f"slstm.{i}.mlp.wg"].float().numpy(),
                                      _np(tree.params["slstm"]["mlp"]["wg"][i]))
    np.testing.assert_array_equal(sd["lm_head"].float().numpy(),
                                  _np(tree.params["lm_head"]))
    assert int(state.step) == int(tree.step)
