"""whisper-base's encoder-decoder on the port (``repro_torch.models.encdec``)
against the JAX package's (``repro/models/encdec.py``), on the CPU; the
port's ``layers.layer_norm`` and the cross-attention modes; and
``train.optimizer.reference_rank`` on every family's leaves.

The reference's TINY config: 2 encoder and 2 decoder blocks, d_model 64,
4/4 heads of 16, d_ff 128, vocab 512, a tied head and the 32768-row
learned position table. The same numpy inputs (frame embeddings and
tokens) and the same weights (the reference's, carried over by
``models/convert.py``) go through both; the reference runs with
``mesh=None``.

Tolerances. ``layer_norm`` bit for bit in bf16 (the fp32 statistics in
another summation order round to the same bf16 mu and inv here) and within
4e-6 in fp32 (measured 1.4e-6: 3 ulps of outputs up to ~5). The models:
fp32 within 1e-5 (measured: logits 2.7e-7); bf16 within 3e-2 (measured
0.0068, std 0.16): the port's attention keeps fp32
probabilities where the reference's einsums round scores and
probabilities to bf16, and the bf16 matmuls sum in another order.

Compared here: ``layer_norm`` and the sinusoids, the encoder, both cross
modes at S == T (the flash kernel's shapes) and S != T (the plain
einsums), the whole model's logits, prefill and decode steps with their
caches, the parameters and train state across packages, and every
family's ``reference_rank``; ``tests/test_torch_encdec_train.py`` holds
the loss and gradients, the train step, the launchers and phase 24's
rehearsal.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JNN  # noqa: E402
from repro.models.common import ShardingRules  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TNN  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import reference_rank  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "whisper-base"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}


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


# --- layer norm and the sinusoids ------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_norm_matches_reference(dt, bias):
    jdt, tdt = DTYPES[dt]
    r = np.random.default_rng(5)
    x = (r.standard_normal((3, 17, 512)) * 2 + 0.7).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 512).astype(np.float32)
    b = r.standard_normal(512).astype(np.float32) if bias else None
    want = JNN.layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                          None if b is None else jnp.asarray(b, jdt), 1e-5)
    got = TNN.layer_norm(_t(x, tdt), _t(scale, tdt),
                         None if b is None else _t(b, tdt), 1e-5)
    assert got.dtype == tdt
    if dt == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    else:
        _close(got, want, 4e-6)


def test_sinusoid_matches_reference():
    want = JE._sinusoid(1500, 512)
    got = TE._sinusoid(1500, 512, "cpu")
    assert got.dtype == torch.float32
    # fp32 sin/cos of angles up to 1500 rad: an ulp of the angle apart
    _close(got, want, 2e-4)
    _close(got[:64], want[:64], 1e-6)


# --- the encoder and cross-attention -------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encoder_matches_reference(dt):
    jm, js, tm, _ = _models(dt)
    x = _frames(2, 12, seed=1)
    want = jax.jit(lambda p, e: JE.encode(p, jm.cfg, e))(js.params,
                                                          jnp.asarray(x))
    with torch.no_grad():
        got = tm.lm.encode(torch.from_numpy(x))
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, TOL[dt])


@pytest.mark.parametrize("t", [12, 7])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_modes_match_reference(dt, t):
    """'cross' (K/V projected from the encoder's output) and
    'cross_decode' (K/V from the cache) at S 12 against T 12 (the flash
    kernel's shape on the card) and T 7 (the plain einsums)."""
    jdt, tdt = DTYPES[dt]
    jcfg, tcfg = _cfgs(dt)
    p, _ = JNN.init_attention(jax.random.PRNGKey(6), jcfg,
                              ShardingRules({}, False))
    tp = {k: _t(_np(v), tdt) for k, v in p.items()}
    x, kv = _frames(2, 12, seed=2), _frames(2, t, seed=3)
    jo, jc = JNN.attention_fwd(p, jnp.asarray(x, jdt), jcfg, mode="cross",
                               x_kv=jnp.asarray(kv, jdt))
    to, tc = TNN.attention_fwd(tp, _t(x, tdt), tcfg, mode="cross",
                               x_kv=_t(kv, tdt))
    assert tc["k"].shape == (2, t, 4, 16)
    _close(to, jo, TOL[dt], "cross")
    _close(tc["v"], jc["v"], TOL[dt], "cross v")
    jo, _ = JNN.attention_fwd(p, jnp.asarray(x[:, :1], jdt), jcfg,
                              mode="cross_decode", cache=jc)
    to, same = TNN.attention_fwd(tp, _t(x[:, :1], tdt), tcfg,
                                 mode="cross_decode", cache=tc)
    assert same is tc
    _close(to, jo, TOL[dt], "cross_decode")


# --- the whole model -------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encdec_logits_match_reference(dt):
    jm, js, tm, _ = _models(dt)
    toks, emb = _tokens(2, 10, seed=0), _frames(2, 12, seed=0)
    jl, _, _ = jax.jit(lambda p, t, e: jm.forward(
        p, tokens=t, embeds=e, mode="causal", cache=None, pos=None))(
        js.params, jnp.asarray(toks), jnp.asarray(emb))
    tl, cache, aux = tm.forward(tokens=torch.from_numpy(toks),
                                embeds=torch.from_numpy(emb))
    assert tl.shape == (2, 10, tm.cfg.padded_vocab) and cache is None
    assert float(aux["moe_aux"]) == 0.0
    _close(tl, jl, TOL[dt])
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(tokens=torch.from_numpy(toks))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_steps_match_reference(dt):
    """The launcher's contract (as many frames as prompt tokens), the
    prefill writing both caches, then decode steps that do not run the
    encoder again."""
    jm, js, tm, _ = _models(dt)
    B, S_p, S_gen = 2, 12, 5
    toks, emb = _tokens(B, S_p + S_gen, seed=1), _frames(B, S_p, seed=1)
    jb = {"tokens": jnp.asarray(toks[:, :S_p]), "embeds": jnp.asarray(emb)}
    tb = {"tokens": torch.from_numpy(toks[:, :S_p]),
          "embeds": torch.from_numpy(emb)}
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen, enc_len=S_p))(js.params, jb)
    tl, tc = make_prefill_step(tm, S_p + S_gen, S_p)(tb)
    assert sorted(tc) == ["cross", "self"]
    assert tc["self"]["k"].shape == (2, B, S_p + S_gen, 4, 16)
    assert tc["cross"]["k"].shape == (2, B, S_p, 4, 16)
    _close(tl, jl, TOL[dt], "prefill")
    for group in ("self", "cross"):
        for name in ("k", "v"):
            _close(tc[group][name][:, :, :S_p], jc[group][name][:, :, :S_p],
                   TOL[dt], f"prefill {group} {name}")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        _close(tl, jl, TOL[dt], f"decode step {i}")
    with pytest.raises(ValueError, match="cross rows"):
        make_prefill_step(tm, S_p + S_gen, S_p + 1)(tb)


# --- weights and ranks across packages ----------------------------------------------------


def test_params_and_train_state_carry_every_encdec_leaf_exactly():
    jcfg, tcfg = _cfgs("bf16")
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, js)
    tm = build_model(tcfg, "cpu")
    sd = params_from_jax(tree.params, tcfg)
    tm.lm.load_state_dict(sd)  # every name and shape of the module
    state = train_state_from_jax(tree, tcfg)
    assert sd["dec_pos"].shape == (TE.MAX_DEC_POS, 64)
    for i in range(tcfg.num_layers):
        np.testing.assert_array_equal(
            sd[f"dec_layers.{i}.cross.wk"].float().numpy(),
            _np(tree.params["dec_layers"]["cross"]["wk"][i]))
        np.testing.assert_array_equal(
            state.opt.master[f"enc_layers.{i}.mlp.wi"].numpy(),
            np.asarray(tree.opt.master["enc_layers"]["mlp"]["wi"][i],
                       np.float32))
    np.testing.assert_array_equal(sd["embed"].float().numpy(),
                                  _np(tree.params["embed"]["table"]))
    assert int(state.step) == int(tree.step)


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-1.3b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b"])
def test_reference_rank_is_the_reference_trees_rank(arch):
    """Each port parameter's ``reference_rank`` is the rank of its leaf in the
    reference's tree, whose per-layer groups are stacked (so the weight
    decay, rank >= 2, falls on the same leaves)."""
    jcfg = jconfigs.get_tiny(arch)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = len(v.shape)
    walk(shapes, ())
    tm = build_model(tconfigs.get_tiny(arch), "cpu")
    stacked = {"layers", "mamba", "mlstm", "slstm", "enc_layers",
               "dec_layers"}
    for name, p in tm.lm.named_parameters():
        parts = name.split(".")
        if parts[0] in stacked:
            key = (parts[0],) + tuple(parts[2:])
        elif parts[0] == "embed":
            key = ("embed", "table")
        else:
            key = tuple(parts)
        assert reference_rank(name, p) == flat[key], name
