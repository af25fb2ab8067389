"""The port's Mixture-of-Experts (``repro_torch.models.moe`` and the MoE
family: qwen2-moe-a2.7b, dbrx-132b) against the JAX package's, on the CPU.

The same numpy inputs and the same weights (the reference's, carried over
by ``convert``) go through both. Routes are discrete, so they are held
equal first (``topi``), then the values: fp32 within 1e-5 (the same fp32
math, sums in another order), bf16 within 3e-2 (``tests/test_serve.py``'s
tolerance), the aux within 1e-6 relative and ``moe_dropped`` exactly, at
the configs' capacity factor and at one that forces drops. The expert-
parallel and decode psum paths over a ``VirtualMesh(4)`` are held to the
local paths within 2e-5 (the reference's cases' bound) and to one another
bit for bit across stagings and the ring. Then the whole model at TINY in
fp32 (logits, prefill and decode steps, the loss with its aux term and
every gradient leaf, a train step), the checkpoint across packages, the
launchers, and chip_smoke.py's phase 19 rehearsed on the CPU.
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
from repro.models import moe as JM  # noqa: E402
from repro.models.common import ShardingRules  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro.train.steps import make_decode_step as j_decode  # noqa: E402
from repro.train.steps import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import histogram as hist_module  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    _tensor, params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
AUX_RTOL = 1e-6
EP_TOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ShardingRules({}, False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dt, **kw):
    jdt, tdt = DTYPES[dt]
    return (jconfigs.get_tiny(arch).replace(dtype=jdt, param_dtype=jdt, **kw),
            tconfigs.get_tiny(arch).replace(dtype=tdt, param_dtype=tdt, **kw))


def _port_tree(tree, dt):
    """The reference's MoE tree as torch tensors: fp32 leaves (the router)
    stay fp32, the others in ``dt``."""
    return jax.tree.map(lambda v: _tensor(np.asarray(v), torch.float32
                                          if v.dtype == jnp.float32 else dt),
                        tree)


def _layer(arch, dt, **kw):
    """(jax cfg, port cfg, reference init_moe params, the same as tensors)."""
    jcfg, tcfg = _cfgs(arch, dt, **kw)
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg, RULES)
    return jcfg, tcfg, jp, _port_tree(jp, tcfg.param_dtype)


def _x(shape, dt, seed=1, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _aux_close(got, want):
    for k in ("moe_aux", "moe_dropped"):
        g, w = float(got[k]), float(want[k])
        if k == "moe_dropped":
            assert g == w, (k, g, w)
        else:
            assert abs(g - w) <= AUX_RTOL * abs(w), (k, g, w)


# --- the layer's functions ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_route_matches_reference(arch, dt):
    jcfg, tcfg, jp, tp = _layer(arch, dt)
    jx, tx = _x((40, 64), dt)
    ji, jw, ja = JM._route(jp["router"], jx, jcfg)
    ti, tw, ta = TM._route(tp["router"], tx, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == torch.float32 and ta.dtype == torch.float32
    # the router's product runs in fp32 from the same values on both sides
    _close(tw, jw, 1e-6)
    assert abs(float(ta) - float(ja)) <= AUX_RTOL * float(ja)


def test_route_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert first, as ``jax.lax.top_k``."""
    jcfg, tcfg, jp, tp = _layer("qwen2-moe-a2.7b", "f32")
    router = np.asarray(jp["router"]).copy()
    router[:, 6] = router[:, 2]
    router[:, 5] = router[:, 2]
    router[:, 1] = router[:, 0]
    jx, tx = _x((64, 64), "f32", seed=4)
    ji, _, _ = JM._route(jnp.asarray(router), jx, jcfg)
    ti, _, _ = TM._route(torch.from_numpy(router), tx, tcfg)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    tied = [(a, b) for a, b in ji if {a, b} in ({2, 5}, {2, 6}, {5, 6},
                                                {0, 1})]
    assert tied and all(a < b for a, b in tied)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_expert_ffn_matches_reference(dt):
    jcfg, tcfg, jp, tp = _layer("dbrx-132b", dt)
    jx, tx = _x((4, 12, 64), dt, seed=2)
    want = JM._expert_ffn(jp["wi"], jp["wg"], jp["wo"], jx)
    got = TM._expert_ffn(tp["wi"], tp["wg"], tp["wo"], tx)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dt])


def test_capacity_and_padding_match_reference():
    for arch in ARCHS:
        for cf in (0.5, 1.25, 8.0, 16.0):
            jcfg = jconfigs.get_config(arch).replace(moe_capacity_factor=cf)
            tcfg = tconfigs.get_config(arch).replace(moe_capacity_factor=cf)
            for m in (1, 2, 4, 16):
                assert TM.padded_experts(tcfg, m) == JM.padded_experts(jcfg, m)
            for tokens, e_pad in ((1, 60), (4, 60), (4096, 60), (4220, 60),
                                  (16384, 16), (3, 4)):
                assert TM._bucket_capacity(tokens, e_pad, tcfg) == \
                    JM._bucket_capacity(tokens, e_pad, jcfg)
    assert TM.padded_experts(tconfigs.get_config("qwen2-moe-a2.7b"), 1) == 60
    assert TM.padded_experts(tconfigs.get_config("qwen2-moe-a2.7b"), 16) == 64


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_fwd_matches_reference(arch, dt, cf):
    """The local path end to end (qwen2's TINY with its shared expert,
    dbrx's without), at the config's capacity and at one that forces drops
    (identical tokens all take the same experts)."""
    jcfg, tcfg, jp, tp = _layer(arch, dt, moe_capacity_factor=cf)
    a = np.random.default_rng(3).standard_normal((3, 24, 64)).astype(np.float32)
    if cf < 1:
        a[1] = a[1, :1]  # 24 equal tokens: their experts overflow
    jx, tx = jnp.asarray(a, DTYPES[dt][0]), torch.from_numpy(a).to(DTYPES[dt][1])
    jy, jaux = JM.moe_fwd(jp, jx, jcfg, RULES, None)
    ty, taux = TM.moe_fwd(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, TOL[dt])
    _aux_close(taux, jaux)
    assert (float(taux["moe_dropped"]) > 0) == (cf < 1)
    # the shared expert is in the sum where the config has one
    if tcfg.moe_num_shared:
        routed = {k: tp[k] for k in TM.ROUTED}
        alone, _ = TM.moe_fwd(routed, tx, tcfg.replace(moe_num_shared=0))
        assert float((ty - alone).abs().max()) > 10 * TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dispatch_compute_combine_matches_reference(dt):
    jcfg, tcfg, jp, tp = _layer("qwen2-moe-a2.7b", dt, moe_capacity_factor=0.5)
    a = np.random.default_rng(5).standard_normal((50, 64)).astype(np.float32)
    a[10:40] = a[10]
    jx, tx = jnp.asarray(a, DTYPES[dt][0]), torch.from_numpy(a).to(DTYPES[dt][1])
    routed = lambda p: {k: p[k] for k in TM.ROUTED}  # noqa: E731
    jy, jaux = JM._dispatch_compute_combine(routed(jp), jx, jcfg, 8, None)
    ty, taux = TM._dispatch_compute_combine(routed(tp), tx, tcfg, 8)
    _close(ty, jy, TOL[dt])
    _aux_close(taux, jaux)
    assert float(taux["moe_dropped"]) > 0


# --- the expert-parallel and decode psum paths ------------------------------------


def _mesh_cfg(dt="f32", **kw):
    """tests/test_dist.py's MoE case config."""
    return _cfgs("qwen2-moe-a2.7b", dt, num_layers=1, d_model=32,
                 moe_num_experts=8, moe_top_k=2, moe_d_ff=48,
                 moe_capacity_factor=8.0, **kw)


@pytest.mark.parametrize("stages,mode", [(1, "alltoall"), (None, "alltoall"),
                                         (3, "alltoall"), (None, "ring")])
def test_ep_path_matches_the_local_paths(stages, mode):
    jcfg, tcfg = _mesh_cfg(moe_num_shared=1)
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg, RULES)
    tp = _port_tree(jp, torch.float32)
    jx, tx = _x((2, 16, 32), "f32", seed=6)
    mesh = VirtualMesh(4)
    ecfg = tcfg.replace(moe_shuffle_stages=stages, moe_shuffle_mode=mode)
    ty, taux = TM.moe_fwd(tp, tx, ecfg, mesh)
    base, _ = TM.moe_fwd(tp, tx, tcfg.replace(moe_shuffle_stages=1), VirtualMesh(4))
    local, _ = TM.moe_fwd(tp, tx, tcfg)
    jy, _ = JM.moe_fwd(jp, jx, jcfg, RULES, None)
    assert float((ty - local).abs().max()) < EP_TOL
    assert float(np.abs(ty.numpy() - _np(jy)).max()) < EP_TOL
    assert torch.equal(ty, base)  # every staging and the ring: the same bits
    assert 0.5 < float(taux["moe_aux"]) < 3.0
    # one exchange each way (stages chunks each), or the ring's p - 1 steps
    if mode == "ring":
        assert mesh.counts == {"ppermute": 2 * 3}
    else:
        n = 1 if stages is None else stages
        assert mesh.counts == {"all_to_all": 2 * n}


def test_ep_path_is_each_shards_local_dispatch_with_drops():
    """Under forced drops the EP path is, shard by shard, the reference's
    local dispatch of that shard's tokens at the shard's capacity: outputs
    within 2e-5, ``moe_dropped`` the mean of the shards' counts exactly."""
    jcfg, tcfg = _mesh_cfg(moe_num_shared=0)
    jcfg, tcfg = (c.replace(moe_capacity_factor=0.5) for c in (jcfg, tcfg))
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg, RULES)
    tp = _port_tree(jp, torch.float32)
    a = np.random.default_rng(7).standard_normal((4, 32, 32)).astype(np.float32)
    a[:, 8:16] = a[0, 8]  # shard 1's tokens all equal: its experts overflow
    y, aux = TM.moe_fwd(tp, torch.from_numpy(a), tcfg, VirtualMesh(4))
    drops = []
    routed = {k: jp[k] for k in TM.ROUTED}
    for i in range(4):
        xs = a[:, 8 * i:8 * (i + 1)].reshape(32, 32)
        jy, jaux = JM._dispatch_compute_combine(routed, jnp.asarray(xs), jcfg,
                                                8, None)
        got = y[:, 8 * i:8 * (i + 1)].reshape(32, 32)
        assert float(np.abs(got.numpy() - _np(jy)).max()) < EP_TOL, i
        drops.append(float(jaux["moe_dropped"]))
    assert drops[1] > 0
    assert float(aux["moe_dropped"]) == sum(drops) / 4


def test_psum_path_matches_the_local_paths():
    jcfg, tcfg = _mesh_cfg(moe_num_shared=1)
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg, RULES)
    tp = _port_tree(jp, torch.float32)
    jx, tx = _x((4, 1, 32), "f32", seed=8)
    mesh = VirtualMesh(4)
    y, aux = TM.moe_fwd(tp, tx, tcfg, mesh)
    local, laux = TM.moe_fwd(tp, tx, tcfg)
    jy, _ = JM.moe_fwd(jp, jx, jcfg, RULES, None)
    assert float((y - local).abs().max()) < EP_TOL
    assert float(np.abs(y.numpy() - _np(jy)).max()) < EP_TOL
    assert float(aux["moe_dropped"]) == 0 and float(aux["moe_aux"]) == \
        float(laux["moe_aux"])
    assert not mesh.counts  # no collective but the sum


def test_one_shard_and_fsdp_take_the_local_path():
    _, tcfg = _mesh_cfg(moe_num_shared=0)
    p = TM.init_moe(tcfg, torch.Generator().manual_seed(0), 4)
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
    local, _ = TM.moe_fwd(p, x, tcfg)
    for cfg, m in ((tcfg.replace(layout="fsdp"), 4),
                   (tcfg.replace(ep_shuffle=False), 4), (tcfg, 1)):
        mesh = VirtualMesh(m)
        got, _ = TM.moe_fwd(p, x, cfg, mesh)
        assert torch.equal(got, local) and not mesh.counts


# --- params and init --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_moe_leaf(arch):
    jcfg, tcfg = _cfgs(arch, "bf16")
    params = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree, tcfg)
    tm = build_model(tcfg, "cpu")
    assert set(sd) == set(tm.lm.state_dict())
    tm.lm.load_state_dict(sd)
    L = tcfg.num_layers
    assert len(sd) == len(jax.tree.leaves(params["layers"])) * L + \
        len(jax.tree.leaves(params)) - len(jax.tree.leaves(params["layers"]))
    for i in range(L):
        moe = params["layers"]["moe"]
        got = tm.lm.layers[i].moe
        assert got["router"].dtype == torch.float32
        np.testing.assert_array_equal(got["router"].numpy(),
                                      np.asarray(moe["router"][i]))
        for name in ("wi", "wg", "wo"):
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          _np(moe[name][i]))
        assert ("shared" in got) == bool(tcfg.moe_num_shared)
        if tcfg.moe_num_shared:
            for name, leaf in moe["shared"].items():
                assert sd[f"layers.{i}.moe.shared.{name}"].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got["shared"][name].float().numpy(), _np(leaf[i]))


def test_init_moe_follows_the_reference_distributions():
    cfg = tconfigs.get_tiny("qwen2-moe-a2.7b").replace(d_model=256,
                                                        moe_d_ff=192)
    p = TM.init_moe(cfg, torch.Generator().manual_seed(3))
    want = {"router": ((256, 8), 1 / 16, torch.float32),
            "wi": ((8, 256, 192), 1 / 16, torch.bfloat16),
            "wg": ((8, 256, 192), 1 / 16, torch.bfloat16),
            "wo": ((8, 192, 256), 1 / math.sqrt(192), torch.bfloat16)}
    for name, (shape, std, dtype) in want.items():
        t = p[name]
        assert tuple(t.shape) == shape and t.dtype == dtype, name
        got = float(t.float().std())
        assert abs(got / std - 1) < 5 / math.sqrt(2 * t.numel()) + 0.01, name
    assert tuple(p["shared"]["wi"].shape) == (256, 192)
    assert tuple(p["shared"]["wo"].shape) == (192, 256)
    again = TM.init_moe(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(again["wo"], p["wo"])


# --- the whole model, fp32 ------------------------------------------------------------


@functools.cache
def _models(arch):
    """(jax model, its TrainState, port model with the state's weights, the
    port's state), fp32."""
    jcfg, tcfg = _cfgs(arch, "f32")
    jm = jbuild(jcfg)
    js = jax.jit(lambda k: jsteps.init_train_state(jm, k))(
        jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    ts = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tcfg))
    return jm, js, tm, ts


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(np.int32)


def _record_routes(monkeypatch, module):
    calls = []
    real = module._route

    def route(*a):
        out = real(*a)
        calls.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "_route", route)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_routes_then_logits_match_reference(arch, monkeypatch):
    """Each layer's routes equal the reference's (run eagerly, layers
    unrolled, so its routes are values), then the logits and the aux."""
    jm, js, tm, _ = _models(arch)
    jeager = jbuild(jm.cfg.replace(scan_layers=False, remat="none"))
    toks = _tokens(2, 12, seed=0)
    jcalls = _record_routes(monkeypatch, JM)
    tcalls = _record_routes(monkeypatch, TM)
    jl, _, jaux = jeager.forward(js.params, tokens=jnp.asarray(toks),
                                 mode="causal", cache=None, pos=None)
    tl, _, taux = tm.forward(tokens=torch.from_numpy(toks))
    assert len(tcalls) == len(jcalls) == tm.cfg.num_layers
    for i, (a, b) in enumerate(zip(tcalls, jcalls)):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} routes")
    _close(tl, jl, TOL["f32"])
    _aux_close(taux, jaux)
    assert taux["moe_aux"].dtype == torch.float32
    assert float(taux["moe_aux"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jm, js, tm, _ = _models(arch)
    B, S_p, S_gen = 2, 8, 4
    toks = _tokens(B, S_p + S_gen, seed=1)
    jl, jc = jax.jit(j_prefill(jm, S_p + S_gen))(
        js.params, {"tokens": jnp.asarray(toks[:, :S_p])})
    tl, tc = make_prefill_step(tm, S_p + S_gen)(
        {"tokens": torch.from_numpy(toks[:, :S_p])})
    _close(tl, jl, TOL["f32"], "prefill")
    _close(tc["v"], jc["v"], TOL["f32"], "prefill cache")
    jdec, tdec = jax.jit(j_decode(jm)), make_decode_step(tm)
    for i in range(S_gen):
        fed = toks[:, S_p + i:S_p + i + 1]
        jl, jc = jdec(js.params, jc, jnp.asarray(fed), jnp.int32(S_p + i))
        tl, tc = tdec(tc, torch.from_numpy(fed), S_p + i)
        _close(tl, jl, TOL["f32"], f"decode step {i}")


def _batch(b=4, s=16, seed=0):
    r = np.random.default_rng(seed)
    toks = _tokens(b, s, seed)
    toks[1, 4:7] = 0  # padding labels
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax_grad(arch):
    jm, js, tm, ts = _models(arch)
    jb, tb = _batch()
    jl, jmet = jax.jit(jm.loss_fn)(js.params, jb)
    tl, tmet = tm.loss_fn(tb)
    assert sorted(tmet) == sorted(jmet)
    assert abs(float(tl) - float(jl)) <= TOL["f32"] * abs(float(jl))
    _aux_close(tmet, jmet)
    # the aux term is in the loss: 0.01 * moe_aux / num_layers
    assert float(tl) > float(tmet["loss"]) - 1e-6 and float(tmet["moe_aux"]) > 0
    jg = jax.jit(jax.grad(lambda p: jm.loss_fn(p, jb)[0]))(js.params)
    tg, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    want = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        jg), tm.cfg)
    assert set(tg) == set(want)
    for name, g in tg.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= TOL["f32"] * scale, name
    assert float(tg["layers.0.moe.router"].abs().max()) > 0


def test_train_step_matches_reference_over_microbatches():
    """Two microbatches: the metrics (the aux values the mean of the
    microbatches', as the reference's scan), the grad norm, and every
    leaf's moments and master after the step (as
    tests/test_torch_train.py's ``_check_step``: the first AdamW step moves
    a near-zero-gradient element by up to lr on the sign of its gradient,
    so the masters are held to 0.01 lr where the moment is large, 0.1 lr
    elsewhere)."""
    arch = "qwen2-moe-a2.7b"
    jm, js, tm, ts = _models(arch)
    jb, tb = _batch(seed=2)
    jstep = jax.jit(jsteps.make_train_step(
        jm, JOptConfig(lr=1e-2, warmup_steps=2, total_steps=10),
        microbatches=2))
    js2, jmet = jstep(js, jb)
    fresh = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tm.cfg))
    ts2, tmet = tsteps.make_train_step(
        tm, OptConfig(lr=1e-2, warmup_steps=2, total_steps=10),
        microbatches=2)(fresh, tb)
    for k in ("loss", "moe_aux", "moe_dropped", "grad_norm", "tokens"):
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
    del ts


def test_bf16_model_keeps_an_fp32_router_through_a_train_step():
    tcfg = tconfigs.get_tiny("dbrx-132b")
    tm = build_model(tcfg, "cpu")
    state = tsteps.init_train_state(tm, 0)
    _, tb = _batch(seed=3)
    grads, met = tsteps._accumulate_grads(tm, state.params, tb, 2)
    assert grads["layers.1.moe.router"].dtype == torch.float32
    assert all(torch.isfinite(g).all() for g in grads.values())
    before = state.params["layers.1.moe.router"].clone()
    state, met = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1),
                                        microbatches=2)(state, tb)
    r = state.params["layers.1.moe.router"]
    assert r.dtype == torch.float32 and not torch.equal(r, before)
    assert torch.equal(r, state.opt.master["layers.1.moe.router"])
    assert state.params["layers.1.moe.wi"].dtype == torch.bfloat16
    assert math.isfinite(float(met["moe_aux"]))


def _numpy_tree(tree):
    """A train state's tensors as numpy (bf16 as ml_dtypes' bfloat16)."""
    import ml_dtypes

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return jax.tree.map(leaf, tree)


def test_moe_checkpoint_reads_across_packages(tmp_path):
    """A bf16 MoE train state (fp32 routers, nested ``moe.shared.*``
    names) saved by the port verifies and loads in the reference, and the
    reference's save of it loads back into the port bit for bit."""
    tcfg = tconfigs.get_tiny("qwen2-moe-a2.7b")
    tm = build_model(tcfg, "cpu")
    state = tsteps.init_train_state(tm, 0)
    _, tb = _batch(seed=4)
    state, _ = tsteps.make_train_step(tm, OptConfig(lr=1e-2, warmup_steps=1))(
        state, tb)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    assert "params_layers.0.moe.shared.wg" in names
    assert "opt_master_layers.1.moe.router" in names
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
            assert str(j.dtype) == "bfloat16", name
            assert np.array_equal(j.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), name
        else:
            assert np.array_equal(j, t.numpy()), name
            if "moe.router" in name:
                assert j.dtype == np.float32, name
    jd = str(tmp_path / "ref")
    jckpt.save(jd, 2, got)
    fresh = tsteps.init_train_state(tm, 7)
    restored = ckpt.restore(jd, 2, fresh)
    for (name, a), b in zip(ckpt._leaf_paths(restored), saved):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_launchers_run_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    res = serve.main(["--arch", arch, "--tiny", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    hist = train.main(["--arch", arch, "--tiny", "--steps", "2", "--batch",
                       "4", "--seq", "16", "--log-every", "1", "--device",
                       "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and "tok/s" in out[0]
    assert out[1].startswith("generated token ids (first row): [")
    assert out[-1].startswith("final loss: ")
    assert res.tokens.shape == (2, 3) and len(hist) == 2
    assert all(math.isfinite(h["loss"]) and h["moe_aux"] > 0 for h in hist)


# --- chip_smoke.py's phase 19, rehearsed ----------------------------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_calls(monkeypatch, smoke):
    """A CPU tensor launches nothing: each wrapper's call is counted as its
    launch (flash's through ``FlashAttentionFn`` in training, as on the
    card), and the CUDA-only calls are stubbed."""
    counted = {n: smoke.KERNELS[n][0] for n in smoke.LM_KERNELS +
               ("bucket_histogram",)}
    modules = {n: fa for n in smoke.LM_KERNELS}
    modules["bucket_histogram"] = hist_module
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
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return real


def test_chip_smoke_moe_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 19 at the TINY configs: serving with flash once a layer in the
    prefill and the histogram once a layer a forward, the plain run on the
    kernel run's routes and the cf-16 invariant; training at 2 layers with
    the kernel-against-plain check and the histogram in every forward;
    dbrx at 2 layers. A wrong count, or a plain run that leaves the
    recorded routes, fails it."""
    smoke = _load_smoke()
    real = _count_calls(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 4)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "MOE_TRAIN_LAYERS", 2)
    cpu = torch.device("cpu")
    serve = smoke.phase_moe_serve(cpu, smoke.MOE_ARCH)
    assert serve["launches"]["flash_attention"] == 2
    assert serve["launches"]["bucket_histogram"] == 2 * 4
    assert serve["decode_step_launches"]["bucket_histogram"] == 2
    assert serve["plain_max_abs_err"] == 0.0  # the same plain math twice
    assert serve["plain_route_flips"] == 0 and serve["routes"] == \
        2 * (2 * 16 + 3 * 2)
    assert serve["causal_max_abs_err"] <= smoke.LM_TOL
    assert serve["wrong_mask_max_abs_err"] > 3 * smoke.LM_TOL
    assert serve["forward_host_syncs"] == 0
    train = smoke.phase_moe_train(cpu)
    k = tconfigs.train_microbatches(smoke.MOE_ARCH)
    assert k == 4 and train["launches_per_step"]["bucket_histogram"] == 2 * 2 * k
    assert train["launches_per_step"]["flash_attention_lse"] == 2 * 2 * k
    assert train["plain"]["loss_rel_err"] == 0.0
    assert train["plain"]["route_flips"] == 0 and train["plain"]["routes"] > 0
    assert all(x > 0 for x in train["moe_aux"])
    big = smoke.phase_moe_serve(cpu, smoke.MOE_BIG_ARCH, 1)
    assert big["layers"] == 1 and big["launches"]["flash_attention"] == 1
    monkeypatch.setattr(hist_module, "bucket_histogram", real["bucket_histogram"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_moe_serve(cpu, smoke.MOE_BIG_ARCH, 1)


def test_route_tap_follows_and_counts_flips():
    """``RouteTap.follow`` makes a run take the recorded routes and counts
    where its own differ; a run whose calls do not match fails."""
    smoke = _load_smoke()
    cfg = tconfigs.get_tiny("dbrx-132b").replace(dtype=torch.float32,
                                                 param_dtype=torch.float32)
    p = TM.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 6, 64), generator=torch.Generator().manual_seed(1))
    tap = smoke.RouteTap()
    with tap.record():
        want, _ = TM.moe_fwd(p, x, cfg)
    flipped = [c.flip(-1) if i == 0 else c for i, c in enumerate(tap.calls)]
    flipped[0][:3] = (flipped[0][:3] + 1) % cfg.moe_num_experts
    other = smoke.RouteTap()
    with other.follow(flipped):
        got, _ = TM.moe_fwd(p, x, cfg)
    assert other.flips == 3 and other.routes == 12
    assert not torch.equal(got, want)
    again = smoke.RouteTap()
    with again.follow(tap.calls):
        same, _ = TM.moe_fwd(p, x, cfg)
    assert again.flips == 0 and torch.allclose(same, want, atol=1e-6)
    with pytest.raises(smoke.CheckFailed, match="route tap"):
        with smoke.RouteTap().follow(tap.calls + tap.calls):
            TM.moe_fwd(p, x, cfg)
    with pytest.raises(smoke.CheckFailed, match="route tap"):
        with smoke.RouteTap().follow([c[:5] for c in tap.calls]):
            TM.moe_fwd(p, x, cfg)


def test_flip_bound_tells_a_wrong_mask_from_rounding():
    """chip_smoke.py's ``MOE_FLIP_SHARE`` on a narrow qwen2-moe-a2.7b (4
    layers, d_model 512, 4 heads of 128, its 60 experts top-4), fp32 on the
    CPU: relative noise of 2^-8 on every attention output (a bf16 ulp,
    more than the kernel's rounding moves it) flips under a third of the
    bound's share of (layer, token) routes, a bidirectional mask or a
    wrong head more than four times it."""
    smoke = _load_smoke()
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").replace(
        num_layers=4, d_model=512, num_heads=4, num_kv_heads=4,
        vocab_size=4096, moe_num_shared=1, moe_d_ff=128,
        dtype=torch.float32, param_dtype=torch.float32)
    model = build_model(cfg, "cpu")
    toks = torch.from_numpy(_tokens(2, 256, seed=9))
    tap = smoke.RouteTap()
    with tap.record(), torch.no_grad():
        model.forward(tokens=toks)
    real = tops.attention
    noise = torch.Generator().manual_seed(0)

    def share(attention):
        other = smoke.RouteTap()
        tops.attention = attention
        try:
            with other.follow(tap.calls), torch.no_grad():
                model.forward(tokens=toks)
        finally:
            tops.attention = real
        return other.share

    rounded = share(lambda q, k, v, causal=True: (lambda o: o * (
        1 + 2.0 ** -8 * torch.randn(o.shape, generator=noise)))(
            real(q, k, v, causal=causal)))
    unmasked = share(lambda q, k, v, causal=True: real(q, k, v, causal=False))
    wrong_head = share(lambda q, k, v, causal=True: real(
        q, k.roll(1, dims=2), v.roll(1, dims=2), causal=causal))
    assert rounded < smoke.MOE_FLIP_SHARE / 3, rounded
    assert min(unmasked, wrong_head) > 4 * smoke.MOE_FLIP_SHARE, (
        unmasked, wrong_head)
