"""The port's training path (repro_torch: ``Model.loss_fn``,
``train/optimizer.py``, ``train/steps.py``, ``train/loop.py``,
``launch/train.py``, the attention gradient) against the JAX package's,
on the CPU at the TINY configs of granite-3-2b (tied embeddings) and
llama3-8b (untied).

Both sides start from one state: the reference's ``TrainState``, carried
across by ``convert.train_state_from_jax``. Tolerances:
- fp32: loss, metrics and every gradient leaf within 1e-5 of the largest
  reference value (the two run the same fp32 math; sums run in another
  order, ~1e-6 seen); the optimizer on the same gradients within 1e-6 of
  the largest master, moment or value (a few fp32 ulps: XLA may fuse a
  multiply-add the port rounds twice).
- bf16: the port's prefill attention runs in fp32 inside, where the
  reference's einsum attention rounds its scores and probabilities to
  bf16 (``tests/test_torch_models.py``), so the loss is held within 3e-3
  and the gradients within 6e-2 of the largest reference value (up to
  3.3e-2 seen).
- The masters after a train step: Adam's first step moves an element by
  ``lr * g / (|g| + eps)``, about ``+-lr`` whatever |g|, so an element whose
  gradient is near 0 may move either way in the two packages. Where the
  reference's first moment is above 5% of its leaf's largest, the two
  updates must agree within 1% of ``lr``; in fp32 every element within
  10% of ``lr`` per step (2% seen, at gradients of ~3e-10). After three
  steps the moments are held 10x looser than the gradients.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data.pipeline import RelationalTokenPipeline as JPipeline  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JNN  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, RelationalTokenPipeline)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCHS = ["granite-3-2b", "llama3-8b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"f32": 1e-5, "bf16": 3e-3}
GRAD_TOL = {"f32": 1e-5, "bf16": 6e-2}
OPT_KW = dict(lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dt):
    jdt, tdt = DTYPES[dt]
    return (jconfigs.get_tiny(arch).replace(dtype=jdt, param_dtype=jdt),
            tconfigs.get_tiny(arch).replace(dtype=tdt, param_dtype=tdt))


def _setup(arch, dt, seed=0):
    """(jax model, its TrainState, port model, the port's state from it)."""
    jcfg, tcfg = _cfgs(arch, dt)
    jm = jbuild(jcfg)
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(seed))
    tm = build_model(tcfg, "cpu")
    ts = tsteps.bind_state(tm, train_state_from_jax(
        jax.tree.map(np.asarray, js), tcfg))
    return jm, js, tm, ts


def _batch(cfg, b=4, s=16, seed=0):
    """Token ids with label 0 (padding) in places and non-unit weights."""
    r = np.random.default_rng(seed)
    toks = r.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    toks[0, 5:9] = 0
    toks[2, -3:] = 0
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)},
            {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)})


def _f32(tree, cfg):
    """A reference tree (stacked layers) as the port's fp32 leaves."""
    return params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        tree), cfg.replace(param_dtype=torch.float32))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


# --- loss and gradients ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loss_fn_matches_reference(arch, dt):
    jm, js, tm, _ = _setup(arch, dt)
    jb, tb = _batch(tm.cfg)
    jl, jmet = jm.loss_fn(js.params, jb)
    tl, tmet = tm.loss_fn(tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert sorted(tmet) == sorted(jmet)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL[dt] * abs(float(jl))
    # the mask: labels != 0 times the weight, exactly the same sum
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]),
                               rtol=1e-6)
    assert float(tmet["moe_aux"]) == float(tmet["moe_dropped"]) == 0.0
    # random weights, vocab 512: the loss is near ln(V)
    assert abs(float(tl) - math.log(tm.cfg.padded_vocab)) < 0.5


def test_loss_fn_all_padding_divides_by_one():
    _, _, tm, _ = _setup("granite-3-2b", "f32")
    loss, met = tm.loss_fn({"tokens": torch.zeros((2, 8), dtype=torch.int32)})
    assert float(met["tokens"]) == 0.0 and float(loss) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grads_of_every_leaf_match_jax_grad(arch, dt):
    jm, js, tm, ts = _setup(arch, dt)
    jb, tb = _batch(tm.cfg)
    jg = jax.grad(lambda p: jm.loss_fn(p, jb)[0])(js.params)
    tg, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    want = _f32(jg, tm.cfg)
    assert set(tg) == set(want) == set(dict(tm.lm.named_parameters()))
    for name, g in tg.items():
        assert g.dtype == torch.float32
        assert _rel(g, want[name]) <= GRAD_TOL[dt], name
    # the parameters are frozen again after the backward
    assert not any(p.requires_grad for p in tm.lm.parameters())


def test_tied_embedding_gets_both_gradients():
    _, _, tm, ts = _setup("granite-3-2b", "f32")
    _, tb = _batch(tm.cfg)
    g, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    # rows of ids that never occur in the batch get the unembedding's share
    absent = sorted(set(range(tm.cfg.vocab_size))
                    - set(tb["tokens"].flatten().tolist()))
    assert float(g["embed"][absent].abs().max()) > 0
    assert "lm_head" not in g


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_recomputes_each_block_and_keeps_the_grads(remat, monkeypatch):
    _, _, tm, ts = _setup("llama3-8b", "f32")
    _, tb = _batch(tm.cfg)
    want, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    tm.cfg = tm.lm.cfg = dataclasses.replace(tm.cfg, remat=remat)
    for b in tm.lm.layers:
        b.cfg = tm.cfg
    calls = []
    real = tops.attention
    monkeypatch.setattr(tops, "attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    # 'full' runs each block's forward again in the backward
    assert len(calls) == tm.cfg.num_layers * (2 if remat == "full" else 1)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with torch.no_grad():  # serving: no graph, no recompute
        calls.clear()
        tm.forward(tokens=tb["tokens"])
    assert len(calls) == tm.cfg.num_layers


def test_remat_recompute_keeps_the_oracle_scope_on_another_thread(
        monkeypatch):
    """On the card autograd runs the backward, and so the recompute, on its
    own thread, where the caller's thread-local ``oracle_scope()`` is not
    set: the recompute must still take the plain attention."""
    import threading

    _, _, tm, ts = _setup("llama3-8b", "f32")
    _, tb = _batch(tm.cfg)
    seen = []
    real = tops.attention
    monkeypatch.setattr(tops, "attention", lambda *a, **kw: seen.append(
        tops.oracle_only()) or real(*a, **kw))
    leaves = list(ts.params.values())
    with tsteps._trainable(leaves):
        with tops.oracle_scope():
            loss, _ = tm.loss_fn(tb)
        out = {}
        worker = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, leaves)))
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive() and len(out["g"]) == len(leaves)
    assert seen == [True] * (2 * tm.cfg.num_layers)


def test_remat_dots_runs_and_equals_full():
    """``remat="dots"`` recomputes each block's attention in the backward,
    as "full" does, and gives the same gradients bit for bit; another
    policy name raises ``ValueError``."""
    _, _, tm, ts = _setup("llama3-8b", "f32")
    _, tb = _batch(tm.cfg)
    want, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    calls = []
    real = tops.attention
    tm.lm.cfg = dataclasses.replace(tm.cfg, remat="dots")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "attention",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        got, _ = tsteps._accumulate_grads(tm, ts.params, tb, 1)
    assert len(calls) == 2 * tm.cfg.num_layers
    for name in want:
        assert torch.equal(got[name], want[name]), name
    tm.lm.cfg = dataclasses.replace(tm.cfg, remat="some")
    with pytest.raises(ValueError, match="remat"):
        tsteps._accumulate_grads(tm, ts.params, tb, 1)


# --- the attention gradient ---------------------------------------------------------


def _qkv(b, s, h, kv, hd, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                          (b, s, h, hd))]


@pytest.mark.parametrize("s", [1, 7, 33])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_gradient_matches_jax_grad(s, h, kv, causal):
    """Autograd through the port's ``kops.attention`` (the plain path on
    the CPU) against ``jax.grad`` of the reference's ``attention_ref`` and
    of its model attention ``_sdpa``: fp32, GQA, ragged S, within 1e-5 of
    the largest gradient."""
    q, k, v, do = _qkv(2, s, h, kv, 16, seed=s + h)

    def jloss(f):
        return lambda q, k, v: jnp.sum(f(q, k, v) * do)
    ref_fn = lambda q, k, v: jref.attention_ref(q, k, v, causal=causal)
    sdpa_fn = lambda q, k, v: JNN._sdpa(q, k, v, causal=causal)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tops.attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for f in (ref_fn, sdpa_fn):
        want = jax.grad(jloss(f), argnums=(0, 1, 2))(q, k, v)
        scale = max(float(np.abs(w).max()) for w in want)
        for a, w in zip(got, want):
            assert float(np.abs(a.numpy() - np.asarray(w)).max()) <= 1e-5 * scale
    # the plain backward the CPU wrapper runs is the same gradient
    o, lse = fa.flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal)
    plain = fa.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   o, lse, torch.from_numpy(do), causal=causal)
    for a, b in zip(plain, got):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_attention_lse_ref_is_the_row_logsumexp():
    q, k, v, _ = _qkv(2, 9, 8, 2, 16, seed=3)
    for causal in (True, False):
        tq, tk, tv = (torch.from_numpy(x).double() for x in (q, k, v))
        out, lse = tref.attention_lse_ref(tq, tk, tv, causal=causal)
        assert lse.shape == (2, 8, 9)
        kr = tk.repeat_interleave(4, dim=2)
        sc = torch.einsum("bshd,bthd->bhst", tq, kr) / 4.0
        if causal:
            sc = sc.masked_fill(torch.ones(9, 9).triu(1).bool(), float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(sc, -1))
        torch.testing.assert_close(out, tref.attention_ref(tq, tk, tv,
                                                           causal=causal))


def test_attention_seam_routes_by_grad_and_device(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 5, 4, 2, 16, seed=1))
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("serve") or
                        tref.attention_ref(*a, **kw))
    tops.attention(q, k, v)  # no grad: the serving entry
    assert calls == ["serve"]
    out = tops.attention(q.requires_grad_(True), k, v)  # CPU training: plain
    assert calls == ["serve"] and out.requires_grad
    with torch.no_grad():
        tops.attention(q, k, v)
    assert calls == ["serve", "serve"]
    with tops.oracle_scope():
        assert tops.attention(q, k, v).requires_grad
    assert calls == ["serve", "serve"]


def test_backward_wrappers_check_their_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(1, 5, 4, 2, 16, seed=2))
    o, lse = fa.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :, :4], do)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o[:, :4], lse, do)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q, k, k[:, :, :1])
    before = (fa.flash_attention_lse.launches, fa.flash_attention_bwd.launches)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    # CPU tensors take the plain versions: nothing launched
    assert (fa.flash_attention_lse.launches,
            fa.flash_attention_bwd.launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [hd for hd, dv in fa.KERNEL_HEAD_DIMS if hd == dv])
def test_cuda_flash_backward_matches_autograd_through_plain(cuda, dtype, hd):
    # chip_smoke.py's check: each gradient, every 64-row tile against its
    # own plain norm (FLASH_BWD_TOL, FLASH_BWD_ATOL), at S around every tile
    # edge of the kernels and every group size that changes the dK/dV
    # launch's split of a KV head's query heads
    smoke = _load_smoke()
    for s in smoke.FLASH_TRAIN_SEQS:
        for h, kv in smoke.FLASH_TRAIN_GROUPS:
            for causal in (True, False):
                q, k, v, do = (torch.from_numpy(x).to(cuda, dtype)
                               for x in _qkv(2, s, h, kv, hd, seed=s))
                o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
                assert torch.equal(o, fa.flash_attention(q, k, v, causal=causal))
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                want = tref.attention_bwd_ref(q, k, v, do, causal=causal)
                errs = smoke.bwd_errors(got, want, dtype)
                assert all(e["excess"] <= 1.0 for e in errs.values()), errs
                again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_attention_seam_trains_through_the_kernels(cuda):
    q, k, v, do = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                   for x in _qkv(2, 129, 8, 2, 64, seed=5))
    before = (fa.flash_attention_lse.launches, fa.flash_attention_bwd.launches)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = tops.attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    assert (fa.flash_attention_lse.launches - before[0],
            fa.flash_attention_bwd.launches - before[1]) == (1, 1)
    want = tref.attention_bwd_ref(q, k, v, do)
    errs = _load_smoke().bwd_errors(grads, want, torch.bfloat16)
    assert all(e["excess"] <= 1.0 for e in errs.values()), errs


def test_backward_check_holds_every_tile_to_its_own_norm():
    """chip_smoke.py's backward check on plain gradients (B 2, S 300, causal
    GQA): the plain gradients pass; halving every row past the first
    64-row tile fails each of dq, dk, dv; at S 1, where dq and dk are
    exactly 0, an error below the floor passes."""
    smoke = _load_smoke()
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, 300, 8, 2, 64, seed=9))
    want = tref.attention_bwd_ref(q, k, v, do)
    assert all(e["excess"] == 0.0
               for e in smoke.bwd_errors(want, want, torch.float32).values())
    bad = [w.clone() for w in want]
    for x in bad:
        x[:, smoke.FLASH_BWD_TILE:] *= 0.5
    errs = smoke.bwd_errors(bad, want, torch.bfloat16)
    assert all(e["excess"] > 1.0 and e["rel"] == pytest.approx(0.5)
               for e in errs.values()), errs
    q1, k1, v1, do1 = (x[:, :1] for x in (q, k, v, do))
    dq, dk, dv = tref.attention_bwd_ref(q1, k1, v1, do1)
    assert float(dq.abs().max()) == float(dk.abs().max()) == 0.0
    noise = [x + smoke.FLASH_BWD_ATOL / 2 for x in (dq, dk, dv)]
    assert all(e["excess"] <= 1.0 for e in
               smoke.bwd_errors(noise, (dq, dk, dv), torch.float32).values())


def _cu_constant(name):
    """A ``constexpr int`` of csrc/flash_attention_bwd.cu."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
            "kernels" / "csrc" / "flash_attention_bwd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_flash_train_cases_straddle_every_tile_edge():
    """chip_smoke.py's training cases: at every (q k, p v) width pair, in
    bf16 and fp32,
    causal or not, S one below, at and one above each row tile of the bf16
    backward (the 64-row key items and ring tiles, the 128-row query items
    and ring tiles), S 1 and a long S past a tile edge; in bf16 every group
    size whose dK/dV split differs (1, 2, 4, 8); the planted lse fault's
    head dims among the path's shapes."""
    smoke = _load_smoke()
    cases = smoke.flash_train_cases()
    tiles = (_cu_constant("kKeyRows"), _cu_constant("kDqRows"))
    assert tiles == (64, 128)
    edges = {1} | {t + d for t in tiles for d in (-1, 0, 1)}
    for hd, dv in fa.KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                seqs = {c[1] for c in cases if c[4] == hd and c[7] == dv and
                        c[6] == dtype and c[5] == causal}
                assert edges <= seqs, (hd, dv, dtype, causal, sorted(seqs))
                assert any(s > 4 * tiles[1] and s % tiles[0] for s in seqs)
        groups = {c[2] // c[3] for c in cases
                  if c[4] == hd and c[7] == dv and c[6] == torch.bfloat16}
        assert {1, 2, 4, 8} <= groups, (hd, dv, groups)
    first = {}
    for c in cases:
        first.setdefault(c[4], c)
    assert all(first[hd][1] == 1024 for hd in smoke.FLASH_PLANTED_DIMS)


# what `nvcc -Xptxas -v` prints for some of the flash instances (mangled
# names as nvcc 12 gives them; the anonymous namespace's name varies)
_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_ae30f0d019flash_bwd_dkdv_bf16ILi160ELi160EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_Pfiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_ae30f0d019flash_bwd_dkdv_bf16ILi160ELi160EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_Pfiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_ZN12_GLOBAL__N_117flash_bwd_dq_bf16ILi96ELi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiifi'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_bwd_dq_bf16ILi96ELi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_bwd_dq_bf16ILi96ELi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiifi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_bwd_prepILi16EEEvPK13__nv_bfloat16S3_PKfPfS6_iiix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_bwd_prepILi16EEEvPK13__nv_bfloat16S3_PKfPfS6_iiix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_bwd_sumEPK6float4P5uint2S4_xif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113flash_bwd_sumEPK6float4P5uint2S4_xif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_bwd_dkdv_f32ILi160ELi160ELi1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_bwd_dkdv_f32ILi160ELi160ELi1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_bf16ILi128ELi128ELb1EEEv14CUtensorMap_stS1_S1_S1_iiiifiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_fwd_bf16ILi128ELi128ELb1EEEv14CUtensorMap_stS1_S1_S1_iiiifiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
"""


def test_ptxas_report_names_the_backward_instances(monkeypatch):
    """chip_smoke.py's phase 7 reads the build's ``-Xptxas -v`` output: each
    bf16 backward instance by its (q k, p v) widths, the prep pass by its p
    v width, the sum pass, the fp32 dK/dV launch by its gradients, with
    registers, spill bytes and ptxas's wgmma serialization warning."""
    smoke = _load_smoke()
    monkeypatch.setattr(smoke._build, "LOGS",
                        {"flash_attention_bwd.cu": (1.0, _PTXAS_LOG)})
    got = {r["kernel"]: r for r in smoke.ptxas_report()}
    assert list(got) == ["flash_bwd_dkdv_bf16<160/160>", "flash_bwd_dq_bf16<96/64>",
                         "flash_bwd_prep<16>", "flash_bwd_sum",
                         "flash_bwd_dkdv_f32<160/160, dV>",
                         "flash_fwd_bf16<128/128, lse>"]
    assert got["flash_bwd_dkdv_bf16<160/160>"]["registers"] == 168
    assert got["flash_bwd_dkdv_bf16<160/160>"]["spill_store_bytes"] == 0
    assert (got["flash_bwd_dq_bf16<96/64>"]["spill_store_bytes"],
            got["flash_bwd_dq_bf16<96/64>"]["spill_load_bytes"],
            got["flash_bwd_dq_bf16<96/64>"]["stack_frame_bytes"]) == (4, 4, 8)
    assert got["flash_bwd_sum"]["registers"] == 38
    # ptxas's serialization warning names its instance, and only that one
    assert [k for k, r in got.items() if r["wgmma_serialized"]] == \
        ["flash_bwd_dq_bf16<96/64>"]
    assert all(any(k in r for k in smoke.PORTED_KERNELS) for r in got)


# --- optimizer ------------------------------------------------------------------------


def test_adamw_against_numpy():
    """tests/test_train.py's one-step check on the port."""
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10, b1=0.9,
                         b2=0.95, weight_decay=0.1, clip_norm=1e9)
    w0 = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    params = {"w": torch.from_numpy(w0.copy())}
    grads = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    state = topt.init_opt(params)
    new_p, new_s, _ = topt.apply_updates(params, grads, state, cfg)
    g = grads["w"].numpy()
    mh = 0.1 * g / (1 - 0.9)
    vh = 0.05 * g * g / (1 - 0.95)
    lr = float(topt.schedule(cfg, torch.tensor(1)))
    want = w0 - lr * (mh / (np.sqrt(vh) + cfg.eps) + 0.1 * w0)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert int(new_s.count) == 1 and new_p["w"] is params["w"]


def test_grad_clipping():
    cfg = topt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                         clip_norm=0.1, weight_decay=0.0)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    _, _, metrics = topt.apply_updates(params, grads, topt.init_opt(params), cfg)
    assert float(metrics["grad_norm"]) == 400.0


@pytest.mark.parametrize("kw", [dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
                                dict(lr=1e-2, warmup_steps=0, total_steps=7),
                                dict(lr=5e-3, warmup_steps=3, total_steps=3),
                                dict(lr=2e-3, warmup_steps=10, total_steps=60,
                                     min_lr_frac=0.0)])
def test_schedule_matches_reference(kw):
    steps = np.arange(0, kw["total_steps"] + 5, dtype=np.int32)
    want = np.asarray(jopt.schedule(jopt.OptConfig(**kw), jnp.asarray(steps)))
    got = topt.schedule(topt.OptConfig(**kw), torch.from_numpy(steps)).numpy()
    # a few fp32 ulps: the two libraries' cos and XLA's fused multiply-adds
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_matches_reference():
    r = np.random.default_rng(4)
    tree = {f"x{i}": np.asarray(r.standard_normal(shape) * 10 ** i, np.float32)
            for i, shape in enumerate([(3,), (4, 5), (2, 3, 4), ()])}
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = topt.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_updates_matches_reference_on_the_same_grads(arch, dt):
    jm, js, tm, ts = _setup(arch, dt)
    r = np.random.default_rng(5)
    jgrads = jax.tree.map(lambda p: jnp.asarray(
        r.standard_normal(p.shape).astype(np.float32) * 0.01), js.params)
    jcfg = jopt.OptConfig(**OPT_KW)
    jp, jo, jmet = jopt.apply_updates(js.params, jgrads, js.opt, jcfg)
    tp, to, tmet = topt.apply_updates(ts.params, _f32(jgrads, tm.cfg), ts.opt,
                                      topt.OptConfig(**OPT_KW))
    assert tp is ts.params  # in place
    assert int(to.count) == int(jo.count) == 1
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    assert float(tmet["lr"]) == float(jmet["lr"])
    for got, want in ((to.master, jo.master), (to.m, jo.m), (to.v, jo.v)):
        want = _f32(want, tm.cfg)
        for name in want:
            assert got[name].dtype == torch.float32
            assert _rel(got[name], want[name]) <= 1e-6, name
    want = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg)
    for name, p in tp.items():
        assert p.dtype == tm.cfg.param_dtype
        assert torch.equal(p, to.master[name].to(p.dtype)), name
        # one bf16 ulp where the two masters straddle a rounding point
        assert _rel(p, want[name]) <= (1e-6 if dt == "f32" else 2 ** -7), name


def test_weight_decay_follows_the_reference_leaf_rank():
    """Zero gradients leave only the decay: every leaf the reference decays
    (rank >= 2 there: matrices, the embedding and the stacked (L, d)
    per-layer norms) shrinks by lr * wd, final_norm (d,) does not; the
    port's per-layer norms are (d,) and are decayed all the same."""
    jm, js, tm, ts = _setup("granite-3-2b", "f32")
    zero = jax.tree.map(jnp.zeros_like, js.params)
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.5)
    _, jo, _ = jopt.apply_updates(js.params, zero, js.opt, jopt.OptConfig(**cfg))
    before = {n: m.clone() for n, m in ts.opt.master.items()}
    _, to, tmet = topt.apply_updates(
        ts.params, {n: torch.zeros_like(m) for n, m in before.items()}, ts.opt,
        topt.OptConfig(**cfg))
    want = _f32(jo.master, tm.cfg)
    lr = float(tmet["lr"])
    for name, m in to.master.items():
        decayed = name != "final_norm"
        assert (topt.reference_rank(name, m) >= 2) == decayed
        expect = before[name] * (1 - lr * 0.5) if decayed else before[name]
        torch.testing.assert_close(m, expect, rtol=1e-6, atol=0)
        torch.testing.assert_close(m, want[name], rtol=1e-6, atol=0)
    assert tm.lm.layers[0].ln1.shape == (tm.cfg.d_model,)


# --- the train step -------------------------------------------------------------------


def _check_step(jn, jmet, tn, tmet, cfg, dt, lr, steps=1):
    want = train_state_from_jax(jax.tree.map(np.asarray, jn), cfg)
    assert int(tn.step) == int(want.step) and int(tn.opt.count) == int(want.opt.count)
    assert sorted(tmet) == sorted(jmet)
    for k in ("loss", "grad_norm", "tokens"):
        tol = LOSS_TOL[dt] if k == "loss" else (1e-5 if dt == "f32" else 3e-3)
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=tol,
                                   err_msg=k)
    assert float(tmet["lr"]) == float(jmet["lr"])
    # after more than one step the gradients come from parameters that
    # already differ by the near-zero-gradient elements' moves: 10x (4e-5
    # seen in fp32 after 3 steps)
    mtol = GRAD_TOL[dt] * (10 if steps > 1 else 1)
    for name, wm in want.opt.m.items():
        assert _rel(tn.opt.m[name], wm) <= mtol, name
        assert _rel(tn.opt.v[name], want.opt.v[name]) <= 2 * mtol, name
        d = (tn.opt.master[name] - want.opt.master[name]).abs()
        if steps == 1:  # later steps start from the earlier steps' moves
            big = wm.abs() > 0.05 * wm.abs().max()
            assert float(torch.where(big, d, 0).max()) <= 0.01 * lr + 1e-7, name
        if dt == "f32":
            assert float(d.max()) <= 0.1 * lr * steps, name
        p = tn.params[name]
        assert torch.equal(p, tn.opt.master[name].to(p.dtype)), name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_reference(arch, dt, k):
    jm, js, tm, ts = _setup(arch, dt)
    jb, tb = _batch(tm.cfg)
    jn, jmet = jax.jit(jsteps.make_train_step(
        jm, jopt.OptConfig(**OPT_KW), microbatches=k))(js, jb)
    tn, tmet = tsteps.make_train_step(tm, topt.OptConfig(**OPT_KW),
                                      microbatches=k)(ts, tb)
    assert tn.params is ts.params and tn.ef is None
    _check_step(jn, jmet, tn, tmet, tm.cfg, dt, float(jmet["lr"]))


def test_train_step_refuses_a_state_of_other_tensors():
    _, js, tm, _ = _setup("granite-3-2b", "f32")
    host = train_state_from_jax(jax.tree.map(np.asarray, js), tm.cfg)
    step = tsteps.make_train_step(tm, topt.OptConfig(**OPT_KW))
    with pytest.raises(ValueError, match="bind_state"):
        step(host, _batch(tm.cfg)[1])
    # pod compression needs a pod axis, as the reference asserts; the state
    # itself holds one pod's zero residuals, as the reference's does
    with pytest.raises(ValueError, match="pod"):
        tsteps.make_train_step(tm, topt.OptConfig(), compress_pod=True)
    ef = tsteps.init_train_state(tm, 0, compress_pod=True).ef
    assert sorted(ef) == sorted(tm.lm.state_dict()) and all(
        e.shape == (1,) + tuple(tm.lm.state_dict()[n].shape)
        and e.dtype == torch.float32 and not e.any() for n, e in ef.items())


def test_microbatch_slicing_partition():
    batch = {"x": torch.arange(24).reshape(12, 2)}
    seen = []
    for k in range(4):
        mb = tsteps._microbatch(batch, k, 4)
        assert mb["x"].shape == (3, 2)
        # interleaved: row r belongs to microbatch r mod 4
        assert mb["x"][:, 0].tolist() == [2 * r for r in range(k, 12, 4)]
        seen.append(mb["x"].numpy())
    rows = np.concatenate(seen).tolist()
    assert sorted(map(tuple, rows)) == sorted(
        map(tuple, np.arange(24).reshape(12, 2).tolist()))


def test_microbatch_equivalence():
    """mb=1 and mb=4 give nearly the same update (a mean of per-microbatch
    means against a global mean; bf16 params quantize the gap)."""
    cfg = tconfigs.get_tiny("llama3-8b").replace(remat="none")
    model = build_model(cfg, "cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(1, 256, (8, 16)).astype(np.int32)),
             "weight": torch.ones(8)}
    outs = []
    for mb in (1, 4):
        state = tsteps.init_train_state(model, 0)
        state, _ = tsteps.make_train_step(
            model, topt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10),
            microbatches=mb)(state, batch)
        outs.append({n: p.clone() for n, p in state.params.items()})
    diffs = [float((outs[0][n].float() - outs[1][n].float()).abs().max())
             for n in outs[0]]
    assert max(diffs) < 1e-2, max(diffs)


def test_loss_decreases_overfit():
    """tests/test_train.py's overfit check: 60 steps on one repeated batch
    lower the loss by more than 1.0."""
    cfg = tconfigs.get_tiny("llama3-8b").replace(vocab_size=256, remat="none")
    model = build_model(cfg, "cpu")
    pipe = RelationalTokenPipeline(PipelineConfig(
        seq_len=32, global_batch=8, vocab_size=256, seed=7), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in pipe.global_batch(0).items()}
    step = tsteps.make_train_step(model, topt.OptConfig(
        lr=3e-3, warmup_steps=10, total_steps=200, weight_decay=0.0))
    state = tsteps.init_train_state(model, 0)
    first = None
    for _ in range(60):
        state, metrics = step(state, batch)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first - 1.0, (first, float(metrics["loss"]))


def test_master_params_track_bf16():
    model = build_model(tconfigs.get_tiny("llama3-8b"), "cpu")
    state = tsteps.init_train_state(model, 0)
    batch = {"tokens": torch.ones((4, 8), dtype=torch.int32),
             "weight": torch.ones(4)}
    state, _ = tsteps.make_train_step(model, topt.OptConfig(
        lr=1e-3, warmup_steps=0, total_steps=5))(state, batch)
    for name, p in state.params.items():
        assert state.opt.master[name].dtype == torch.float32
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, state.opt.master[name].to(torch.bfloat16)), name


def test_init_train_state_redraws_from_the_seed():
    cfg = tconfigs.get_tiny("granite-3-2b")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    drawn = {n: p.clone() for n, p in model.lm.named_parameters()}
    state = tsteps.init_train_state(model, 3)
    assert all(torch.equal(state.params[n], t) for n, t in drawn.items())
    assert all(torch.equal(state.opt.master[n], t.float()) for n, t in drawn.items())
    assert int(state.step) == 0 and int(state.opt.count) == 0
    other = tsteps.init_train_state(model, 4)
    assert not torch.equal(other.params["embed"], drawn["embed"])


def test_eval_step_builds_no_graph():
    _, _, tm, _ = _setup("granite-3-2b", "f32")
    jm, js, _, _ = _setup("granite-3-2b", "f32")
    jb, tb = _batch(tm.cfg)
    met = tsteps.make_eval_step(tm)(tb)
    want = jsteps.make_eval_step(jm)(js.params, jb)
    assert not met["loss"].requires_grad and sorted(met) == sorted(want)
    np.testing.assert_allclose(float(met["loss"]), float(want["loss"]), rtol=1e-5)


# --- the loop and the launcher ----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_three_pipeline_steps_match_reference(arch):
    jm, js, tm, ts = _setup(arch, "f32")
    kw = dict(seq_len=16, global_batch=4, vocab_size=tm.cfg.vocab_size, seed=3)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    logs = []
    # a copy: the reference donates its state, and an fp32 master is the
    # parameter's own buffer (astype to the same dtype)
    jstate, jhist = jloop.run(jm, JPipeline(JPipelineConfig(**kw)),
                              jopt.OptConfig(**ocfg),
                              jloop.LoopConfig(total_steps=3, log_every=1),
                              log=lambda s: None,
                              state=jax.tree.map(jnp.array, js))
    tstate, thist = tloop.run(tm, RelationalTokenPipeline(
        PipelineConfig(**kw), device="cpu"), topt.OptConfig(**ocfg),
        tloop.LoopConfig(total_steps=3, log_every=1), log=logs.append,
        state=ts)
    assert len(thist) == len(jhist) == 3 and len(logs) == 3
    assert logs[0].startswith("[step     1] loss=")
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j)
        assert t["step"] == j["step"]
        for k in ("loss", "grad_norm", "tokens", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    _check_step(jstate, {k: jhist[-1][k] for k in jhist[-1]
                         if k not in ("step", "s_per_step")},
                tstate, {k: thist[-1][k] for k in thist[-1]
                         if k not in ("step", "s_per_step")},
                tm.cfg, "f32", ocfg["lr"], steps=3)


def test_train_cli_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "granite-3-2b", "--tiny", "--device", "cpu",
                  "--steps", "3", "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[step     3] loss=") and "ms/step" in out[0]
    assert out[1].startswith("final loss: ")


def test_train_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so 'cuda' resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "granite-3-2b", "--tiny", "--steps", "1"])
    # axes with no devices to split, devices the axes do not split, and pod
    # compression without a pod axis raise before any step
    for flags in (["--model-axis", "2"], ["--pod-axis", "2"],
                  ["--devices", "6", "--model-axis", "4"], ["--compress-pod"],
                  ["--devices", "2", "--compress-pod"]):
        with pytest.raises(ValueError):
            tlaunch.main(["--arch", "granite-3-2b", "--tiny", "--device", "cpu",
                          *flags])


def test_train_microbatches_copy_the_reference():
    assert tconfigs.TRAIN_MICROBATCHES == jconfigs.TRAIN_MICROBATCHES
    for arch in jconfigs.ARCH_IDS + ["no-such-arch"]:
        assert tconfigs.train_microbatches(arch) == jconfigs.train_microbatches(arch)
    assert tconfigs.train_microbatches("granite-3-2b") == 4


def test_train_state_from_jax_carries_every_leaf():
    jm, js, tm, _ = _setup("llama3-8b", "bf16")
    r = np.random.default_rng(6)
    js = js._replace(step=jnp.int32(5), opt=js.opt._replace(
        count=jnp.int32(5),
        m=jax.tree.map(lambda x: jnp.asarray(
            r.standard_normal(x.shape).astype(np.float32)), js.opt.m)))
    host = train_state_from_jax(jax.tree.map(np.asarray, js), tm.cfg)
    assert int(host.step) == 5 and int(host.opt.count) == 5
    names = set(dict(tm.lm.named_parameters()))
    for tree in (host.params, host.opt.master, host.opt.m, host.opt.v):
        assert set(tree) == names
    assert host.params["embed"].dtype == torch.bfloat16
    assert host.opt.m["embed"].dtype == torch.float32
    L = tm.cfg.num_layers
    for i in range(L):
        np.testing.assert_array_equal(host.opt.m[f"layers.{i}.mlp.wo"].numpy(),
                                      np.asarray(js.opt.m["layers"]["mlp"]["wo"][i]))
    state = tsteps.bind_state(tm, host)
    assert state.params["embed"] is dict(tm.lm.named_parameters())["embed"]
    assert torch.equal(state.params["embed"], host.params["embed"])
    assert state.opt.m["embed"] is not host.opt.m["embed"]


# --- chip_smoke.py's phase 16, rehearsed ----------------------------------------------


def _load_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_training_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 16 at granite-3-2b's TINY size on the CPU. A
    CPU tensor launches nothing and trains through plain attention, so the
    seam is pointed at ``FlashAttentionFn`` (whose wrappers take their
    plain versions here) and the wrappers' calls are counted as launches:
    the launch checks, the kernel-against-plain comparison, the bitwise
    crash-resume and the overfit run as on the card; a wrong count fails
    them."""
    smoke = _load_smoke()
    counted = {n: smoke.KERNELS[n][0] for n in ("flash_attention_lse",
                                                "flash_attention_bwd")}
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
        return real_attention(q, k, v, causal=causal)

    monkeypatch.setattr(tops, "attention", attention)
    monkeypatch.setattr(smoke, "get_config", tconfigs.get_tiny)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "NARROW_SEQ", 16)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cpu = torch.device("cpu")
    cfg = tconfigs.get_tiny(smoke.TRAIN_ARCH)
    batches, pipe_ms = smoke.train_batches(cpu, cfg, smoke.TRAIN_STEPS + 2)
    assert len(batches) == 6 and len(pipe_ms) == 6
    plain = smoke.phase_train_plain(cpu, batches[0])
    assert plain["loss_rel_err"] == 0.0  # the same plain math twice
    narrow = smoke.phase_train_narrow(cpu)
    assert narrow["overfit_last_loss"] < narrow["overfit_first_loss"] - 1.0
    train = smoke.phase_train(cpu, batches)
    k = tconfigs.train_microbatches(smoke.TRAIN_ARCH)
    want = smoke.train_launches(cfg, k)
    assert want["flash_attention_lse"] == 2 * cfg.num_layers * k == 16
    assert want["flash_attention_bwd"] == cfg.num_layers * k
    assert train["launches"] == {n: smoke.TRAIN_STEPS * c for n, c in want.items()}
    assert len(train["loss"]) == smoke.TRAIN_STEPS + 1
    assert abs(train["loss"][0] - math.log(cfg.padded_vocab)) < 0.5
    assert train["flops_per_token"] > 6 * train["parameters"]
    # a wrong count fails the phase
    monkeypatch.setattr(fa, "flash_attention_bwd", real["flash_attention_bwd"])
    with pytest.raises(smoke.CheckFailed, match="launched"):
        smoke.phase_train(cpu, batches)
