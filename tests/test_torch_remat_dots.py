"""``remat="dots"`` in the port (``models/transformer.remat_context``:
``torch.utils.checkpoint`` with a selective policy that keeps the
``aten.mm``/``aten.addmm`` outputs, the reference's
``dots_with_no_batch_dims_saveable``) on the CPU at TINY, in fp32, for
every family: dense, MoE, MLA, the Mamba2 hybrid, xLSTM and the
encoder-decoder.

- The loss and every gradient leaf under "dots" equal the port's under
  "full" bit for bit (the recompute runs the same ops, and the kept
  products are the forward's own), and match the JAX package's under
  "dots" (the loss within 1e-5 relative, each leaf within 5e-5 of its
  largest value: the families' fp32 bounds).
- What the policy keeps: each x·W product of a block, and no batched
  product: a dense block keeps its 7 (wq, wk, wv, wo, wi, wg, wo), and
  the kept outputs are handed back, not run again, in the backward (the
  products run under "full" less those under "dots").
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCHS = ["granite-3-2b", "qwen2-moe-a2.7b", "minicpm3-4b", "zamba2-1.2b",
         "xlstm-1.3b", "whisper-base"]
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, remat="dots"):
    jcfg = jconfigs.get_tiny(arch).replace(dtype=jnp.float32,
                                           param_dtype=jnp.float32,
                                           remat=remat)
    tcfg = tconfigs.get_tiny(arch).replace(dtype=torch.float32,
                                           param_dtype=torch.float32,
                                           remat=remat)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tm.lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    return jm, jp, tm


def _batch(cfg, b=2, s=32, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "weight": jnp.asarray(w)}
    tb = {"tokens": torch.from_numpy(toks), "weight": torch.from_numpy(w)}
    if cfg.family == "audio":
        e = r.standard_normal((b, 12, cfg.d_model)).astype(np.float32)
        jb["embeds"], tb["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def _grads(tm, tb, remat):
    tm.cfg = tm.lm.cfg = tm.cfg.replace(remat=remat)
    for m in tm.lm.modules():
        if hasattr(m, "cfg"):
            m.cfg = tm.cfg
    return tsteps._accumulate_grads(tm, dict(tm.lm.named_parameters()), tb, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_full_and_the_reference(arch):
    jm, jp, tm = _models(arch)
    jb, tb = _batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, jb)[0]))(jp)
    want = params_from_jax(jax.tree.map(np.asarray, jg), tm.cfg)
    dots, dmet = _grads(tm, tb, "dots")
    full, fmet = _grads(tm, tb, "full")
    assert float(dmet["loss"]) == float(fmet["loss"])
    assert abs(float(dmet["loss"]) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert set(dots) == set(full) == set(want)
    for name, g in dots.items():
        assert torch.equal(g, full[name]), name
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= GRAD_TOL * scale, name


def _policy_log(monkeypatch):
    """Record every decision of the policy: (is_recompute, op, kept)."""
    seen = []
    real = TF.dots_policy

    def policy(ctx, op, *a, **kw):
        out = real(ctx, op, *a, **kw)
        seen.append((ctx.is_recompute, op, out == CheckpointPolicy.MUST_SAVE))
        return out

    monkeypatch.setattr(TF, "dots_policy", policy)
    return seen


class _CountMM(TorchDispatchMode):
    """Counts the products run (a kept output handed back by the policy's
    recompute is not run, so not counted)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in TF.SAVED_DOTS
        return func(*args, **(kwargs or {}))


def _products_run(tm, tb, remat) -> int:
    with _CountMM() as count:
        _grads(tm, tb, remat)
    return count.n


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_dots_keeps_each_blocks_projections(arch, monkeypatch):
    _, _, tm = _models(arch)
    _, tb = _batch(tm.cfg)
    full = _products_run(tm, tb, "full")
    seen = _policy_log(monkeypatch)
    dots = _products_run(tm, tb, "dots")
    kept_fwd = [op for rec, op, kept in seen if kept and not rec]
    layers = tm.cfg.num_layers
    # dense: the attention's 4 and the SwiGLU's 3 products a block; MoE:
    # the router's and the shared expert's 3 instead of the MLP's (the
    # experts' batched products are recomputed)
    per_block = 7 if tm.cfg.family == "dense" else 4 + 1 + 3
    assert len(kept_fwd) == per_block * layers
    assert set(kept_fwd) <= set(TF.SAVED_DOTS)
    # the kept products are handed back in the backward, not run again;
    # a block's last product feeds no backward, so the recompute stops
    # before it under either policy (checkpoint's early stop)
    assert len(kept_fwd) - layers <= full - dots <= len(kept_fwd)
    batched = {torch.ops.aten.bmm.default}
    assert not any(kept for _, op, kept in seen if op in batched)
    assert any(op in batched for _, op, _ in seen)  # attention's, recomputed


def test_dots_keeps_nothing_outside_training():
    """Serving builds no graph: "dots" runs the blocks plainly."""
    _, _, tm = _models("granite-3-2b")
    tm.cfg = tm.lm.cfg = tm.cfg.replace(remat="dots")
    with torch.no_grad():
        logits, _, _ = tm.forward(tokens=torch.ones((1, 8), dtype=torch.int32))
    assert logits.shape[:2] == (1, 8)
