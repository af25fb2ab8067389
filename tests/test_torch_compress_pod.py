"""The port's int8 error-feedback pod compression (``train/steps.py``:
``_quantize``, ``compress_pod``) and the train state's residuals ``ef``
through ``convert``, the checkpoints and the loop, against the JAX
package on the CPU.

- ``_quantize`` bit for bit against ``repro.train.steps._quantize`` on the
  same fp32 arrays, with halves that round to even.
- One ``compress_pod`` step of ``case_compress_pod``'s model, in fp32, on
  the reference's (2, 2, 2) pod x data x model mesh, from one state (the
  reference's, with nonzero residuals, carried by
  ``convert.train_state_from_jax``), against the reference's step in one
  8-device subprocess; one scale for each of the reference's stacked
  leaves (both layers' ``ln1`` are one leaf there). The two packages sum
  their gradients in another
  order (within 1e-5 of the largest, tests/test_torch_train.py), so an
  element whose ``g / s`` sits that near a half rounds to the next int8
  level in one of them: such elements (counted, under 1% of each leaf)
  may differ by one scale ``s`` in the residual and by Adam's first-step
  move (``lr``) in the master; every other element of the residual is held
  within 2e-3 of the leaf's scale (127 x 1e-5 is 1.3e-3), and of the
  master within 1e-3 of ``lr``. The loss within 1e-5 relative.
- ``compress_pod`` without a pod axis, or with a state of other pods,
  raises ``ValueError``; the residuals ride the checkpoints after ``step``
  (a reference-written one read by the port) and a crash-resume is bit for
  bit.
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, RelationalTokenPipeline)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, train_state_from_jax)
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# case_compress_pod's model and optimizer
KW = dict(arch="t", family="dense", num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8, remat="none")
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20)
FLIP_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(1, 128, (8, 16)).astype(np.int32),
            "weight": np.ones((8,), np.float32)}


# --- _quantize --------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(5)
    # max |g| 127 makes s = 1 + 1e-12 = 1.0 in fp32, so g / s = g: exact
    # halves, which round to even
    halves = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 0.49999997, 62.5], np.float32)
    yield halves
    yield np.zeros((3, 4), np.float32)               # s = 1e-12, q = 0
    yield np.float32(rng.standard_normal(()))       # a scalar leaf
    for scale in (1e-30, 1e-8, 1.0, 3e4):
        yield (rng.standard_normal((17, 33)) * scale).astype(np.float32)
    # every value on a half of its own scale's grid
    s = np.float32(0.37)
    g = (np.arange(-127, 128) + 0.5).astype(np.float32) * s
    yield np.concatenate([g, [np.float32(127) * s]]).astype(np.float32)


def test_quantize_is_the_references_bit_for_bit():
    n = 0
    for a in _arrays():
        jq, js = jsteps._quantize(jnp.asarray(a))
        tq, ts = tsteps._quantize(torch.from_numpy(np.array(a)))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.asarray(js).tobytes() == ts.numpy().tobytes(), a
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        n += a.size
    assert n > 1000
    q, _ = tsteps._quantize(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]  # half to even, as jnp.round


# --- one compressed step against the reference's ------------------------------------


def reference_main(out_path: str) -> None:
    """The reference's side, on 8 host devices: its state with residuals
    drawn from ``default_rng(1)`` (scale 1e-3), one compressed step."""
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models.common import ModelConfig as JConfig
    from repro.models.factory import build_model as jbuild
    from repro.train.optimizer import OptConfig as JOpt

    mesh = jmesh(model=2, pod=2)
    model = jbuild(JConfig(**KW, dtype=jnp.float32,
                           param_dtype=jnp.float32), mesh)
    rng = np.random.default_rng(1)
    with mesh:
        st = jsteps.init_train_state(model, jax.random.PRNGKey(0),
                                     compress_pod=True, n_pods=2)
        st = st._replace(ef=jax.tree.map(lambda e: jnp.asarray(
            rng.standard_normal(e.shape) * 1e-3, jnp.float32), st.ef))
        before = jax.tree.map(np.asarray, st)
        step = jax.jit(jsteps.make_train_step(model, JOpt(**OPT),
                                              compress_pod=True))
        st, met = step(st, {k: jnp.asarray(v) for k, v in _batch().items()})
    # each pod's gradient before quantization, for the scales
    one = jbuild(JConfig(**KW, dtype=jnp.float32, param_dtype=jnp.float32))
    grads = []
    for pod in range(2):
        rows = {k: jnp.asarray(v[4 * pod:4 * pod + 4])
                for k, v in _batch().items()}
        grads.append(jax.tree.map(np.asarray, jax.grad(
            lambda p: one.loss_fn(p, rows)[0])(before.params)))
    with open(out_path, "wb") as f:
        pickle.dump({"mesh": dict(mesh.shape), "before": before,
                     "after": jax.tree.map(np.asarray, st), "grads": grads,
                     "metrics": {k: float(v) for k, v in met.items()}}, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pod") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


def _port_step(ref):
    cfg = ModelConfig(**KW, dtype=torch.float32, param_dtype=torch.float32)
    mesh = make_local_mesh(8, model=2, pod=2)
    assert mesh.shape == ref["mesh"]
    model = build_model(cfg, "cpu", mesh=mesh)
    state = tsteps.bind_state(model, train_state_from_jax(ref["before"], cfg))
    step = tsteps.make_train_step(model, OptConfig(**OPT), compress_pod=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return cfg, step(state, batch)


def test_one_compressed_step_matches_the_reference(reference):
    cfg, (state, met) = _port_step(reference)
    want = train_state_from_jax(reference["after"], cfg)
    before = train_state_from_jax(reference["before"], cfg)
    grads = [params_from_jax(g, cfg) for g in reference["grads"]]
    rm = reference["metrics"]
    assert abs(float(met["loss"]) - rm["loss"]) <= 1e-5 * rm["loss"]
    lr = rm["lr"]
    assert lr > 0 and abs(float(met["lr"]) - lr) < 1e-9
    assert int(state.step) == 1 and sorted(state.ef) == sorted(want.ef)
    groups = tsteps.stacked_leaves(state.ef)
    assert groups["layers.*.ln1"] == ["layers.0.ln1", "layers.1.ln1"]
    for names in groups.values():
        # the reference's scale of this stacked leaf, pod by pod
        s = torch.stack([tsteps._scale([grads[pod][n] + before.ef[n][pod]
                                        for n in names]) for pod in (0, 1)])
        for name in names:
            e = state.ef[name]
            assert e.shape == want.ef[name].shape and e.dtype == torch.float32
            d = (e - want.ef[name]).abs().flatten(1)
            sd = s[:, None].expand_as(d)
            flipped = d > 2e-3 * sd
            assert float(flipped.float().mean()) < FLIP_SHARE, name
            assert bool((d[flipped] <= 1.002 * sd[flipped]).all()), name
            m = (state.opt.master[name] - want.opt.master[name]).abs()
            assert float((m > 1e-3 * lr).float().mean()) < FLIP_SHARE, name
            assert float(m.max()) <= 1.01 * lr, name
    # the residual of a nonzero gradient is nonzero: the step quantized
    assert all(float((e - before.ef[n]).abs().max()) > 0
               for n, e in state.ef.items())


def test_compress_pod_needs_a_pod_axis_and_its_residuals():
    cfg = ModelConfig(**KW)
    for mesh in (None, make_local_mesh(8, model=2)):
        model = build_model(cfg, "cpu", mesh=mesh)
        with pytest.raises(ValueError, match="pod"):
            tsteps.make_train_step(model, OptConfig(**OPT), compress_pod=True)
    model = build_model(cfg, "cpu", mesh=make_local_mesh(8, model=2, pod=2))
    step = tsteps.make_train_step(model, OptConfig(**OPT), compress_pod=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for n_pods in (1, 4):  # a state of other pods' residuals
        with pytest.raises(ValueError, match="ef"):
            step(tsteps.init_train_state(model, 0, compress_pod=True,
                                         n_pods=n_pods), batch)
    with pytest.raises(ValueError, match="ef"):
        step(tsteps.init_train_state(model, 0), batch)
    state = tsteps.init_train_state(model, 0, compress_pod=True, n_pods=2)
    with pytest.raises(ValueError, match="pods"):  # 6 rows over 2 pods x 2
        tsteps.make_train_step(model, OptConfig(**OPT), microbatches=2,
                               compress_pod=True)(
            state, {k: v[:6] for k, v in batch.items()})


def test_one_pod_of_residuals_zero_is_the_exact_step_rounded():
    """On a mesh of one pod the compressed step is the exact step with its
    gradients through int8: the losses equal, the parameters within one
    first-step Adam move."""
    cfg = ModelConfig(**KW)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    mesh = make_local_mesh(8, model=8, pod=1)
    mesh = type(mesh)({"pod": 1, **mesh.shape})
    mc, me = build_model(cfg, "cpu", mesh=mesh), build_model(cfg, "cpu")
    sc = tsteps.init_train_state(mc, 0, compress_pod=True, n_pods=1)
    se = tsteps.init_train_state(me, 0)
    sc, mcm = tsteps.make_train_step(mc, OptConfig(**OPT), compress_pod=True)(
        sc, batch)
    se, mem = tsteps.make_train_step(me, OptConfig(**OPT))(se, batch)
    assert float(mcm["loss"]) == float(mem["loss"])
    lr = float(mem["lr"])
    for n in sc.params:
        assert float((sc.opt.master[n] - se.opt.master[n]).abs().max()) \
            <= 1.01 * lr, n


# --- the residuals through checkpoints and the loop -------------------------------


def test_a_reference_written_ef_checkpoint_reads_in_the_port(tmp_path):
    """The reference's TrainState with residuals, saved by the reference:
    the port reads the leaves (``checkpoint.read_leaves``, verified), maps
    them onto the port's state with ``convert``, and gets the reference's
    residuals in the port's layout; the manifest orders ``ef`` after
    ``step`` in both packages."""
    from repro.models.factory import build_model as jbuild
    from repro.models.common import ModelConfig as JConfig

    jm = jbuild(JConfig(**KW))
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(0), compress_pod=True,
                                 n_pods=2)
    rng = np.random.default_rng(2)
    js = js._replace(ef=jax.tree.map(lambda e: jnp.asarray(
        rng.standard_normal(e.shape), jnp.float32), js.ef))
    jckpt.save(str(tmp_path), 3, js)
    leaves = ckpt.read_leaves(str(tmp_path), 3)
    host = [np.asarray(t.view(torch.int16).numpy().view(np.uint16).view(
        jnp.bfloat16)) if t.dtype == torch.bfloat16 else t.numpy()
        for t in leaves]
    tree = jax.tree.unflatten(jax.tree.structure(js), host)
    cfg = ModelConfig(**KW)
    got = train_state_from_jax(tree, cfg)
    want = train_state_from_jax(jax.tree.map(np.asarray, js), cfg)
    assert sorted(got.ef) == sorted(want.ef)
    for n in want.ef:
        assert got.ef[n].shape[0] == 2 and torch.equal(got.ef[n], want.ef[n])
    # the port's state saves its residuals last, as the reference does
    model = build_model(cfg, "cpu", mesh=make_local_mesh(8, model=2, pod=2))
    state = tsteps.bind_state(model, got)
    ckpt.save(str(tmp_path / "port"), 1, state)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    step_at = names.index("step")
    assert all(n.startswith("ef_") for n in names[step_at + 1:])
    assert len(names) - step_at - 1 == len(got.ef)
    fresh = tsteps.init_train_state(model, 4, compress_pod=True, n_pods=2)
    ckpt.restore(str(tmp_path / "port"), 1, fresh, mesh=model.mesh)
    for n in got.ef:
        assert torch.equal(fresh.ef[n], got.ef[n])


def test_compressed_crash_resume_is_bitwise(tmp_path):
    cfg = ModelConfig(**KW)
    mesh = make_local_mesh(8, model=2, pod=2)
    ocfg = OptConfig(**OPT)

    def pipe():
        return RelationalTokenPipeline(PipelineConfig(
            seq_len=16, global_batch=8, vocab_size=128, seed=5),
            device="cpu")

    def loop(**kw):
        return LoopConfig(total_steps=6, log_every=100, compress_pod=True,
                          **kw)

    model = build_model(cfg, "cpu", mesh=mesh)
    ref, _ = run(model, pipe(), ocfg, loop(), log=lambda s: None)
    want = {n: p.clone() for n, p in ref.params.items()}
    want_ef = {n: e.clone() for n, e in ref.ef.items()}
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure"):
        run(model, pipe(), ocfg, loop(ckpt_dir=d, ckpt_every=2),
            fail_at_step=3, log=lambda s: None)
    logs = []
    got, _ = run(model, pipe(), ocfg, loop(ckpt_dir=d, ckpt_every=2),
                 log=logs.append)
    assert logs[0] == "[resume] from step 2"
    for n in want:
        assert torch.equal(got.params[n], want[n]), n
        assert torch.equal(got.ef[n], want_ef[n]), n


if __name__ == "__main__":
    reference_main(sys.argv[1])
