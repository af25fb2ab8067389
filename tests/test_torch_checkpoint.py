"""The port's checkpoints and crash-resume (repro_torch.train.checkpoint,
train.loop) on the CPU: ``tests/test_checkpoint.py``'s cases and
``tests/test_fault.py``'s crash-resume cases on the port, bitwise, and the
on-disk format against the JAX package's in both directions."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, RelationalTokenPipeline)
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

# tests/test_fault.py's model
CFG = ModelConfig(arch="t", family="dense", num_layers=2, d_model=48,
                  num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128,
                  head_dim=12, rope_theta=1e4, remat="none")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tmp(tmp_path):
    return str(tmp_path)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _like(s):
    return {"a": torch.zeros_like(s["a"]),
            "b": {"c": torch.zeros_like(s["b"]["c"]),
                  "d": torch.zeros_like(s["b"]["d"])},
            "step": torch.zeros_like(s["step"])}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._leaf_paths(tree)]


def _same(a, b):
    assert len(_leaves(a)) == len(_leaves(b))
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --- tests/test_checkpoint.py on the port -----------------------------------------


def test_roundtrip_exact(tmp):
    s = _state()
    ckpt.save(tmp, 10, s)
    like = _like(s)
    r = ckpt.restore(tmp, 10, like)
    assert r is like  # loaded in place
    _same(r, s)


def test_atomic_commit_ignores_partial(tmp):
    ckpt.save(tmp, 1, _state())
    os.makedirs(os.path.join(tmp, "tmp.2"))
    with open(os.path.join(tmp, "tmp.2", "00000_a.npy"), "wb") as f:
        f.write(b"garbage")
    os.makedirs(os.path.join(tmp, "step_00000003"))
    assert ckpt.list_steps(tmp) == [1]
    assert ckpt.latest_step(tmp) == 1


def test_retention(tmp):
    s = _state()
    for i in range(1, 6):
        ckpt.save(tmp, i, s, keep=2)
    assert ckpt.list_steps(tmp) == [4, 5]


def test_async_save(tmp):
    s = _state()
    before = s["a"].clone()
    t = ckpt.save(tmp, 42, s, blocking=False)
    s["a"].add_(1.0)  # the snapshot was taken before save returned
    t.join()
    assert ckpt.latest_step(tmp) == 42
    r = ckpt.restore(tmp, 42, _like(s))
    assert torch.equal(r["a"], before)


def test_manager_resume(tmp):
    s = _state()
    mgr = ckpt.CheckpointManager(tmp, every=2, keep=3)
    assert mgr.maybe_save(1, s) is False
    assert mgr.maybe_save(2, s) is True
    mgr.wait()
    restored, step = mgr.resume(_like(s))
    assert step == 2
    _same(restored, s)


def test_resume_empty_dir(tmp):
    mgr = ckpt.CheckpointManager(tmp)
    restored, step = mgr.resume({"x": torch.zeros(())})
    assert restored is None and step == 0


def _corrupt_leaf(tmp, step, idx=-1, *, truncate=None, flip=False):
    d = os.path.join(tmp, f"step_{step:08d}")
    leaf = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[idx]
    path = os.path.join(d, leaf)
    with open(path, "r+b") as f:
        if truncate is not None:
            f.truncate(truncate)
        if flip:
            f.seek(-1, 2)
            b = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([b[0] ^ 0xFF]))


def test_restore_detects_truncation(tmp):
    s = _state()
    ckpt.save(tmp, 5, s)
    _corrupt_leaf(tmp, 5, truncate=40)
    like = _like(s)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(tmp, 5, like)
    _same(like, _like(s))  # nothing written into like


def test_restore_detects_bitflip(tmp):
    s = _state()
    ckpt.save(tmp, 5, s)
    _corrupt_leaf(tmp, 5, flip=True)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(tmp, 5, _like(s))


def test_resume_falls_back_past_corrupt_newest(tmp):
    s = _state()
    ckpt.save(tmp, 10, s)
    ckpt.save(tmp, 20, s)
    _corrupt_leaf(tmp, 20, truncate=10)
    mgr = ckpt.CheckpointManager(tmp)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        restored, step = mgr.resume(_like(s))
    assert step == 10
    _same(restored, s)


def test_list_steps_skips_unreadable_manifest(tmp):
    s = _state()
    ckpt.save(tmp, 1, s)
    ckpt.save(tmp, 2, s)
    with open(os.path.join(tmp, "step_00000002", "manifest.json"), "w") as f:
        f.write("{half-written")
    assert ckpt.list_steps(tmp) == [1]
    assert ckpt.latest_step(tmp) == 1
    with pytest.raises(ckpt.CheckpointCorruptError, match="manifest"):
        ckpt.restore(tmp, 2, _like(s))


def test_restore_detects_a_missing_leaf_and_a_tree_mismatch(tmp):
    s = _state()
    ckpt.save(tmp, 3, s)
    d = os.path.join(tmp, "step_00000003")
    os.remove(os.path.join(d, sorted(os.listdir(d))[0]))
    with pytest.raises(ckpt.CheckpointCorruptError, match="unreadable"):
        ckpt.restore(tmp, 3, _like(s))
    ckpt.save(tmp, 4, s)
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(tmp, 4, {"a": torch.zeros(8, 16)})


# --- the format, against the reference ---------------------------------------------


def _jax_state():
    k = jax.random.PRNGKey(0)
    return {"a": jax.random.normal(k, (8, 16), jnp.float32),
            "b": {"c": jnp.arange(5, dtype=jnp.int32),
                  "d": jax.random.normal(k, (3,), jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def test_reference_checkpoint_loads_in_the_port(tmp):
    js = _jax_state()
    jckpt.save(tmp, 3, js)
    like = {"a": torch.zeros(8, 16), "b": {"c": torch.zeros(5, dtype=torch.int32),
                                           "d": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}
    got = ckpt.restore(tmp, 3, like)
    for (name, t), j in zip(ckpt._leaf_paths(got), jax.tree.leaves(js)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:  # the same bits
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  j.view(np.uint16)), name
        else:
            assert np.array_equal(t.numpy(), j), name
    # saved again by the port: the same files and manifest entries (names,
    # shapes, dtypes, byte counts and digests) as the reference wrote
    ckpt.save(tmp, 4, got)
    manifests = []
    for step in (3, 4):
        d = os.path.join(tmp, f"step_{step:08d}")
        with open(os.path.join(d, ckpt.MANIFEST)) as f:
            manifests.append(json.load(f)["leaves"])
        assert sorted(os.listdir(d)) == sorted(
            [m["file"] for m in manifests[-1]] + [ckpt.MANIFEST])
    assert manifests[0] == manifests[1]
    assert [m["dtype"] for m in manifests[1]] == ["float32", "int32", "bfloat16",
                                                  "int32"]


def test_port_checkpoint_verifies_in_the_reference(tmp):
    s = _state()
    ckpt.save(tmp, 9, s)
    like = jax.eval_shape(lambda: _jax_state())
    r = jckpt.restore(tmp, 9, like)
    for (name, t), j in zip(ckpt._leaf_paths(s), jax.tree.leaves(r)):
        assert str(np.asarray(j).dtype) == ckpt._NAMES[t.dtype], name
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy(), err_msg=name)
    # and a corrupt leaf fails the reference's check as well
    _corrupt_leaf(tmp, 9, flip=True)
    with pytest.raises(jckpt.CheckpointCorruptError):
        jckpt.restore(tmp, 9, like)


def test_train_state_round_trip_restores_the_model(tmp):
    model = build_model(CFG, "cpu")
    state = tsteps.init_train_state(model, 0)
    batch = {"tokens": torch.randint(1, 128, (4, 12), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(1)),
             "weight": torch.ones(4)}
    state, _ = tsteps.make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1,
                                                       total_steps=5))(state, batch)
    saved = [t.clone() for t in _leaves(state)]
    ckpt.save(tmp, 1, state)
    names = [n for n, _ in ckpt._leaf_paths(state)]
    # TrainState's fields in order, each dict's keys sorted; ef holds none
    assert names[0] == "params_embed" and names[-1] == "step"
    assert "opt_count" in names and "opt_master_layers.0.ln1" in names
    fresh = tsteps.init_train_state(model, 5)  # other weights in the model
    restored = ckpt.restore(tmp, 1, fresh)
    for a, b in zip(_leaves(restored), saved):
        assert torch.equal(a, b)
    assert all(restored.params[n] is p for n, p in model.lm.named_parameters())


# --- tests/test_fault.py on the port -----------------------------------------------


def _pipe():
    return RelationalTokenPipeline(PipelineConfig(
        seq_len=24, global_batch=8, vocab_size=128, seed=5), device="cpu")


def _params(state):
    return {n: p.clone() for n, p in state.params.items()}


def test_crash_resume_bitwise(tmp_path):
    model = build_model(CFG, "cpu")
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    ref, _ = run(model, _pipe(), ocfg, LoopConfig(total_steps=14, log_every=100),
                 log=lambda s: None)
    want = _params(ref)
    d = str(tmp_path / "ckpt")
    lcfg = LoopConfig(total_steps=14, ckpt_dir=d, ckpt_every=4, log_every=100)
    with pytest.raises(RuntimeError, match="injected failure"):
        run(model, _pipe(), ocfg, lcfg, fail_at_step=10, log=lambda s: None)
    logs = []
    resumed, _ = run(model, _pipe(), ocfg, lcfg, log=logs.append)
    assert logs[0] == "[resume] from step 8"
    for name, p in want.items():
        assert torch.equal(resumed.params[name], p), name
    assert int(resumed.step) == 14


def test_double_crash_resume(tmp_path):
    model = build_model(CFG, "cpu")
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    ref, _ = run(model, _pipe(), ocfg, LoopConfig(total_steps=12, log_every=100),
                 log=lambda s: None)
    want = _params(ref)
    d = str(tmp_path / "ckpt2")
    lcfg = LoopConfig(total_steps=12, ckpt_dir=d, ckpt_every=3, log_every=100)
    for fail_at in (5, 9):
        with pytest.raises(RuntimeError):
            run(model, _pipe(), ocfg, lcfg, fail_at_step=fail_at,
                log=lambda s: None)
    final, _ = run(model, _pipe(), ocfg, lcfg, log=lambda s: None)
    for name, p in want.items():
        assert torch.equal(final.params[name], p), name
