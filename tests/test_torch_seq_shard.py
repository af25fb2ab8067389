"""The port's seq-sharded decodes (``models/layers.py``: GQA's
``_flash_decode_sharded``, MLA's ``_mla_flash_decode_sharded``) against the
JAX package's plain decode, in process on the CPU, on numpy inputs from a
seed and the reference's weights (converted).

- GQA at ``case_flash_decode_shard``'s shapes (B 4, a 64-row fp32 cache of
  2 KV heads of 8, 8 query heads), for both branches of ``decode_layout``:
  the batch divides the data-parallel axes (the cache split over the model
  axis) and it does not (B 1, or B 2 on a pod mesh: split over every
  axis). Tolerance 2e-4, the reference's own (tests/test_dist.py); each
  merge is 2 psums and 1 pmax.
- MLA at minicpm3-4b's TINY in fp32 with ``mla_seq_shard``: the output
  within 2e-4 of the reference's plain absorbed decode; the latent caches
  after the write equal to the port's unsharded write bit for bit, and to
  the reference's within 1e-5 (the new row's fp32 rounding).
- A cache the shards do not divide raises ``ValueError``; the flags off,
  or a model axis of 1, take the plain decode (no merge counted).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JNN  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro.models.common import ShardingRules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.mesh import NamedMesh  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import layers as TNN  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

TOL = 2e-4
RULES = ShardingRules({}, False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _gqa(b, seed=0):
    """The case's config, the reference's weights (bf16, as its init draws
    them) as fp32 tensors for the port, an fp32 cache and query."""
    kw = dict(arch="d", family="dense", num_layers=1, d_model=64,
              num_heads=8, num_kv_heads=2, d_ff=64, vocab_size=64,
              head_dim=8, decode_seq_shard=True)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jp, _ = JNN.init_attention(jax.random.PRNGKey(0), jcfg, RULES)
    rng = np.random.default_rng(seed)
    cache = {n: rng.standard_normal((b, 64, 2, 8)).astype(np.float32)
             for n in ("k", "v")}
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    return jcfg, tcfg, jp, {n: _t(v) for n, v in jp.items()}, cache, x


@pytest.mark.parametrize("shape,b,shards", [
    ({"data": 2, "model": 4}, 4, 4),        # batch over data, seq over model
    ({"data": 2, "model": 4}, 1, 8),        # B 1: seq over every axis
    ({"pod": 2, "data": 2, "model": 2}, 4, 2),
    ({"pod": 2, "data": 2, "model": 2}, 2, 8),
])
@pytest.mark.parametrize("pos", [17, 0, 63])
def test_gqa_sharded_decode_matches_the_reference_plain_decode(shape, b,
                                                               shards, pos):
    jcfg, tcfg, jp, tp, cache, x = _gqa(b)
    jrope = JNN.rope_tables(jnp.arange(1) + pos, jcfg.hd, 1e4)
    want, jcache = JNN.attention_fwd(
        jp, jnp.asarray(x), jcfg, mode="decode", rope=jrope, pos=pos,
        cache={n: jnp.asarray(v) for n, v in cache.items()}, mesh=None)
    mesh = NamedMesh(shape)
    view = mesh.view(TNN.decode_layout(mesh.shape, b)[1])
    assert view.axis_size == shards
    trope = TNN.rope_tables(torch.arange(1) + pos, tcfg.hd, 1e4)
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    with torch.no_grad():
        got, tcache = TNN.attention_fwd(tp, torch.from_numpy(x), tcfg,
                                        mode="decode", rope=trope, pos=pos,
                                        cache=tcache, mesh=mesh)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err < TOL, err
    assert dict(mesh.counts) == {"psum": 2, "pmax": 1}
    for n in ("k", "v"):  # the write is the unsharded one
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   rtol=0, atol=1e-6)


def test_gqa_sharded_decode_reads_every_shard():
    """A cache row past kv_len (garbage, here 1e4) is masked in every shard;
    a row in the last shard moves the output (its shard is merged)."""
    _, tcfg, _, tp, cache, x = _gqa(4)
    mesh = make_local_mesh(8, model=8)
    rope = TNN.rope_tables(torch.arange(1) + 62, tcfg.hd, 1e4)

    def run(c):
        with torch.no_grad():
            return TNN.attention_fwd(
                tp, torch.from_numpy(x), tcfg, mode="decode", rope=rope,
                pos=62, mesh=mesh,
                cache={n: torch.from_numpy(v.copy()) for n, v in c.items()})[0]

    base = run(cache)
    poisoned = {n: v.copy() for n, v in cache.items()}
    poisoned["v"][:, 63] = 1e4            # past pos + 1: masked
    assert torch.equal(run(poisoned), base)
    moved = {n: v.copy() for n, v in cache.items()}
    moved["v"][:, 60] += 5.0              # the last shard's rows 56..63
    assert float((run(moved) - base).abs().max()) > 1e-2


def test_a_cache_the_shards_do_not_divide_raises():
    _, tcfg, _, tp, _, x = _gqa(4)
    cache = {n: torch.zeros((4, 60, 2, 8)) for n in ("k", "v")}
    rope = TNN.rope_tables(torch.arange(1) + 3, tcfg.hd, 1e4)
    with pytest.raises(ValueError, match="does not split"):
        TNN.attention_fwd(tp, torch.from_numpy(x), tcfg, mode="decode",
                          rope=rope, pos=3, cache=cache,
                          mesh=make_local_mesh(8, model=8))
    # the flag off, or a model axis of 1: the plain decode, no merge
    for cfg, mesh in ((tcfg.replace(decode_seq_shard=False),
                       make_local_mesh(8, model=8)),
                      (tcfg, make_local_mesh(8, model=1))):
        TNN.attention_fwd(tp, torch.from_numpy(x), cfg, mode="decode",
                          rope=rope, pos=3, cache=cache, mesh=mesh)
        assert not mesh.counts


def _mla(b, t, seed=0):
    jcfg = jconfigs.get_tiny("minicpm3-4b").replace(
        dtype=jnp.float32, param_dtype=jnp.float32, mla_seq_shard=True)
    tcfg = tconfigs.get_tiny("minicpm3-4b").replace(
        dtype=torch.float32, param_dtype=torch.float32, mla_seq_shard=True)
    jp, _ = JNN.init_mla(jax.random.PRNGKey(1), jcfg, RULES)
    rng = np.random.default_rng(seed)
    cache = {"c_kv": rng.standard_normal((b, t, jcfg.mla_kv_lora)),
             "k_rope": rng.standard_normal((b, t, jcfg.mla_rope_dim))}
    cache = {n: v.astype(np.float32) for n, v in cache.items()}
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, {n: _t(v) for n, v in jp.items()}, cache, x


@pytest.mark.parametrize("shape,b", [({"data": 2, "model": 4}, 4),
                                     ({"data": 2, "model": 4}, 1)])
@pytest.mark.parametrize("pos", [0, 21, 63])
def test_mla_sharded_decode_matches_the_reference_absorbed_decode(shape, b,
                                                                  pos):
    jcfg, tcfg, jp, tp, cache, x = _mla(b, 64)
    jrope = JNN.rope_tables(jnp.arange(1) + pos, jcfg.mla_rope_dim,
                            jcfg.rope_theta)
    want, jcache = JNN.mla_fwd(jp, jnp.asarray(x), jcfg, mode="decode",
                               rope=jrope, pos=pos, mesh=None,
                               cache={n: jnp.asarray(v)
                                      for n, v in cache.items()})
    mesh = NamedMesh(shape)
    trope = TNN.rope_tables(torch.arange(1) + pos, tcfg.mla_rope_dim,
                            tcfg.rope_theta)
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    with torch.no_grad():
        got, tcache = TNN.mla_fwd(tp, torch.from_numpy(x), tcfg,
                                  mode="decode", rope=trope, pos=pos,
                                  cache=tcache, mesh=mesh)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err < TOL, err
    assert dict(mesh.counts) == {"psum": 2, "pmax": 1}
    # the write landed on one shard, at pos: the port's unsharded write bit
    # for bit, and the reference's new row within fp32 rounding
    plain = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    with torch.no_grad():
        TNN.mla_fwd(tp, torch.from_numpy(x), tcfg, mode="decode", rope=trope,
                    pos=pos, cache=plain)
    for n in ("c_kv", "k_rope"):
        assert torch.equal(tcache[n], plain[n]), n
        assert not torch.equal(tcache[n][:, pos], torch.from_numpy(cache[n])[
            :, pos])
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   rtol=0, atol=1e-5)


def test_mla_seq_shard_off_is_the_plain_decode():
    _, tcfg, _, tp, cache, x = _mla(2, 64)
    mesh = NamedMesh({"data": 2, "model": 4})
    rope = TNN.rope_tables(torch.arange(1) + 5, tcfg.mla_rope_dim,
                           tcfg.rope_theta)
    TNN.mla_fwd(tp, torch.from_numpy(x), tcfg.replace(mla_seq_shard=False),
                mode="decode", rope=rope, pos=5, mesh=mesh,
                cache={n: torch.from_numpy(v.copy()) for n, v in cache.items()})
    assert not mesh.counts
    with pytest.raises(ValueError, match="does not split"):
        TNN.mla_fwd(tp, torch.from_numpy(x), tcfg, mode="decode", rope=rope,
                    pos=5, mesh=mesh,
                    cache={n: torch.zeros((2, 62, t.shape[-1]))
                           for n, t in ((k, torch.from_numpy(v))
                                        for k, v in cache.items())})


@pytest.mark.parametrize("arch,flag", [("llama3-8b", "decode_seq_shard"),
                                       ("minicpm3-4b", "mla_seq_shard")])
def test_generate_over_a_mesh_tracks_the_one_device_decode(arch, flag):
    """The whole model in fp32 at TINY: prompts of 24 tokens and 8 greedy
    tokens teacher-forced, the sharded decode's logits within 2e-4 of the
    one-device decode's on the same weights, 2 psums + 1 pmax a layer a
    step."""
    cfg = tconfigs.get_tiny(arch).replace(dtype=torch.float32,
                                          param_dtype=torch.float32,
                                          **{flag: True})
    model = build_model(cfg, "cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (4, 24)).astype(np.int32))
    plain = generate(model, tok, 8, keep_logits=True)
    model.mesh = make_local_mesh(8, model=8)
    shard = generate(model, tok, 8, keep_logits=True, forced=plain.tokens)
    err = max(float((a - b).abs().max())
              for a, b in zip(plain.logits, shard.logits))
    assert err < TOL, err
    assert dict(model.mesh.counts) == {"psum": 2 * 7 * cfg.num_layers,
                                       "pmax": 7 * cfg.num_layers}
