"""The port's activations (``repro_torch.models.layers``: ``sigmoid``,
``silu``, ``gelu``) against the JAX package's (``jax.nn.sigmoid``,
``jax.nn.silu``, ``jax.nn.gelu``, jitted), and the MLPs and the MoE expert
FFN that use them, on the CPU.

The reference's jaxprs round each op to the activation dtype: sigmoid is
``logistic`` (lowered as 1 / (1 + exp(-x))), SiLU x * logistic(x), GELU
the tanh approximation in nine ops with its constants rounded to the dtype
first. In bf16 the port computes the same ops in the same order, forward
and backward (the gradients as the reference's VJP orders them): the same
bits on 200,000 values spread over +-12. In fp32 each op rounds at 2^-24
and the two libraries' exp and tanh differ by an ulp here and there: held
within ``F32_ULPS`` ulps of max(|x|, 1) forward (measured: 1 for sigmoid,
2 for SiLU and GELU) and ``F32_GRAD_ULPS`` ulps of max(|x|, 1) x
max(|cotangent|, 1) backward (measured 0.7, 1.7 and 9.4), with one torch
thread (several threads take another fp32 tanh on part of the values, up
to ~700 ulps from XLA's on GELU's cancellation near x = -4).

The MLPs (both kinds) and the MoE expert FFN: with an identity down
projection their outputs are the activation's products themselves, the
same bits but where the bf16 matmuls' summation order rounds an input
apart (``MATMUL_ORDER_SHARE`` of the values; measured 0.012% for GELU,
0.018% for SwiGLU and 0.016% for the expert FFN, where the fused torch
activations left 40%, 36% and 36% apart); with random weights the whole
outputs within 3e-2, as ``tests/test_torch_models.py`` holds them.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JNN  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.models import layers as TNN  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

F32_ULPS = 4
F32_GRAD_ULPS = 16
MATMUL_ORDER_SHARE = 1e-3
ACTS = {"sigmoid": (jax.nn.sigmoid, TNN.sigmoid),
        "silu": (jax.nn.silu, TNN.silu),
        "gelu": (jax.nn.gelu, TNN.gelu)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _inputs():
    r = np.random.default_rng(0)
    return ((r.standard_normal(200_000) * 3).astype(np.float32),
            r.standard_normal(200_000).astype(np.float32))


def _both(name, jdt, tdt):
    """(reference value, reference gradient, port value, port gradient) in
    fp32, at ``_inputs``' x and cotangent in the given dtypes."""
    jf, tf = ACTS[name]
    x, c = _inputs()
    xj, cj = jnp.asarray(x).astype(jdt), jnp.asarray(c).astype(jdt)
    yj = jax.jit(jf)(xj)
    gj = jax.jit(lambda x, c: jax.vjp(jf, x)[1](c)[0])(xj, cj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = tf(xt)
    y.backward(torch.from_numpy(c).to(tdt))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return f32(yj), f32(gj), y.detach().float().numpy(), \
        xt.grad.float().numpy()


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_equals_the_jitted_reference_bit_for_bit_in_bf16(name):
    yj, gj, yt, gt = _both(name, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_is_within_a_few_ulps_of_the_reference_in_fp32(name):
    yj, gj, yt, gt = _both(name, jnp.float32, torch.float32)
    x, c = _inputs()
    ulp = np.spacing(np.maximum(np.abs(x), 1.0).astype(np.float32))
    assert float((np.abs(yt - yj) / ulp).max()) <= F32_ULPS
    assert float((np.abs(gt - gj) / (ulp * np.maximum(np.abs(c), 1.0)))
                 .max()) <= F32_GRAD_ULPS


def test_the_fused_torch_activations_round_apart_from_the_reference():
    """What the shared functions replace: ``F.silu``, ``torch.sigmoid`` and
    ``F.gelu(approximate="tanh")`` round once, and leave a third or more of
    the bf16 values an ulp or so apart."""
    x, _ = _inputs()
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    fused = {"sigmoid": torch.sigmoid(xt), "silu": torch.nn.functional.silu(xt),
             "gelu": torch.nn.functional.gelu(xt, approximate="tanh")}
    for name, got in fused.items():
        want = np.asarray(jax.jit(ACTS[name][0])(xj).astype(jnp.float32))
        assert (got.float().numpy() != want).mean() > 0.3, name


def _weights(d, f, seed, identity_out):
    r = np.random.default_rng(seed)
    w = {"wi": r.standard_normal((d, f)) / np.sqrt(d),
         "wg": r.standard_normal((d, f)) / np.sqrt(d),
         "wo": np.eye(f, d) if identity_out else
         r.standard_normal((f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_products_equal_the_reference_but_for_matmul_order(kind):
    x = np.random.default_rng(1).standard_normal((2, 32, 256))
    for identity in (True, False):
        w = _weights(256, 256, 2, identity)
        if kind == "gelu":
            del w["wg"]
        jp = {k: _bf16(v)[0] for k, v in w.items()}
        tp = {k: _bf16(v)[1] for k, v in w.items()}
        want = np.asarray(JNN.mlp_fwd(jp, _bf16(x)[0]).astype(jnp.float32))
        got = TNN.mlp_fwd(tp, _bf16(x)[1]).float().numpy()
        if identity:
            assert (got != want).mean() <= MATMUL_ORDER_SHARE
        else:
            np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_moe_expert_ffn_products_equal_the_reference_but_for_matmul_order():
    r = np.random.default_rng(3)
    toks = r.standard_normal((4, 24, 128))
    w = [_weights(128, 128, 4 + e, True) for e in range(4)]
    stack = {k: np.stack([x[k] for x in w]) for k in ("wi", "wg", "wo")}
    want = np.asarray(JMOE._expert_ffn(
        *(_bf16(stack[k])[0] for k in ("wi", "wg", "wo")), _bf16(toks)[0])
        .astype(jnp.float32))
    got = TMOE._expert_ffn(*(_bf16(stack[k])[1] for k in ("wi", "wg", "wo")),
                           _bf16(toks)[1]).float().numpy()
    assert (got != want).mean() <= MATMUL_ORDER_SHARE
