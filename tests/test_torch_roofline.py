"""The port's H100 roofline (``repro_torch.roofline.analysis``) on the CPU:
``count_params``, ``active_params`` and ``model_flops`` against the
reference's for all 10 archs on the (16, 16) mesh (the port's model on
meta), the reference's depth-pair and dominance cases against the H100's
constants, ``StepCost``'s rules (a product's FLOPs, free views, the slice
update, score-shaped bytes, the live peak, the kernels' meta route, the
mesh's collectives), the count's affinity in depth for a TINY cell of each
family, and a TINY dense cell's collectives on a (2, 4) mesh counted by
hand."""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.roofline import analysis as RRA  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_tiny  # noqa: E402
from repro_torch.core.mesh import NamedMesh  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402

MESH = {"data": 16, "model": 16}
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=BF, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# --- the reference's pure functions ----------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_active_params_and_model_flops_are_the_references(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    rmodel = ref_build(rcfg, SimpleNamespace(shape=MESH))
    want = RRA.count_params(jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)))
    got = RA.count_params(build_model(cfg, "meta", mesh=NamedMesh(MESH)).lm)
    assert got == want
    assert RA.active_params(cfg, got) == RRA.active_params(rcfg, want)
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                       ("decode", 128, 32768)):
        assert RA.model_flops(cfg, got, kind, b, s) == \
            RRA.model_flops(rcfg, want, kind, b, s)


def test_llama3_and_dbrx_counts():
    pc = RA.count_params(build_model(get_config("llama3-8b"), "meta").lm)
    assert pc == {"total": 8_030_261_248, "embed": 1_050_673_152}
    dbrx = get_config("dbrx-132b")
    dpc = RA.count_params(build_model(dbrx, "meta").lm)
    assert RA.active_params(dbrx, dpc) < 0.4 * dpc["total"]


def test_depth_pair_extrapolation():
    pair = RA.DepthPair(1, 2, {"flops": 110.0, "bytes": 60.0},
                        {"flops": 210.0, "bytes": 110.0})
    per = pair.per_layer()
    assert per["flops"] == 100.0 and per["bytes"] == 50.0
    at32 = pair.at(32)
    assert at32["flops"] == 10 + 32 * 100
    assert at32["bytes"] == 10 + 32 * 50


def test_roofline_terms_dominance_on_the_h100():
    assert (RA.PEAK_FLOPS, RA.HBM_BW, RA.NVLINK_BW) == (989e12, 3.35e12, 900e9)
    t = RA.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 2.0) < 1e-9
    assert abs(t["collective_s"] - 0.5) < 1e-9
    assert t["dominant"] == "memory" and t["bound_s"] == t["memory_s"]
    assert RA.roofline_terms(1e15, 1e9, 0)["dominant"] == "compute"
    if not torch.cuda.is_available():
        assert RA.device_memory() == 80 * 10**9


# --- StepCost's rules ------------------------------------------------------


def test_a_product_counts_its_flops_and_its_bytes():
    a, b = _meta(64, 128), _meta(128, 32)
    with RA.StepCost() as c:
        a @ b
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 2
    assert c.ops == 1 and c.kernel_calls == {}


def test_views_reshapes_and_expands_are_free():
    x = _meta(4, 64)
    with RA.StepCost() as c:
        x.view(8, 32).reshape(2, 128).t()
        x.transpose(0, 1)
        y = x[:, None].expand(4, 3, 64)
        x[1:3]
    assert c.bytes == 0 and c.ops == 0 and c.peak_live == 0
    z = _meta(4, 3, 64)
    with RA.StepCost() as c:
        y * z  # the expanded input is read once: 4 x 64, not 4 x 3 x 64
    assert c.bytes == (4 * 64 + 2 * 4 * 3 * 64) * 2


def test_slice_updates_count_the_slice_read_and_written():
    cache = _meta(8, 100, 16)
    src = _meta(8, 2, 16)
    idx = torch.empty(2, dtype=torch.long, device="meta")
    with RA.StepCost() as c:
        cache[:, 10:12] = src
        cache.index_copy_(1, idx, src)
    assert c.bytes == 2 * (2 * src.numel() * 2)
    assert c.peak_live == 0  # in place: nothing allocated


def test_score_shaped_bytes_are_reported_apart():
    s, small = _meta(2, 2048, 4096), _meta(2, 2047, 4096)
    with RA.StepCost() as c:
        s * 2
        small * 2
    assert c.score_bytes == 2 * s.numel() * 2
    assert c.bytes == c.score_bytes + 2 * small.numel() * 2


def test_the_live_peak_counts_allocations_until_freed():
    x = _meta(1024, dtype=torch.float32)
    with RA.StepCost() as c:
        a = x * 2
        b = a * 2
        del a
        d = b * 2
        del b, d
    assert c.peak_live == 2 * 4096 and c.live == 0


def test_the_flash_entries_record_their_work_on_meta():
    b, s, h, kv, hd = 2, 256, 4, 2, 16
    q = _meta(b, s, h, hd, grad=True)
    k, v = _meta(b, s, kv, hd, grad=True), _meta(b, s, kv, hd, grad=True)
    pairs = b * h * s * (s + 1) / 2
    with RA.StepCost() as c:
        out = kops.attention(q, k, v, causal=True)
        assert out.shape == (b, s, h, hd) and out.device.type == "meta"
        torch.autograd.grad(out.sum(), [q, k, v])
    assert c.kernel_calls == {"flash_attention_lse": 1,
                              "flash_attention_bwd": 1}
    assert c.kernel_flops == 2 * 2 * hd * pairs + 2 * 5 * hd * pairs
    with RA.StepCost() as c:
        kops.attention(q.detach(), k.detach(), v.detach(), causal=False)
    assert c.kernel_calls == {"flash_attention": 1}
    assert c.kernel_flops == 2 * 2 * hd * b * h * s * s
    # q, k, v read once, the output written once
    assert c.kernel_bytes == 2 * (2 * q.numel() + k.numel() + v.numel())
    with pytest.raises(TypeError, match="head dims"):
        kops.attention(_meta(1, 8, 2, 32), _meta(1, 8, 2, 32),
                       _meta(1, 8, 2, 32))


def test_the_histogram_records_its_bytes_and_the_cpu_keeps_its_route():
    ids = torch.empty(1000, dtype=torch.int32, device="meta")
    with RA.StepCost() as c:
        out = bucket_histogram(ids, 60)
    assert out.shape == (60,) and out.dtype == torch.int32
    assert c.kernel_calls == {"bucket_histogram": 1}
    assert c.kernel_bytes == 4 * (1000 + 60) and c.kernel_flops == 0
    cpu = torch.zeros(8, 64, 4, 16)
    with RA.StepCost() as c:
        kops.attention(cpu, cpu, cpu)
        bucket_histogram(torch.zeros(10, dtype=torch.int32), 4)
    assert c.kernel_calls == {}  # the plain versions, counted op by op
    assert c.ops > 0


def test_the_mesh_collectives_count_and_their_ops_do_not():
    mesh = NamedMesh({"data": 2, "model": 4})
    x = _meta(4, 8, 16, dtype=torch.float32)
    buf = _meta(4, 4, 8)
    with RA.StepCost() as c:
        view = mesh.view(("model",))
        view.psum(x)
        view.pmax(x)
        view.all_to_all(buf)
        view.ppermute(x, [(0, 1)])
        view.all_gather(x)
    nb = x.numel() * 4
    assert dict(c.coll_bytes) == {"psum": nb, "pmax": nb, "ppermute": nb,
                                  "all_to_all": 4 * 4 * 8 * 2,
                                  "all_gather": 4 * nb}
    assert c.coll_wire_bytes() == 2 * nb + 2 * nb + nb + 4 * 4 * 8 * 2 + 4 * nb
    assert c.bytes == 0 and c.flops == 0
    assert mesh.counts == {"psum": 1, "pmax": 1, "all_to_all": 1,
                           "ppermute": 1, "all_gather": 1}


def test_issued_is_a_no_op_without_a_counter():
    from repro_torch.core import mesh as M

    assert M.issued("psum", 8) is M.issued("all_gather", 16)
    with RA.StepCost() as c:
        with M.issued("psum", 8):
            pass
        with M.issued("psum", 0, count=0):
            pass
    assert dict(c.coll_counts) == {"psum": 1}
    assert dict(c.coll_bytes) == {"psum": 8}


def test_the_moe_decode_psum_is_one_collective_of_every_shards_partial():
    """qwen2-moe TINY's MoE layer at decode (S 1) over 4 virtual shards:
    one psum of the 4 shards' (B, d) partials, not in the mesh's counts."""
    from repro_torch.core.mesh import VirtualMesh
    from repro_torch.models.factory import build_model as torch_build
    from repro_torch.models.moe import moe_fwd

    cfg = get_tiny("qwen2-moe-a2.7b").replace(moe_num_shared=0)
    model = torch_build(cfg, "meta", mesh=NamedMesh({"data": 1, "model": 4}))
    p = {n.split("moe.", 1)[1]: w for n, w in model.lm.named_parameters()
         if n.startswith("layers.0.moe.")}
    x = _meta(8, 1, cfg.d_model)
    mesh = VirtualMesh(4)
    with RA.StepCost() as c:
        moe_fwd(p, x, cfg, mesh)
    assert dict(c.coll_counts) == {"psum": 1}
    assert dict(c.coll_bytes) == {"psum": 4 * 8 * cfg.d_model * 2}
    assert mesh.counts == {}


# --- the dry run's counts ----------------------------------------------------

AFFINE = ("flops", "bytes", "score_bytes", "kernel_flops", "kernel_bytes",
          "coll_bytes", "coll_wire_bytes", "ops")
FAMILY_ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "minicpm3-4b",
                "internvl2-76b", "zamba2-1.2b", "xlstm-1.3b", "whisper-base")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_the_count_is_affine_in_depth(arch):
    """Depths 1 and 2 (units: a layer, or a hybrid's / xLSTM's period)
    predict depth 3 exactly, for a TINY train cell of each family on a
    (2, 4) mesh."""
    # the recurrent families' chunks at 1024 rows: 4 chunks of the cell's
    # 4096 (TINY's 8 would loop 512 times a block in Python)
    cfg = get_tiny(arch).replace(remat="none", ssm_chunk=1024)
    unit = {"hybrid": cfg.attn_every, "ssm": cfg.slstm_every}.get(
        cfg.family, 1)
    mesh = NamedMesh({"data": 2, "model": 4})
    counts = [D.count_step(D.at_depth(cfg, unit * n), "train_4k", mesh,
                           microbatches=2, rows=4) for n in (1, 2, 3)]
    keys = set(AFFINE) | {k for k in counts[0] if k.startswith("coll_")}
    for k in keys:
        a, b, c = (float(x.get(k, 0)) for x in counts)
        assert c == 2 * b - a, (arch, k, a, b, c)
    assert counts[0]["flops"] > 0 and counts[0]["bytes"] > 0


def test_a_tiny_dense_decode_on_a_2x4_mesh_counts_its_collectives():
    """llama3-8b TINY (2 layers, d 64, 4/2 heads of 16, d_ff 128, vocab
    512), decode at batch 8 over a cache of 32768 rows on (data 2, model
    4): the batch over data, the cache's rows over model (4 shards)."""
    cfg = get_tiny("llama3-8b")
    c = D.count_step(cfg, "decode_32k", NamedMesh({"data": 2, "model": 4}),
                     rows=8)
    layers, model = 2, 4
    stat = 4 * 8 * 2 * 2 * 4            # (n, B, KV, G, S=1, 1) fp32
    o = 4 * 8 * 1 * 2 * 2 * 16 * 2      # (n, B, S, KV, G, hd) bf16
    row = model * 8 * 64 * 2            # a row product's (B, d) output
    assert c["coll_count/pmax"] == layers
    assert c["coll_bytes/pmax"] == layers * stat
    assert c["coll_count/psum"] == 2 * layers
    assert c["coll_bytes/psum"] == layers * (stat + o)
    assert c["coll_count/megatron_all_reduce"] == 2 * layers
    assert c["coll_bytes/megatron_all_reduce"] == 2 * layers * row
    assert c["coll_count/embed_all_reduce"] == 1
    assert c["coll_bytes/embed_all_reduce"] == model * 8 * 64 * 2
    assert c["coll_wire_bytes"] == 2 * c["coll_bytes"]


def test_a_tiny_dense_train_step_on_a_2x4_mesh_counts_its_collectives():
    """The same model, a train step of 2 microbatches (remat none): each
    microbatch, each row product's all-reduce forward and backward, the
    head's in the backward (its input's gradient sums over the vocab
    shards) and the lookup's; each microbatch, every leaf's fp32 gradient reduce-scattered
    to its master shard (on data 2 every master is data-sharded: the 2
    layers' stacked dim, embed's and the head's d, final_norm); once, every
    leaf gathered back to its own spec."""
    cfg = get_tiny("llama3-8b").replace(remat="none")
    mesh = NamedMesh({"data": 2, "model": 4})
    c = D.count_step(cfg, "train_4k", mesh, microbatches=2, rows=8)
    mb, devices, leaves = 2, 8, 1 + 2 * 9 + 2
    matrices = 2 * (64 * 64 * 2 + 64 * 32 * 2 + 64 * 128 * 3) + 2 * 512 * 64
    vectors = 2 * 2 * 64 + 64
    assert c["coll_count/megatron_all_reduce"] == mb * (2 * 2 * 2 + 1)
    assert c["coll_bytes/megatron_all_reduce"] == \
        mb * (2 * 2 * 2 + 1) * 4 * (4 * 4096) * 64 * 2
    assert c["coll_count/embed_all_reduce"] == mb
    assert c["coll_count/grad_reduce_scatter"] == leaves * mb
    assert c["coll_bytes/grad_reduce_scatter"] == \
        devices * mb * (matrices * 4 / 8 + vectors * 4 / 2)
    assert c["coll_count/param_all_gather"] == leaves
    assert c["coll_bytes/param_all_gather"] == \
        devices * (matrices * 2 / 4 + vectors * 2)
    assert "coll_count/gather_on_use" not in c
    fsdp = D.count_step(cfg.replace(layout="fsdp"), "train_4k", mesh,
                        microbatches=2, rows=8)
    assert "coll_count/megatron_all_reduce" not in fsdp
    assert fsdp["coll_count/gather_on_use"] > 0


def test_state_bytes_per_device():
    model = build_model(get_config("llama3-8b"), "meta",
                        mesh=NamedMesh(MESH))
    params = dict(model.lm.named_parameters())
    got = RA.state_bytes(model.param_specs(), params, MESH)
    # every matrix and the tables over model 16, the norms whole
    norms = sum(p.numel() for n, p in params.items() if p.ndim == 1)
    assert got == pytest.approx((8_030_261_248 - norms) * 2 / 16 + norms * 2)
    assert math.isclose(RA.leaf_bytes((10,), torch.float32, (None,), MESH), 40)
