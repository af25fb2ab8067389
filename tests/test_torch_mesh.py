"""The port's mesh (``repro_torch.launch.mesh``, ``core.mesh.NamedMesh``) and
its rules on the CPU: the reference's mesh shapes and axis names, the
collectives ``psum``/``pmax`` of ``VirtualMesh``, ``models.common.
decode_layout`` against the reference's ``ShardingRules.decode_layout``
over every small mesh, the MoE's expert padding for a model axis, and the
launchers' mesh flags (including the ones the rules cannot serve, which
raise)."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.models.common import ShardingRules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.mesh import NamedMesh, VirtualMesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.common import decode_layout  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_local_mesh_shapes_as_the_reference():
    m = tmesh.make_local_mesh(8, model=2)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 4,
                                                             "model": 2}
    m = tmesh.make_local_mesh(8, model=2, pod=2)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert tmesh.make_local_mesh(1).shape == {"data": 1, "model": 1}
    assert m.axis_size("pod") == 2 and m.axis_size("no-such") == 1
    # the reference asserts data * model * pod == devices
    for devices, model, pod in ((8, 3, 1), (6, 4, 1), (8, 2, 3), (2, 4, 1)):
        with pytest.raises(ValueError, match="split"):
            tmesh.make_local_mesh(devices, model=model, pod=pod)


def test_production_mesh_shapes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.view(multi.axis_names).axis_size == 512


def test_views_count_into_the_mesh():
    m = tmesh.make_local_mesh(8, model=4)
    v = m.view(("model",))
    assert isinstance(v, VirtualMesh) and v.axis_size == 4
    assert m.view(("data", "model")).axis_size == 8
    v.psum(torch.ones(4, 3))
    m.view(("data", "model")).pmax(torch.ones(8, 2))
    assert dict(m.counts) == {"psum": 1, "pmax": 1}
    m.reset_counts()
    assert not m.counts
    for bad in ((), ("pod",), ("model", "nope")):
        with pytest.raises(ValueError):
            m.view(bad)
    with pytest.raises(ValueError):
        NamedMesh({"data": 0})


def test_psum_adds_in_shard_order_and_pmax_is_the_max():
    """bf16 values whose sum depends on the order: shard order, one add at
    a time in bf16, as the MoE psum path summed before."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((8, 64), generator=g) * torch.logspace(
        -3, 3, 8)[:, None]).to(torch.bfloat16)
    mesh = VirtualMesh(8)
    want = x[0]
    for i in range(1, 8):
        want = want + x[i]
    got = mesh.psum(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got, x.flip(0).sum(0))  # the order matters here
    assert torch.equal(mesh.pmax(x), x.max(0).values)
    assert dict(mesh.counts) == {"psum": 1, "pmax": 1}
    with pytest.raises(ValueError, match="leading shard axis"):
        mesh.psum(torch.ones(4, 2))


MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 4},
          {"data": 4, "model": 2}, {"data": 8, "model": 1},
          {"data": 1, "model": 8}, {"pod": 2, "data": 2, "model": 2},
          {"pod": 2, "data": 1, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_decode_layout_is_the_references(shape):
    def norm(axes):
        return None if axes is None else tuple(axes)

    for batch, seq_shard in itertools.product((1, 2, 3, 4, 8, 16, 32, 48),
                                              (True, False)):
        want = ShardingRules(shape, False).decode_layout(batch, seq_shard)
        got = decode_layout(shape, batch, seq_shard)
        assert tuple(map(norm, got)) == tuple(map(norm, want)), (batch,
                                                                 seq_shard)


def test_moe_experts_are_padded_for_the_model_axis():
    """qwen2-moe's TINY experts pad to a multiple of the model axis when
    the weights are drawn, as the reference's init pads them; weights
    drawn for another axis raise in the forward."""
    cfg = tconfigs.get_tiny("qwen2-moe-a2.7b")
    assert cfg.moe_num_experts == 8
    model = build_model(cfg, "cpu", mesh=tmesh.make_local_mesh(6, model=3))
    assert model.lm.layers[0].moe["wi"].shape[0] == 9
    with torch.no_grad():
        model.forward(tokens=torch.ones((1, 6), dtype=torch.int32))
        model.mesh = None
        with pytest.raises(ValueError, match="padded"):
            model.forward(tokens=torch.ones((1, 6), dtype=torch.int32))


def test_serve_cli_over_a_mesh_equals_the_plain_serve():
    """``--devices 8 --model-axis 8``: the prefill is the one-device
    prefill; each decode step reads the 8-way split cache, within bf16
    rounding of the one-device decode."""
    plain = tserve.main(["--arch", "llama3-8b", "--tiny", "--device", "cpu",
                         "--gen", "8"])
    shard = tserve.main(["--arch", "llama3-8b", "--tiny", "--device", "cpu",
                         "--gen", "8", "--devices", "8", "--model-axis", "8"])
    assert torch.equal(plain.logits[0], shard.logits[0])
    err = max(float((a - b).abs().max())
              for a, b in zip(plain.logits[1:], shard.logits[1:]))
    assert err < 0.05, err
    with pytest.raises(ValueError, match="split"):
        tserve.main(["--arch", "llama3-8b", "--tiny", "--device", "cpu",
                     "--devices", "6", "--model-axis", "4"])
    with pytest.raises(ValueError, match="--devices"):
        tserve.main(["--arch", "llama3-8b", "--tiny", "--device", "cpu",
                     "--model-axis", "2"])


def test_serve_cli_raises_where_the_cache_does_not_split():
    """A cache of prompt + gen rows that the model axis does not divide is
    refused, not decoded unsharded."""
    with pytest.raises(ValueError, match="does not split"):
        tserve.main(["--arch", "llama3-8b", "--tiny", "--device", "cpu",
                     "--prompt-len", "9", "--gen", "4", "--devices", "8",
                     "--model-axis", "8"])


def test_train_cli_prints_the_mesh(capsys):
    tlaunch.main(["--arch", "granite-3-2b", "--tiny", "--device", "cpu",
                  "--steps", "1", "--batch", "8", "--seq", "16", "--devices",
                  "8", "--model-axis", "2", "--pod-axis", "2",
                  "--compress-pod"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: {'pod': 2, 'data': 2, 'model': 2}"
    assert out[-1].startswith("final loss: ")
    assert np.isfinite(float(out[-1].split()[-1]))
