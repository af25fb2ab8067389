"""The reference's sharding rules as the port's shape rules, against
``repro``'s specs for every arch on the production meshes, (16, 16) and (2,
16, 16), in the tp and the fsdp layout: every parameter's spec (the
reference's stacked leaf mapped through ``models/convert``'s names, each
layer's leaf taking the layer spec), the ZeRO master specs and the whole
train state's (``compress_pod``'s residuals included), the batch specs,
the decode caches' specs (decode_32k and, where runnable, long_500k), and
the per-device bytes of each, against an oracle computed from the
reference's ``eval_shape`` and specs. The reference builds its specs with
a mesh stand-in that has only a ``shape`` (no devices)."""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import shapes as RS  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.train import steps as RST  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.core.mesh import NamedMesh  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.train import steps as TST  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
LAYOUTS = ("tp", "fsdp")
STACKED = ("layers", "mamba", "mlstm", "slstm", "enc_layers", "dec_layers")
CASES = [(a, m, lay) for a in ARCH_IDS for m in MESHES for lay in LAYOUTS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _paths(tree):
    """[(path tuple, leaf)] of a reference tree, PartitionSpecs as leaves."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_p)[0]
    return [(tuple(getattr(k, "key", getattr(k, "name", None)) for k in path),
             leaf) for path, leaf in flat]


def _name_map(ref_shapes, cfg):
    """{port name: (reference path, stacked)}: a tag tree (each stacked
    leaf an arange over its layers plus 1000 x its index, the others 1000 x
    their index) through ``params_from_jax`` in float64."""
    leaves = _paths(ref_shapes)
    tagged = {}
    for i, (path, leaf) in enumerate(leaves):
        node = tagged
        for k in path[:-1]:
            node = node.setdefault(k, {})
        base = 1000.0 * (i + 1)
        node[path[-1]] = (base + np.arange(leaf.shape[0], dtype=np.float64)
                          if path[0] in STACKED else np.float64(base))
    sd = params_from_jax(tagged, cfg.replace(param_dtype=torch.float64))
    out = {}
    for name, t in sd.items():
        v = int(t.item())
        out[name] = (leaves[v // 1000 - 1][0], leaves[v // 1000 - 1][0][0]
                     in STACKED)
    return out


def _layer(spec, stacked):
    """The reference's spec of a stacked leaf as its layer leaf's."""
    s = tuple(spec)
    if not stacked:
        return s
    return s[1:] if s[0] is None else C.LayerSplit(s[1:], s[0])


def _oracle_bytes(specs, shapes, mesh_shape):
    """Per-device bytes from the reference's own specs and eval_shape."""
    total = 0.0
    sp = dict(_paths(specs))
    for path, sds in _paths(shapes):
        div = math.prod(mesh_shape.get(a, 1) for e in tuple(sp[path])
                        for a in C.spec_axes(e))
        total += math.prod(sds.shape) * np.dtype(sds.dtype).itemsize / div
    return total


_REF = {}  # the reference's (cfg, model, param shapes): shapes, no arrays


def _reference(arch, mesh, layout):
    key = (arch, mesh, layout)
    if key not in _REF:
        cfg = ref_config(arch).replace(layout=layout)
        model = ref_build(cfg, SimpleNamespace(shape=MESHES[mesh]))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        _REF[key] = (cfg, model, shapes)
    return _REF[key]


@pytest.mark.parametrize("arch,mesh,layout", CASES)
def test_parameter_and_train_state_specs_are_the_references(arch, mesh,
                                                            layout):
    rcfg, rmodel, shapes = _reference(arch, mesh, layout)
    cfg = get_config(arch).replace(layout=layout)
    model = build_model(cfg, "meta", mesh=NamedMesh(MESHES[mesh]))
    names = _name_map(shapes, cfg)
    params = dict(model.lm.named_parameters())
    assert set(names) == set(params) == set(model.param_specs())
    ref_specs = dict(_paths(rmodel.param_specs))
    ref_shapes = dict(_paths(shapes))
    for name, (path, stacked) in names.items():
        want_shape = ref_shapes[path].shape[1 if stacked else 0:]
        assert tuple(params[name].shape) == tuple(want_shape), name
        assert model.param_specs()[name] == _layer(ref_specs[path], stacked), \
            name
    # the train state: masters (ZeRO), moments, count, step, residuals
    multi = "pod" in MESHES[mesh]
    rts = RST.train_state_specs(rmodel, compress_pod=multi)
    ts = TST.train_state_specs(model, compress_pod=multi)
    ref_master = dict(_paths(rts.opt.master))
    for name, (path, stacked) in names.items():
        want = _layer(ref_master[path], stacked)
        assert ts.opt.master[name] == want, (name, ts.opt.master[name], want)
        assert ts.opt.m[name] == want and ts.opt.v[name] == want
        assert ts.params[name] == _layer(ref_specs[path], stacked)
    assert tuple(rts.opt.count) == ts.opt.count == ()
    assert tuple(rts.step) == ts.step == ()
    if multi:
        ref_ef = dict(_paths(rts.ef))
        for name, (path, stacked) in names.items():
            s = tuple(ref_ef[path])
            if stacked:
                want = (s[:1] + s[2:]) if s[1] is None else C.LayerSplit(
                    s[:1] + s[2:], s[1])
            else:
                want = s
            assert ts.ef[name] == want, name
    else:
        assert rts.ef is None and ts.ef is None
    # per-device bytes: parameters and the fp32 masters
    shape = MESHES[mesh]
    assert RA.state_bytes(model.param_specs(), params, shape) == \
        pytest.approx(_oracle_bytes(rmodel.param_specs, shapes, shape),
                      rel=1e-12)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32),
                       shapes)
    tf32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
            for n, p in params.items()}
    assert RA.state_bytes(ts.opt.master, tf32, shape) == pytest.approx(
        _oracle_bytes(rts.opt.master, f32, shape), rel=1e-12)
    # the batch
    for cell in ("train_4k", "prefill_32k"):
        want = RST.batch_specs(rmodel, RS.input_specs(rcfg, cell))
        got = TST.batch_specs(model, TS.input_specs(cfg, cell))
        assert got == {k: tuple(v) for k, v in want.items()}


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch,mesh,layout", CASES)
def test_cache_specs_and_bytes_are_the_references(arch, mesh, layout):
    rcfg, rmodel, _ = _reference(arch, mesh, layout)
    cfg = get_config(arch).replace(layout=layout)
    model = build_model(cfg, "meta", mesh=NamedMesh(MESHES[mesh]))
    for cell in ("decode_32k", "long_500k"):
        if not TS.runnable(cfg, cell)[0]:
            continue
        b, s = TS.cache_shape(cfg, cell)
        want = rmodel.cache_specs(b)
        got = model.cache_specs(b)
        assert got == _as_tuples(want), (arch, cell)
        enc = s if cfg.family == "audio" else 0
        cache = model.init_cache(b, s, enc)
        rshapes = jax.eval_shape(lambda: rmodel.init_cache(b, s, enc))
        assert RA.state_bytes(got, cache, MESHES[mesh]) == pytest.approx(
            _oracle_bytes(want, rshapes, MESHES[mesh]), rel=1e-12)


def test_spec_normalises_as_partition_spec():
    P = jax.sharding.PartitionSpec
    for parts in ((("data",), None), (("pod", "data"), "model"), ((), None),
                  (None,), ()):
        assert C.spec(*parts) == tuple(P(*parts))


def test_layer_split_equals_only_its_own_axis():
    a = C.LayerSplit((None, "model"), "data")
    assert a == C.LayerSplit((None, "model"), "data")
    assert a != (None, "model") and a != C.LayerSplit((None, "model"), "pod")
    # a device holds 1 / 16 of a (32 x 4096 x 4096) group's bf16 bytes
    assert RA.leaf_bytes((4096, 4096), torch.bfloat16, a,
                         {"data": 16, "model": 16}) == 4096 * 4096 * 2 / 256


def test_meta_model_draws_nothing():
    """dbrx-132b's 131.6 B parameters on meta: no storage, the reference's
    count."""
    model = build_model(get_config("dbrx-132b"), "meta",
                        mesh=NamedMesh(MESHES["single"]))
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 131_596_523_520
    with pytest.raises(ValueError, match="no weight"):
        build_model(get_config("llama3-8b"), "meta",
                    generator=torch.Generator().manual_seed(0))
