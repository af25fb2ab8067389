"""The port's input shapes (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``, for every arch x shape: runnability
and its reason, ``input_specs``' names, shapes and dtypes (meta tensors
there, ``ShapeDtypeStruct``s here), and ``cache_shape``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import shapes as RS  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32}


def test_the_shape_table_is_the_references():
    assert list(TS.SHAPES) == list(RS.SHAPES)
    for name, cell in RS.SHAPES.items():
        t = TS.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == (
            cell.name, cell.seq_len, cell.global_batch, cell.kind)
    assert TS.SUBQUADRATIC_FAMILIES == RS.SUBQUADRATIC_FAMILIES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_runnable_inputs_and_cache_shape_as_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert TS.runnable_cells(cfg) == RS.runnable_cells(rcfg)
    for name in RS.SHAPES:
        assert TS.runnable(cfg, name) == RS.runnable(rcfg, name)
        want = RS.input_specs(rcfg, name)
        got = TS.input_specs(cfg, name)
        assert set(got) == set(want)
        for key, sds in want.items():
            t = got[key]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(sds.shape), (arch, name, key)
            assert t.dtype == DTYPES[jnp.dtype(sds.dtype)], (arch, name, key)
        assert TS.cache_shape(cfg, name) == RS.cache_shape(rcfg, name)


def test_input_specs_allocate_nothing():
    """The VLM's front rows and the encoder-decoder's frames, at full size,
    as meta tensors: 256 x 32768 x 8192 floats would be 275 GB."""
    vlm = TS.input_specs(get_config("internvl2-76b"), "prefill_32k")
    assert vlm["embeds"].shape == (32, 256, 8192)
    assert vlm["tokens"].shape == (32, 32768 - 256)
    audio = TS.input_specs(get_config("whisper-base"), "train_4k")
    assert audio["embeds"].shape == (256, 4096, 512)
    assert all(t.device.type == "meta" for t in (*vlm.values(),
                                                  *audio.values()))
