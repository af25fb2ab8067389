"""The port's dry run (``repro_torch.launch.dryrun``), its hillclimb and
its report on the CPU: the reference's JSON layout and skip reasons from
the command line, a cell that does not fit, the report's three sections,
``measure_cell`` at TINY widths on the CPU, the hillclimb's variants, and
on the card (``cuda``-marked, skipped without one) one measured cell."""
import importlib
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import shapes as RS  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402
from repro_torch.core.mesh import NamedMesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.roofline import report as R  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dry_json(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "dryrun.json"
    D.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--roofline",
            "--out", str(out)])
    D.main(["--arch", "llama3-8b", "--shape", "long_500k", "--merge",
            "--out", str(out)])
    return out


def test_importing_the_dry_run_touches_no_environment():
    before = dict(os.environ)
    importlib.reload(D)
    importlib.reload(H)
    assert dict(os.environ) == before


def test_the_command_line_writes_the_references_layout(dry_json):
    data = json.loads(dry_json.read_text())
    rec = data["llama3-8b"]
    assert rec["long_500k"]["skipped"] == RS.runnable(
        ref_config("llama3-8b"), "long_500k")[1]
    for mesh in ("single", "multi"):
        m = rec["decode_32k"][mesh]
        assert m["ok"] and m["memory"]["fits"]
        assert m["memory"]["state_bytes"]["cache"] > 0
        # the seq-sharded decode: a pmax and two psums a layer
        assert m["memory"]["collective_counts"]["pmax"] == 32
        assert m["memory"]["collective_counts"]["psum"] == 64
    r = rec["decode_32k"]["roofline"]
    assert set(r) >= {"per_device", "terms", "terms_flash", "chips",
                      "model_flops", "useful_ratio", "params", "detail"}
    assert r["chips"] == 256 and r["terms"]["dominant"] == "memory"
    assert r["params"] == {"total": 8_030_261_248, "embed": 1_050_673_152}
    assert r["detail"]["layer"]["count"] == 32
    assert "roofline" not in rec["long_500k"]


def test_the_report_renders_its_three_sections(dry_json, capsys):
    R.main([str(dry_json)])
    text = capsys.readouterr().out
    for head in ("### Dry-run matrix", "### Roofline", "### Dominant-term"):
        assert head in text
    assert "| llama3-8b | decode_32k | single | Y |" in text
    assert "| llama3-8b | long_500k | — | SKIP |" in text
    assert "**llama3-8b × decode_32k** — memory-bound" in text


def test_a_cell_over_the_cards_memory_does_not_fit():
    """llama3-8b trained on one device: 8 B parameters of bf16 and 12 B of
    optimizer state each are 112 GB, over the 80 GB."""
    fit = D.fit_cell(get_config("llama3-8b"), "train_4k",
                     NamedMesh({"data": 1, "model": 1}))
    assert not fit["fits"]
    assert fit["state_bytes"]["total"] == pytest.approx(
        8_030_261_248 * 14, rel=1e-12)


def test_build_cell_is_all_meta():
    model, step, args, _ = D.make_cell(get_config("internvl2-76b"),
                                       "prefill_32k",
                                       NamedMesh({"data": 16, "model": 16}))
    assert all(p.device.type == "meta" for p in model.parameters())
    (batch,) = args
    assert batch["embeds"].shape == (32, 256, 8192)
    logits, cache = step(batch)
    assert logits.shape == (32, 128256) and logits.device.type == "meta"
    assert cache["k"].shape == (80, 32, 32768, 8, 128)


def test_measure_cell_runs_at_tiny_widths_on_the_cpu():
    """Decode at 2 rows over a cache of 32768 rows, 3 layers extrapolated
    from 1 and 2 (a train cell's plain attention at 4096 rows takes ~45 s
    here; the card runs the train cells)."""
    cfg = get_tiny("llama3-8b").replace(num_layers=3)
    r = D.measure_cell(cfg, "decode_32k", "cpu", (1, 2), reps=1, rows=2)
    assert r["device"] == "cpu" and r["rows"] == 2
    assert r["mesh"] == {"data": 1, "model": 16}
    for d in r["per_depth"]:
        assert d["wall_ms"] > 0 and d["device_ms"] is None
        assert d["peak_bytes"] is None and d["bound_ms"] > 0
        assert d["kernel_calls"] == {}  # decode runs no kernel
        assert d["finite"] and d["loss"] is None
        assert d["datasheet_bound_ms"] == pytest.approx(d["bound_ms"])
    f = r["at_full_depth"]
    assert set(f) == {"wall_ms", "flops", "bytes", "bound_ms",
                      "datasheet_bound_ms"}
    assert f["flops"] == 2 * r["per_depth"][1]["flops"] - \
        r["per_depth"][0]["flops"]


def test_a_measured_train_step_reads_its_loss():
    nan = {"loss": torch.tensor(float("nan"))}
    assert D._outcome("train", (None, {"loss": torch.tensor(2.5)})) == \
        (2.5, True)
    loss, finite = D._outcome("train", (None, nan))
    assert math.isnan(loss) and not finite
    assert D._outcome("decode", (torch.full((2, 3), float("inf")), None)) \
        == (None, False)


def test_the_hillclimb_variants_of_the_latent_cache():
    out = H.run("minicpm3_decode", {})
    recs = out["minicpm3-4b"]["decode_32k"]
    base, shard = recs["baseline_latent_cache"], recs["latent_seqshard"]
    # the seq-sharded latents: 1/16 of the cache a device, merged by
    # a pmax and two psums a layer
    assert shard["memory"]["state_bytes"]["cache"] == pytest.approx(
        base["memory"]["state_bytes"]["cache"] / 16)
    assert shard["collective_counts"]["psum"] == 2 * 62
    assert "psum" not in base["collective_counts"]


@pytest.mark.cuda
def test_cuda_measure_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = D.measure_cell(get_tiny("llama3-8b"), "decode_32k", "cuda", (1, 2),
                       reps=1, rows=2)
    assert all(d["device_ms"] is not None and d["peak_bytes"] > 0
               for d in r["per_depth"])


def test_the_backward_is_checked_at_every_measured_train_cells_shape():
    """chip_smoke.py's phase 26 trains llama3-8b and qwen2-moe-a2.7b at
    S 4096; phase 2 holds flash_attention_bwd against autograd at each
    cell's microbatch shape and plants the lse fault there."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = smoke.flash_train_cases()
    data = D.make_production_mesh().shape["data"]
    for arch, shape, mb, _ in smoke.CELL_RUNS:
        cell = D.SHAPES[shape]
        if cell.kind != "train":
            continue
        cfg = get_config(arch)
        rows = cell.global_batch // data
        mb = mb or min(D.train_microbatches(arch), rows)
        want = (rows // mb, cell.seq_len, cfg.num_heads, cfg.num_kv_heads,
                cfg.hd, True, torch.bfloat16, cfg.hd)
        assert want in smoke.FLASH_TRAIN_CELLS and want in cases, (arch, want)
