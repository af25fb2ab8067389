"""Every cell's pieces are found by name, and BENCHMARK.json keeps the
contract's shape."""
import importlib
import json

import pytest

from bench import harness
from bench.tests.helpers import cells

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", cells())
def test_cell_finds_its_files(workload):
    cell = harness.find_cell(workload)
    op = cell.traffic["op"]
    for mod in (f"bench.ops.{op}", f"bench.reference.{op}",
                f"bench.loops.{cell.traffic.get('loop', 'closed')}"):
        importlib.import_module(mod)
    assert cell.workers == 8 and cell.chips == 1
    assert set(cell.traffic["inputs"]) <= set(cell.config["tables"])
    readers = harness.readers(cell.end_to_end + cell.per_layer)
    assert all(callable(r.read) for r in readers.values())


def test_every_metric_has_a_reader_and_every_seam_exists():
    from repro_torch.kernels import ops as kops

    readers = harness.readers(BENCH["end_to_end"] + BENCH["per_layer"])
    for name, mod in readers.items():
        seam = getattr(mod, "SEAM", None)
        if seam is not None:
            assert callable(getattr(kops, seam)), name
            assert name.endswith("_roofline")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    names = [w["name"] for w in BENCH["workloads"]]
    assert names == ["join.uniform", "groupby.q5", "join.copartitioned"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "rows_per_s", "peak_gib"} <= e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in names
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"]), c["reduced"]
