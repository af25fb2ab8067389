"""Every cell's pieces are found by name under its root, BENCHMARK.json
keeps the contract's shape, and a cell joins through new files and entries
alone."""
import json
import re

import pytest

from bench import harness
from bench.tests.faults import FAULTS
from bench.tests.helpers import EXAMPLE, all_cells, example_root, find

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
# the cells of the accepted benchmark, which stay first and in this order
ACCEPTED = ["join.uniform", "groupby.q5", "join.copartitioned"]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_contract(bench: dict, root) -> None:
    """The contract's rules on ``bench`` as read from ``root``."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    names = [w["name"] for w in bench["workloads"]]
    assert names[:len(ACCEPTED)] == ACCEPTED
    assert len(set(names)) == len(names) <= 24
    assert all(NAME.fullmatch(n) for n in names), names
    chips = [w["chips"] for w in bench["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)
    for w in bench["workloads"]:
        workers = harness.find_cell(w["name"], root).config.get("workers", 1)
        assert isinstance(workers, int) and workers > 0, w["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "rows_per_s", "peak_gib"} <= e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in names
    for c in bench["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert c["file"].startswith("bench/") and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"]), c["reduced"]


@pytest.mark.parametrize("workload", all_cells())
def test_cell_finds_its_files(workload):
    cell = find(workload)
    for kind in ("ops", "reference", "loops", "tests/faults"):
        cell.piece(kind)
    assert cell.workers >= 1 and cell.chips in (1, 4)
    assert set(cell.traffic["inputs"]) <= set(cell.config["tables"])
    readers = harness.readers(cell.end_to_end + cell.per_layer, cell.root)
    assert all(callable(r.read) for r in readers.values())


@pytest.mark.parametrize("workload", all_cells())
def test_operator_declares_every_fault(workload):
    """Each fault is planted or declared absent with a one-line reason."""
    faults = find(workload).piece("tests/faults")
    for fault in FAULTS:
        how = getattr(faults, fault)
        assert callable(how) or (isinstance(how, str) and how
                                 and "\n" not in how), fault


def test_every_metric_has_a_reader_and_every_seam_exists():
    from repro_torch.kernels import ops as kops

    readers = harness.readers(BENCH["end_to_end"] + BENCH["per_layer"])
    for name, mod in readers.items():
        seam = getattr(mod, "SEAM", None)
        if seam is not None:
            assert callable(getattr(kops, seam)), name
            assert name.endswith("_roofline")


def test_benchmark_json_shape():
    check_contract(BENCH, harness.ROOT)


def test_a_cell_joins_through_new_files_and_entries_alone():
    """The example's root (this checkout's ``bench/`` with the example's
    files added, none replaced) holds to the contract with its cells."""
    root = example_root()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    check_contract(bench, root)
    entries = json.loads((EXAMPLE / "entries.json").read_text())
    assert bench["workloads"][len(BENCH["workloads"]):] == entries["workloads"]
