"""A run of each cell on the CPU at a few hundred rows a worker: the
program agrees with the plain reference, the result's line has the
contract's shape, and nothing of JAX or the JAX package is loaded."""
import json
import sys
import types

import pytest
import torch

from bench import harness, run as bench_run
from bench.tests.helpers import all_cells, find, on_cpu, run


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("workload", all_cells())
def test_program_matches_reference(workload, trace):
    result, compared = run(workload, trace=trace)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert [n for n, _, _ in compared][0] == "failed_calls"
    cell = find(workload)
    want = cell.per_layer if trace else cell.end_to_end
    # a reader of what only a card gives (a device trace, the sync counter,
    # device memory) says so and gives nothing here; every other metric of
    # the cell is there
    silent = {name for name, r in harness.readers(want, cell.root).items()
              if getattr(r, "CPU_SILENT", False)}
    assert {m["name"] for m in want} - silent == set(result["metrics"])
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0


def test_copartitioned_calls_elide_both_shuffles():
    result, compared = run("join.copartitioned")
    assert ("calls_with_a_shuffle", 0.0, 0.0) in compared


def test_result_line_shape(monkeypatch, capsys):
    """``main`` on a card that the test pretends to have: the last line of
    standard output is the result, ``compared`` its last key, and the last
    lines of standard error the compared numbers beside their limits."""
    real = harness.run_cell

    def cpu_run(cell, **kw):
        kw["device"] = torch.device("cpu")
        return real(on_cpu(cell), **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    monkeypatch.setattr(harness, "run_cell", cpu_run)
    rc = bench_run.main(["--workload", "groupby.q5", "--seed",
                         str(2**33 + 5), "--seconds", "0.2", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == "a card" and line["device"]["count"] == 1
    assert out.strip().splitlines()[0].startswith("device: a card x 1")
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "join.uniform", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and "{" not in out and "CUDA" in err


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.banned_modules() == []
    for name in ("repro_torch_extra", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == []
    for name in ("repro.core.table", "jax", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == ["flax", "jax", "jaxlib.xla_client",
                                        "repro.core.table"]


def test_same_seed_same_tables_and_wide_seeds():
    from bench.tables import make_tables

    cell = harness.find_cell("join.uniform")
    cpu = torch.device("cpu")
    a = make_tables(cell.config, cell.traffic, 2**40 + 3, cpu, 64)
    b = make_tables(cell.config, cell.traffic, 2**40 + 3, cpu, 64)
    c = make_tables(cell.config, cell.traffic, 2**40 + 4, cpu, 64)
    for t in a:
        for col in a[t]:
            assert torch.equal(a[t][col], b[t][col])
    assert not torch.equal(a["r"]["k"], c["r"]["k"])
    # r's and s's keys: each 1..N once, in two different orders; the
    # payloads are the record ids
    n = 8 * 64
    for t in ("r", "s"):
        assert torch.equal(a[t]["k"].reshape(-1).sort().values,
                           torch.arange(1, n + 1, dtype=torch.int32))
        assert torch.equal(a[t]["rid"].reshape(-1),
                           torch.arange(n, dtype=torch.int32))
    assert not torch.equal(a["r"]["k"], a["s"]["k"])


def test_groupby_table_follows_its_source():
    from bench.tables import make_tables

    cell = harness.find_cell("groupby.q5")
    x = make_tables(cell.config, cell.traffic, 2**36 + 1, torch.device("cpu"),
                    1000)["x"]
    n = 8 * 1000
    assert set(x) == {"id1", "id2", "id3", "id4", "id5", "id6",
                      "v1", "v2", "v3"}
    for col, hi in (("id1", 100), ("id4", 100), ("id3", n // 100),
                    ("id6", n // 100), ("v1", 5), ("v2", 15)):
        assert x[col].dtype == torch.int32
        assert int(x[col].min()) == 1 and int(x[col].max()) == hi, col
    v3 = x["v3"]
    assert v3.dtype == torch.float64 and 0 <= float(v3.min()) < float(v3.max()) < 100
    assert torch.equal(torch.round(v3 * 1e6) / 1e6, v3)


@pytest.mark.parametrize("dist", ["permutation", "uniform_int", "row_index"])
def test_int64_columns_follow_the_seed_past_2_31(dist):
    from bench.reference.common import LOWER
    from bench.tables import make_tables

    low = 2**33 + 5
    spec = {"dtype": "int64", "distribution": dist, "low": low, "levels": 1000}
    config = {"workers": 4, "rows_per_worker": 64, "tables": {"t": {"k": spec}}}
    cpu = torch.device("cpu")
    a, b, c = (make_tables(config, {"inputs": ["t"]}, s, cpu)["t"]["k"]
               for s in (2**40 + 3, 2**40 + 3, 2**40 + 4))
    assert a.dtype == torch.int64 and a.shape == (4, 64)
    assert torch.equal(a, b) and int(a.min()) >= low > 2**31
    if dist == "row_index":
        assert torch.equal(a.reshape(-1), torch.arange(low, low + 256))
    else:
        assert not torch.equal(a, c)
    if dist == "permutation":
        assert torch.equal(a.reshape(-1).sort().values, torch.arange(low, low + 256))
    if dist == "uniform_int":
        assert int(a.max()) < low + 1000
    assert LOWER[torch.int64] == torch.int32
