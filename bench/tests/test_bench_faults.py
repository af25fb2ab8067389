"""The comparison fails what it must. The control (the plain reference in
the program's place, each value column at the type below its own) comes
out not correct on every cell; so does a run whose timed path is broken
underneath, once for each fault a cell can have: half the input left out,
the exchange between workers left out, an answer altered where it is
produced, a call that returns its state unchanged. Each operator declares
in ``bench/tests/faults/<op>.py`` how a fault is planted in its cells, or
why they cannot have it; such a fault collects no case for them."""
import pytest
import torch

from bench import controls
from bench.tables import make_tables
from bench.tests.helpers import all_cells, find, on_cpu, run
from repro_torch.core import context as C


def cells_with(fault: str) -> list[str]:
    """The cells whose operator can have ``fault``."""
    return [w for w in all_cells()
            if callable(getattr(find(w).piece("tests/faults"), fault))]


def planted_run(workload: str, fault: str, monkeypatch) -> None:
    cell = find(workload)
    plant = getattr(cell.piece("tests/faults"), fault)
    plant(monkeypatch, cell, cell.piece("ops"))
    result, compared = run(workload)
    assert not result["correct"], compared


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 2**35 + 13])
@pytest.mark.parametrize("workload", all_cells())
def test_control_fails_and_program_passes(workload, seed):
    cell = on_cpu(find(workload))
    ref = cell.piece("reference")
    cpu = torch.device("cpu")
    tables = make_tables(cell.config, cell.traffic, seed, cpu,
                         cell.config["control_rows"])
    want = ref.expected(tables, cell.traffic, cell.workers,
                        config=cell.config, seed=seed)
    ctx = C.DistContext(num_shards=cell.workers, device=cpu)
    program = controls.program_numbers(cell, ctx, tables, want, seed)
    assert all(v <= lim for _, v, lim in program), program
    control = controls.control_numbers(cell, tables, want, seed)
    assert any(v > lim for _, v, lim in control), control


@pytest.mark.parametrize("workload", cells_with("half_input"))
def test_half_the_input_left_out(workload, monkeypatch):
    planted_run(workload, "half_input", monkeypatch)


@pytest.mark.parametrize("workload", cells_with("exchange_left_out"))
def test_exchange_left_out(workload, monkeypatch):
    planted_run(workload, "exchange_left_out", monkeypatch)


@pytest.mark.parametrize("workload", cells_with("answer_altered"))
def test_answer_altered(workload, monkeypatch):
    planted_run(workload, "answer_altered", monkeypatch)


@pytest.mark.parametrize("workload", cells_with("state_unchanged"))
def test_state_left_unchanged(workload, monkeypatch):
    planted_run(workload, "state_unchanged", monkeypatch)

