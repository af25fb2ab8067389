"""The comparison fails what it must. The control (the plain reference in
the program's place, each value column at the type below its own) comes
out not correct on every cell; so
does a run whose timed path is broken underneath, once for each fault a
cell can have: half the input left out, the exchange between workers
left out, an answer altered where it is produced. (No cell keeps state
from call to call, so "a step that returns its state unchanged" has no
counterpart here.)"""
import importlib

import pytest
import torch

from bench import controls, harness
from bench.tables import make_tables
from bench.tests.helpers import cells, run
from repro_torch.core import context as C
from repro_torch.core import ops_dist

ENTRY = {"join": "join", "groupby": "groupby"}


# rows a worker for the control: 8 x 8192 record ids pass 2**15, which the
# join's control (its payloads at int16) cannot carry
CONTROL_ROWS = 8192


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 2**35 + 13])
@pytest.mark.parametrize("workload", cells())
def test_control_fails_and_program_passes(workload, seed):
    cell = harness.find_cell(workload)
    op = importlib.import_module(f"bench.ops.{cell.traffic['op']}")
    ref = importlib.import_module(f"bench.reference.{cell.traffic['op']}")
    cpu = torch.device("cpu")
    tables = make_tables(cell.config, cell.traffic, seed, cpu, CONTROL_ROWS)
    want = ref.expected(tables, cell.traffic, cell.workers)
    ctx = C.DistContext(num_shards=cell.workers, device=cpu)
    program = controls.program_numbers(cell, op, ref, ctx, tables, want)
    assert all(v <= lim for _, v, lim in program), program
    control = controls.control_numbers(ref, tables, cell.traffic,
                                       cell.workers, want)
    assert any(v > lim for _, v, lim in control), control


def _half(orig):
    """The entry sees only the first half of each worker's rows."""
    def entry(self, *tables, **kw):
        halved = [C.DistTable(t.columns, t.row_counts // 2, t.partitioning,
                              t.stats) if isinstance(t, C.DistTable) else t
                  for t in tables]
        return orig(self, *halved, **kw)
    return entry


def _altered(orig):
    """One value of the result's last column by name (a payload or an
    aggregate) changed by one as the entry returns it."""
    def entry(self, *args, **kw):
        out, stats = orig(self, *args, **kw)
        name = sorted(out.columns)[-1]
        col = out.columns[name].clone()
        col[0, 0] += 1
        return C.DistTable({**out.columns, name: col}, out.row_counts,
                           out.partitioning, out.stats), stats
    return entry


def _entry_name(workload):
    return ENTRY[harness.find_cell(workload).traffic["op"]]


@pytest.mark.parametrize("workload", cells())
def test_half_the_input_left_out(workload, monkeypatch):
    if workload == "join.copartitioned":
        # its calls go through a lazy frame: halve the partitioned inputs
        monkeypatch.setattr(C.DistContext, "partition_by",
                            _half(C.DistContext.partition_by))
    else:
        name = _entry_name(workload)
        monkeypatch.setattr(C.DistContext, name,
                            _half(getattr(C.DistContext, name)))
    result, compared = run(workload)
    assert not result["correct"], compared


@pytest.mark.parametrize("workload", cells())
def test_exchange_left_out(workload, monkeypatch):
    real = ops_dist._shuffle

    def no_exchange(tables, keys, **kw):
        kw["skip"] = True
        return real(tables, keys, **kw)

    monkeypatch.setattr(ops_dist, "_shuffle", no_exchange)
    result, compared = run(workload)
    assert not result["correct"], compared


@pytest.mark.parametrize("workload", cells())
def test_answer_altered(workload, monkeypatch):
    if workload == "join.copartitioned":
        monkeypatch.setattr(C.DistContext, "submit",
                            _submit_altered(C.DistContext.submit))
    else:
        name = _entry_name(workload)
        monkeypatch.setattr(C.DistContext, name,
                            _altered(getattr(C.DistContext, name)))
    result, compared = run(workload)
    assert not result["correct"], compared


def _submit_altered(orig):
    """The lazy frame's route: the result's last column altered
    once the future resolves, for plans with a join."""
    def submit(self, plan, tabs, **kw):
        fut = orig(self, plan, tabs, **kw)
        if type(plan).__name__ != "Join":
            return fut
        inner = fut.result_with_stats

        def altered():
            out, stats = inner()
            return _altered(lambda *a, **k: (out, stats))(None)
        fut.result_with_stats = altered
        return fut
    return submit
