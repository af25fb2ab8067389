"""The faults of a join cell, in ``DistContext.join``. A cell whose traffic
partitions its inputs in set-up (``prepartition``) joins through a lazy
frame, so its faults go where that route passes: the partitioned inputs
halved, the frame's result altered."""
from bench.tests.faults import common
from repro_torch.core import context as C


def half_input(monkeypatch, cell, op):
    prepartitioned = cell.traffic.get("prepartition")
    common.entry_halved(monkeypatch, "partition_by" if prepartitioned else "join")


exchange_left_out = common.exchange_left_out


def answer_altered(monkeypatch, cell, op):
    if cell.traffic.get("prepartition"):
        monkeypatch.setattr(C.DistContext, "submit",
                            common.submit_altered(C.DistContext.submit))
    else:
        common.entry_altered(monkeypatch, "join")


state_unchanged = "a join's calls carry no state from one call to the next"
