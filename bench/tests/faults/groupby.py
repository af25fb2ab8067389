"""The faults of a groupby cell, in ``DistContext.groupby``."""
from bench.tests.faults import common


def half_input(monkeypatch, cell, op):
    common.entry_halved(monkeypatch, "groupby")


exchange_left_out = common.exchange_left_out


def answer_altered(monkeypatch, cell, op):
    common.entry_altered(monkeypatch, "groupby")


state_unchanged = "a groupby's calls carry no state from one call to the next"
