"""The faults the harness's tests plant in a cell's timed path, declared per
operator: ``bench/tests/faults/<op>.py`` holds, under each name of
``FAULTS``, either ``plant(monkeypatch, cell, op)``, which breaks the
program underneath the cell's calls (``op`` is the cell's operator module
as the harness loaded it), or a one-line reason why the operator's cells
cannot have that fault. The tests run a planted fault in every cell of
the operator and collect no case for one declared absent."""

FAULTS = (
    "half_input",         # half of the input left out
    "exchange_left_out",  # the exchange between workers left out
    "answer_altered",     # an answer altered where it is produced
    "state_unchanged",    # a call that returns its state unchanged
)
