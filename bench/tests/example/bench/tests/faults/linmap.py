"""The faults of a ``linmap`` cell, planted in its operator module, which
stands in for the program."""


def half_input(monkeypatch, cell, op):
    def rows(state):
        return state["x"][:state["x"].shape[0] // 2]

    monkeypatch.setattr(op, "rows", rows)


exchange_left_out = "one worker: the operator exchanges nothing"


def answer_altered(monkeypatch, cell, op):
    real = op.call

    def call(ctx, state, traffic):
        y, report = real(ctx, state, traffic)
        y[0, 0] += 1
        return y, report

    monkeypatch.setattr(op, "call", call)


def state_unchanged(monkeypatch, cell, op):
    monkeypatch.setattr(op, "advance", lambda state: None)
