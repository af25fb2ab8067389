"""Faults the relational operators share, planted in the program's
``DistContext`` entries and in its exchange."""
from __future__ import annotations

from repro_torch.core import context as C
from repro_torch.core import ops_dist


def halved(orig):
    """The entry sees only the first half of each worker's rows."""
    def entry(self, *tables, **kw):
        cut = [C.DistTable(t.columns, t.row_counts // 2, t.partitioning,
                           t.stats) if isinstance(t, C.DistTable) else t
               for t in tables]
        return orig(self, *cut, **kw)
    return entry


def altered(orig):
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


def submit_altered(orig):
    """The lazy frame's route: the result's last column altered once the
    future resolves, for plans with a join."""
    def submit(self, plan, tabs, **kw):
        fut = orig(self, plan, tabs, **kw)
        if type(plan).__name__ != "Join":
            return fut
        inner = fut.result_with_stats

        def result():
            out, stats = inner()
            return altered(lambda *a, **k: (out, stats))(None)
        fut.result_with_stats = result
        return fut
    return submit


def entry_halved(monkeypatch, name: str) -> None:
    monkeypatch.setattr(C.DistContext, name, halved(getattr(C.DistContext, name)))


def entry_altered(monkeypatch, name: str) -> None:
    monkeypatch.setattr(C.DistContext, name, altered(getattr(C.DistContext, name)))


def exchange_left_out(monkeypatch, cell, op) -> None:
    """Every shuffle skipped: each worker keeps the rows it had."""
    real = ops_dist._shuffle

    def no_exchange(tables, keys, **kw):
        kw["skip"] = True
        return real(tables, keys, **kw)

    monkeypatch.setattr(ops_dist, "_shuffle", no_exchange)
