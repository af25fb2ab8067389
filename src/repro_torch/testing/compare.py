"""Exact result comparison for relational outputs (tests + benches).

Row order is not part of any operator's contract across execution
strategies (fused vs eager, shuffle vs two-phase), so equality is defined
on the SORTED row multiset over all columns: robust to duplicate keys,
exact on every dtype (a float bit-difference fails the check).
"""
from __future__ import annotations


def table_rows(t):
    """(sorted column names, row tuples sorted lexicographically)."""
    d = t.to_table().to_numpy() if hasattr(t, "to_table") else t.to_numpy()
    names = sorted(d)
    rows = sorted(zip(*(d[n].tolist() for n in names))) if names else []
    return names, rows


def tables_bitwise_equal(a, b) -> bool:
    """True iff both results hold the same columns and the identical row
    multiset, compared bit-exactly. Accepts DistTable or Table."""
    na, ra = table_rows(a)
    nb, rb = table_rows(b)
    return na == nb and ra == rb
