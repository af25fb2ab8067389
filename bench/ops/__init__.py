"""Operator drivers, one module per traffic ``op``: how a call is prepared
and made through the program's entry, and what of its result is kept for
the comparison."""
