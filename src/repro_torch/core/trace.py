"""Spans and counters inside the program, on the profiler's clock.

A span is a ``torch.profiler.record_function`` range the program opens at
one of its layer boundaries (``repro_torch.submit``, ``.plan``,
``.execute``, ``.op.<node>``, ``.exchange`` and its steps,
``.join.local``, ``.groupby.partial`` / ``.final``, ``.result``). It lives
on the profiler's own timeline, beside every kernel: a host start and end,
a device-side range over the operations launched while it was the
innermost span open, and the enclosing range as its parent. Each span
covers one step over all shards, never one shard, so a call opens a few
dozen at most.

Spans are opened only inside :func:`spanning` while the profiler runs;
anywhere else :func:`span` returns one shared null context (one context
variable's read: the idiom of ``core/mesh.issued``). Readers of
``prof.events()`` that never open :func:`spanning` (``chip_smoke.py``,
``launch/dryrun.py``, the benchmark's harness) therefore see no span. A
reader that opens it keeps the ``repro_torch.`` ranges' device-side ranges
out of its device operations itself: they are not operations, and they
cover idle time.

A counter is a number the program already computed: a tensor (on the
device, never read there) or a Python int, appended under a name inside
:func:`counting` and summed on the host by :meth:`Counts.resolve` once the
caller has synchronised. No device operation is launched and no host sync
is made to count; outside a ``counting`` scope nothing is kept.

Both switches are context variables: a scope holds in the thread (or
task) that opened it, so a client thread counts only its own queries
while other threads submit theirs.

Counters: ``exchange.rows_received`` (each exchange's ``(p,)`` received
rows), ``exchange.slots`` (its ``p * p * bucket_capacity`` send slots),
``join.rows_out`` (each local join's result rows), ``join.slots`` (its
``out_capacity``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_spanning = contextvars.ContextVar("repro_torch_spanning", default=False)
_counts: "contextvars.ContextVar[Counts | None]" = contextvars.ContextVar(
    "repro_torch_counts", default=None)


def span(name: str):
    """A profiler range ``name`` inside :func:`spanning` while the profiler
    runs; else the shared null context."""
    if not _spanning.get() or not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spanning(on: bool = True):
    """Open the program's spans (``on``) or keep them shut for the block."""
    token = _spanning.set(on)
    try:
        yield
    finally:
        _spanning.reset(token)


class Counts:
    """The counters of one :func:`counting` scope."""

    def __init__(self):
        self._items: list[tuple[str, object]] = []

    def add(self, name: str, value) -> None:
        self._items.append((name, value))

    def resolve(self) -> dict[str, int]:
        """Each counter's sum, read on the host (call after a sync)."""
        out: dict[str, int] = {}
        for name, v in self._items:
            if isinstance(v, torch.Tensor):
                v = int(v.sum())
            out[name] = out.get(name, 0) + int(v)
        return out


@contextlib.contextmanager
def counting():
    """Keep the program's counters for the block: ``with counting() as c``,
    then ``c.resolve()`` after the block's work has synchronised."""
    c = Counts()
    token = _counts.set(c)
    try:
        yield c
    finally:
        _counts.reset(token)


def count(name: str, value) -> None:
    """Append ``value`` (a tensor the program computed, or an int) to the
    counter ``name`` of the open :func:`counting` scope, if any."""
    c = _counts.get()
    if c is not None:
        c.add(name, value)
