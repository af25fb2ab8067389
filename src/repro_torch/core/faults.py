"""Deterministic fault injection and the layered recovery policy (the port
of ``repro.core.faults``).

A seeded registry of **named fault sites** threaded through the execution
stack, and the :class:`RetryPolicy` and degradation-ladder machinery
``DistContext`` uses to recover from them.

Fault sites (each checked by the code that owns it):

==================  =====================================================
``shuffle.chunk``   ``repartition.py``: raise during a staged/ring
                    exchange, or garble a received chunk (NaN-pattern
                    poison; a dropped chunk surfaces the same way, as
                    corrupt counts/data). Ladder: monolithic AllToAll.
``kernel.dispatch`` ``kernels/ops.py``: raise at kernel dispatch, or
                    NaN-poison the kernel output. Ladder: the kernels'
                    plain versions (``oracle_scope``).
``stats.estimate``  ``stats.py``: forced under-estimate of a sized
                    capacity. Ladder: the overflow safe-capacity retry.
``cache.admission`` ``plan_cache.py``: spurious miss/evict. No ladder
                    needed: the natural re-preparation is the recovery.
``compile``         ``context.py``: a cache-hit plan raises as if
                    corrupt. Ladder: invalidate + fresh preparation.
==================  =====================================================

Everything is deterministic: a fault fires on the ``nth`` eligible call
of its site, or by a seeded per-call hash when ``probability`` is set,
never ``random``/wall-clock, so a chaos run replays bit-identically.
Faults are scoped per ``DistContext`` (armed via ``FaultPlan``s or the
``REPRO_FAULTS`` env spec) and consulted through a thread-local
:func:`scope`; with no scope armed every check is a dict-free no-op.

``REPRO_FAULTS`` spec grammar (``;``-separated sites)::

    site:key=val,key=val[;site2:...]
    e.g.  REPRO_FAULTS="shuffle.chunk:mode=garble,nth=2;compile:nth=1"

First-run semantics. The reference runs a plan as ONE jitted shard_map
program, so its ``shuffle.chunk`` and ``kernel.dispatch`` sites act only
while that program is traced: once per call site of the per-shard program,
on a cache miss, and never on a cache hit. The port has no trace: it runs
the plan over its shards in a loop on every call. So these two sites are
consulted through :func:`check_first_run`, which answers only inside
:func:`first_run` (``DistContext._run`` opens it for the first run of a
cache miss and for uncached plans), and a site called once a shard (the
kernel seam) is consulted on every ``num_shards``-th call of that run, so
a run consults it as often as the reference's trace does and the
``fault_calls``/``fault_fires`` counters agree. Which of the p calls
fires may differ from the reference's call site when shards interleave;
the rung it takes does not. ``DistContext._run`` never admits a plan
whose first run fired a fault into the plan cache, and result validation
(NaN scan + row-count/received invariants) catches poison at finalize
time.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Iterator, Sequence

SITES = (
    "shuffle.chunk",
    "kernel.dispatch",
    "stats.estimate",
    "cache.admission",
    "compile",
)

#: What an armed site does when its FaultPlan names no explicit mode.
DEFAULT_MODES = {
    "shuffle.chunk": "garble",    # or "raise"
    "kernel.dispatch": "raise",   # or "nan"
    "stats.estimate": "under",
    "cache.admission": "miss",    # or "evict"
    "compile": "raise",
}


class FaultError(RuntimeError):
    """An injected failure, tagged with the site that raised it — the
    recovery ladder routes on ``site`` (:func:`rung_for`)."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One armed site: when it fires and what it does.

    ``nth`` (1-based) fires on exactly that eligible call; otherwise
    ``probability`` draws a deterministic seeded per-call coin. A plan
    stops firing after ``max_fires`` total fires (<= 0 = unlimited) —
    the default of 1 models a transient fault the retry must outlive.
    ``factor`` is the ``stats.estimate`` derate divisor.
    """

    site: str
    mode: str | None = None
    nth: int | None = None
    probability: float = 0.0
    seed: int = 0
    max_fires: int = 1
    factor: float = 8.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {SITES}")

    @property
    def effective_mode(self) -> str:
        return self.mode if self.mode is not None \
            else DEFAULT_MODES[self.site]


def _unit(seed: int, tag: str, n: int) -> float:
    """Deterministic value in [0, 1) from (seed, tag, call index) — the
    seeded coin behind probability firing and retry jitter.

    crc32 alone is GF(2)-linear: two seeds hashing equal-length strings
    differ by a CONSTANT xor across every call, so bit-threshold tests
    (probability=0.5 reads the top bit) could coincide for all n. The
    splitmix-style finalizer breaks that linearity."""
    x = zlib.crc32(f"{seed}:{tag}:{n}".encode())
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    x = ((x ^ (x >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 2.0 ** 32


class FaultRegistry:
    """Armed FaultPlans + per-site call/fire counters (thread-safe).

    ``check(site)`` counts an eligible call and returns the plan when it
    fires (None otherwise). One registry per ``DistContext``; an empty
    registry is inert and free.
    """

    def __init__(self, plans: Sequence[FaultPlan] = ()):
        self._plans: dict[str, FaultPlan] = {}
        for p in plans:
            if p.site in self._plans:
                raise ValueError(f"duplicate FaultPlan for {p.site!r}")
            self._plans[p.site] = p
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fires: dict[str, int] = {}

    @property
    def active(self) -> bool:
        return bool(self._plans)

    @property
    def plans(self) -> tuple[FaultPlan, ...]:
        return tuple(self._plans.values())

    def plan(self, site: str) -> FaultPlan | None:
        return self._plans.get(site)

    def check(self, site: str) -> FaultPlan | None:
        p = self._plans.get(site)
        if p is None:
            return None
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            fires = self._fires.get(site, 0)
            if p.max_fires > 0 and fires >= p.max_fires:
                return None
            if p.nth is not None:
                fire = n == p.nth
            else:
                fire = _unit(p.seed, site, n) < p.probability
            if not fire:
                return None
            self._fires[site] = fires + 1
        return p

    def fire_count(self) -> int:
        with self._lock:
            return sum(self._fires.values())

    def stats(self) -> dict:
        """Flat counter snapshot (merged into ``ctx.cache_stats()``)."""
        with self._lock:
            return {"fault_calls": sum(self._calls.values()),
                    "fault_fires": sum(self._fires.values())}

    def fires_by_site(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fires)

    def reset(self):
        with self._lock:
            self._calls.clear()
            self._fires.clear()


# -- the thread-local scope ---------------------------------------------------
# Fault checks happen deep in library code (kernels, repartition, the plan
# cache) that has no DistContext handle; the context arms its registry
# around dispatch/finalize and the sites consult the innermost scope.

_scope = threading.local()


def current() -> FaultRegistry | None:
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def scope(registry: FaultRegistry | None) -> Iterator[None]:
    """Arm ``registry`` for fault checks on this thread. Inert (zero
    bookkeeping beyond a list push) when the registry is None/empty."""
    if registry is None or not registry.active:
        yield
        return
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append(registry)
    try:
        yield
    finally:
        stack.pop()


def check(site: str) -> FaultPlan | None:
    """Does an armed fault fire at ``site`` for this call? The universal
    site hook: returns None (and costs one attribute read) when no
    registry is in scope."""
    reg = current()
    if reg is None:
        return None
    fp = reg.check(site)
    if fp is not None:
        _scope.fired = getattr(_scope, "fired", 0) + 1
    return fp


def thread_fires() -> int:
    """Faults fired on this thread so far. A query runs on the thread that
    dispatches or resolves it, so the difference of two readings around
    its runs counts its own fires, whatever other threads fire meanwhile."""
    return getattr(_scope, "fired", 0)


# -- the first-run gate (the port's stand-in for trace time) -----------------

_first = threading.local()


@contextmanager
def first_run(num_shards: int) -> Iterator[None]:
    """Open the first-run gate on this thread for one run of a plan over
    ``num_shards`` shards: :func:`check_first_run` answers only inside."""
    prev = getattr(_first, "state", None)
    _first.state = (max(1, int(num_shards)), {})
    try:
        yield
    finally:
        _first.state = prev


def check_first_run(site: str, *, per_shard: bool = False
                    ) -> FaultPlan | None:
    """:func:`check` for the sites the reference consults at trace time:
    None outside :func:`first_run`. ``per_shard``: the caller runs once a
    shard, so only every ``num_shards``-th call of the run is consulted."""
    state = getattr(_first, "state", None)
    if state is None or current() is None:
        return None
    if per_shard:
        p, calls = state
        n = calls.get(site, 0)
        calls[site] = n + 1
        if n % p:
            return None
    return check(site)


# -- the REPRO_FAULTS env spec ------------------------------------------------

_FIELD_TYPES = {"mode": str, "nth": int, "probability": float,
                "prob": float, "seed": int, "max_fires": int,
                "factor": float}


def parse_spec(spec: str) -> list[FaultPlan]:
    """Parse ``site:k=v,k=v;site2:...`` into FaultPlans (see module doc)."""
    plans = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, rest = part.partition(":")
        kwargs = {}
        for item in rest.split(","):
            item = item.strip()
            if not item:
                continue
            k, sep, v = item.partition("=")
            k = k.strip()
            if not sep or k not in _FIELD_TYPES:
                raise ValueError(
                    f"bad REPRO_FAULTS field {item!r} (known: "
                    f"{sorted(_FIELD_TYPES)})")
            key = "probability" if k == "prob" else k
            kwargs[key] = _FIELD_TYPES[k](v.strip())
        plans.append(FaultPlan(site.strip(), **kwargs))
    return plans


def from_env(environ=os.environ) -> FaultRegistry | None:
    """Registry armed from ``REPRO_FAULTS``, or None when unset/empty."""
    spec = environ.get("REPRO_FAULTS", "")
    plans = parse_spec(spec) if spec else []
    return FaultRegistry(plans) if plans else None


# -- retry + degradation ------------------------------------------------------

#: Degradation kinds (the ladder rungs that change the executed program).
ORACLE_KERNEL = "oracle-kernel"   # kernel -> its plain version
MONO_SHUFFLE = "mono-shuffle"     # staged/ring shuffle -> monolithic AllToAll


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts with exponential backoff + deterministic jitter.

    ``max_attempts`` bounds TOTAL executions of one query (first try
    included). Delay before retry k (k >= 1) is ``base_delay_s *
    backoff**(k-1)``, perturbed by ±``jitter`` fraction via the seeded
    hash — deterministic, so a replayed chaos run sleeps identically.
    The default base delay is 0: tests and CI never sleep unless a
    caller opts into real backoff.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.0
    backoff: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def delay_s(self, attempt: int) -> float:
        if self.base_delay_s <= 0:
            return 0.0
        d = self.base_delay_s * self.backoff ** max(attempt - 1, 0)
        return d * (1.0 + self.jitter * (2.0 * _unit(self.seed, "retry",
                                                     attempt) - 1.0))

    def sleep(self, attempt: int):
        d = self.delay_s(attempt)
        if d > 0:
            time.sleep(d)


def rung_for(exc: BaseException) -> str:
    """Map a failure to its recovery rung: which degradation (if any) the
    next attempt applies. ``retry`` = re-dispatch unchanged (the fresh-
    compile rung: ``compile`` faults invalidate their cache entry before
    raising, so the plain retry recompiles)."""
    if isinstance(exc, FaultError):
        if exc.site == "kernel.dispatch":
            return ORACLE_KERNEL
        if exc.site == "shuffle.chunk":
            return MONO_SHUFFLE
        if exc.site == "compile":
            return "recompile"
    return "retry"
