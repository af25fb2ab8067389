"""Plan cache: canonical plan -> prepared plan (the port of
``repro.core.plan_cache``).

Concurrent-query serving lives or dies on never re-preparing a plan shape
a client has already run. The reference caches the jitted executable of a
plan; the port has no compile, so the cached value is the prepared plan
callable (the optimized variant plan bound to ``execute_plan`` and the
mesh), and a miss is what the reference calls a compile. The cache is:

* **LRU admission with budgets**: ``max_entries`` bounds the entry count
  and ``max_weight`` bounds a caller-supplied weight sum (entries default
  to weight 1), so a long-lived serving session over an open-ended query
  mix cannot grow without bound. Reuse refreshes recency.
* **Counters**: ``hits`` / ``misses`` / ``evictions`` / ``recompiles``
  (a miss on a key that was cached before and has since been evicted:
  the signal that the budgets are too small for the working set),
  surfaced through :meth:`stats` and re-exported as
  ``DistContext.cache_stats()``. Recompile detection keeps a bounded set
  of key HASHES (not the keys: a full key retains the whole nested
  canonical-plan tuple), so the accounting cannot leak over an
  open-ended key mix; rare hash collisions only perturb a counter, never
  a lookup.
* **Content-keyed keyless plans**: plans with keyless user lambdas are
  keyed by ``plan.identity_key`` (the code object plus every value the
  predicate's behaviour depends on); the key tuple pins those objects
  while the entry is resident. (The reference's ``guards=``, for keys on
  object identity, is not kept: no plan in the port is keyed so.)

Safe-capacity plans are cached under their own namespace by the caller
(``("plan-safe", ...)`` vs ``("plan", ...)``), degraded ones under
``"plan-degraded"``, so the variants of one logical plan never collide.

Under ``REPRO_VERIFY_PLANS`` every plan ``optimize()`` produces has
passed ``repro_torch.core.verify``; the verifier's counters ride beside
this cache's in ``DistContext.cache_stats()``.

All mutating operations take an internal re-entrant lock, so concurrent
client threads sharing one ``DistContext`` cannot corrupt the LRU order
or the counters (two racing misses may both prepare; the second ``put``
wins: wasted work, never a wrong result).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable

from repro_torch.core import faults as FLT

# recompile accounting remembers at most this many distinct key hashes;
# keys seen beyond the cap simply stop counting as recompiles on re-miss
_EVER_CAP = 1 << 16


class _Entry:
    __slots__ = ("value", "weight")

    def __init__(self, value, weight: int):
        self.value = value
        self.weight = weight


class PlanCache:
    """LRU map from hashable plan keys to prepared plans."""

    def __init__(self, max_entries: int = 256,
                 max_weight: float | None = None):
        assert max_entries >= 1, max_entries
        self.max_entries = max_entries
        self.max_weight = max_weight
        self._entries: OrderedDict[object, _Entry] = OrderedDict()
        self._weight = 0
        self._ever: set[int] = set()  # hashes of keys admitted at least once
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.recompiles = 0

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:  # no counter side effects
        return key in self._entries

    @property
    def weight(self) -> int:
        return self._weight

    def keys(self) -> Iterable:
        with self._lock:
            return list(self._entries.keys())

    def stats(self) -> dict:
        """Counter snapshot (plain ints — JSON-serializable)."""
        with self._lock:
            return {"entries": len(self._entries), "weight": self._weight,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "recompiles": self.recompiles}

    # -- the cache protocol --------------------------------------------------
    def get(self, key):
        """The cached plan, or None. Counts hit/miss and refreshes
        recency; a miss on a previously-admitted key counts a recompile.

        The ``cache.admission`` fault site fires here: a spurious miss
        (or miss + eviction, mode ``evict``) on a key that IS resident.
        No recovery ladder: the caller re-prepares as for any miss, and
        the recompile counter records it; injected correctness impact
        must be nil (the chaos-suite assertion for this site).
        """
        fp = FLT.check("cache.admission")
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and fp is not None:
                if fp.effective_mode == "evict":
                    self._entries.pop(key)
                    self._weight -= entry.weight
                    self.evictions += 1
                entry = None  # spurious miss either way
            if entry is None:
                self.misses += 1
                if hash(key) in self._ever:
                    self.recompiles += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return entry.value

    def put(self, key, value, *, weight: int = 1):
        """Admit ``value`` under ``key``, evicting LRU entries over budget."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._weight -= old.weight
            entry = _Entry(value, weight)
            self._entries[key] = entry
            self._weight += weight
            if len(self._ever) < _EVER_CAP:
                self._ever.add(hash(key))
            self._evict_over_budget(keep=key)

    def invalidate(self, key) -> bool:
        """Drop ``key`` if resident (explicit flush)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._weight -= entry.weight
            self.evictions += 1
            return True

    def clear(self):
        """Explicit flush: drops every entry AND the recompile-accounting
        hash set (a fresh cache starts with fresh accounting)."""
        with self._lock:
            self.evictions += len(self._entries)
            self._entries.clear()
            self._weight = 0
            self._ever.clear()

    def _evict_over_budget(self, keep):
        while len(self._entries) > self.max_entries or (
                self.max_weight is not None
                and self._weight > self.max_weight
                and len(self._entries) > 1):
            key = next(iter(self._entries))
            if key == keep and len(self._entries) == 1:
                break  # never evict the entry just admitted
            entry = self._entries.pop(key)
            self._weight -= entry.weight
            self.evictions += 1
