"""The ONE bounded LRU every cache in the node is built on.

Copy of ``celestia_tpu/utils/lru.py`` for the port, with its own registry
of live caches.  Two changes: the ``lru.put`` fault hook is gone (the
port has no ``utils/faults`` yet), and :func:`nbytes_weigher` weighs an
ExtendedDataSquare from its share tensor's shape, wherever it lies.

Five hand-rolled lock+OrderedDict caches grew up independently on the
hot path (da/eds_cache, da/dah row memo, App sig/decoded caches,
gossip's seen-set) and a sixth (da/inclusion's commitment cache) shipped
with NO lock at all while being mutated from pooled threads.  Each copy
re-implemented the same four responsibilities — recency, bounding,
thread-safety, stats — and each copy was one review away from drifting
(the commitment cache DID drift).  This module centralises them:

* **Thread-safe by construction.**  Every read and mutation happens
  under one internal lock; callers never see a torn OrderedDict.  The
  compound operations concurrent callers actually need
  (:meth:`add_if_absent`, :meth:`get_or_put`) are atomic methods here,
  not check-then-act sequences at call sites.
* **Bounded two ways.**  ``max_entries`` is the hard entry cap;
  ``max_bytes`` (optional, needs a ``weigher``) additionally evicts by
  approximate resident size, so one cache of huge values (a 128x128 EDS
  is ~32 MiB) and one of tiny digests can share a uniform policy.
* **Unified stats.**  hits/misses/puts/replacements/evictions plus
  approximate resident bytes, per cache and aggregated process-wide via
  :func:`registry_stats`, surfaced through utils/telemetry.py and
  bench.py — production nodes get one knob and one dashboard, not five.

celint rule R2 (no-handrolled-cache) forbids the OrderedDict+eviction
pattern everywhere else in the tree, so the next cache MUST be built on
this class — the rule is what keeps this consolidation from regressing.

The registry holds weak references: short-lived caches (each test App
owns a sig cache) vanish from the process view when their owner dies.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict  # R2-exempt: the sanctioned implementation
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# process-wide soft budget over the summed approx_bytes of every live
# cache; purely advisory (reported + flagged, never cross-cache
# enforced — each cache's own caps do the evicting)
_BUDGET_ENV = "CELESTIA_TPU_TORCH_CACHE_BUDGET_MB"

_registry_lock = threading.Lock()
# id(cache) -> weakref; celint: guarded-by(_registry_lock)
_registry: Dict[int, "weakref.ref[LruCache]"] = {}


def _register(cache: "LruCache") -> None:
    with _registry_lock:
        _registry[id(cache)] = weakref.ref(cache)


class LruCache:
    """Bounded, thread-safe LRU mapping with unified stats.

    ``weigher(key, value) -> int`` estimates an entry's resident bytes;
    it is consulted once per insert (weights are stored, so eviction
    never re-weighs a value that may have been mutated).
    """

    def __init__(
        self,
        name: str,
        max_entries: int,
        *,
        weigher: Optional[Callable[[Any, Any], int]] = None,
        max_bytes: Optional[int] = None,
        register: bool = True,
    ):
        self.name = name
        self._max_entries = max(1, int(max_entries))
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._weigher = weigher
        self._lock = threading.Lock()
        # value + stored weight; celint: guarded-by(self._lock)
        self._entries: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0  # celint: guarded-by(self._lock)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.replacements = 0
        self.evictions = 0
        if register:
            _register(self)

    # -- reads ---------------------------------------------------------

    def get(self, key, default=None, *, count: bool = True, touch: bool = True):
        """Value for ``key`` (refreshing recency) or ``default``.

        ``count=False`` skips the hit/miss counters — for high-frequency
        bookkeeping lookups that would drown the workload hit rate (the
        min-DAH reads in da/eds_cache) — but still refreshes recency so
        the entry does not sit perpetually first in the eviction line.

        ``touch=False`` additionally leaves recency alone.  With it, a
        cache whose puts arrive in a meaningful order (the decided log's
        monotonically increasing heights) keeps FIFO eviction no matter
        how often old entries are read — reads cannot fragment the
        retained window.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if count:
                    self.misses += 1
                return default
            if touch:
                self._entries.move_to_end(key)
            if count:
                self.hits += 1
            return entry[0]

    def get_many(self, keys: Iterable[Any], default=None, *, count: bool = True) -> List[Any]:
        """Batch :meth:`get` under ONE lock acquisition (hot batch paths
        like the row memo: one lock round-trip per square, not per row)."""
        with self._lock:
            out = []
            for key in keys:
                entry = self._entries.get(key)
                if entry is None:
                    if count:
                        self.misses += 1
                    out.append(default)
                    continue
                self._entries.move_to_end(key)
                if count:
                    self.hits += 1
                out.append(entry[0])
            return out

    def peek(self, key, default=None):
        """:meth:`get` without touching the hit/miss counters."""
        return self.get(key, default, count=False)

    def __contains__(self, key) -> bool:
        """Membership only: no counters, no recency refresh."""
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __iter__(self):
        """Iterate a SNAPSHOT of the keys (LRU-first): safe under
        concurrent mutation, no recency/counter effects."""
        with self._lock:
            return iter(list(self._entries))

    def keys(self) -> List[Any]:
        """Key snapshot, LRU-first (same contract as ``__iter__``)."""
        with self._lock:
            return list(self._entries)

    # -- writes --------------------------------------------------------

    def _weigh(self, key, value) -> int:
        if self._weigher is None:
            return 0
        try:
            return max(0, int(self._weigher(key, value)))
        except Exception:
            return 0  # a broken weigher must never break the cache

    def _insert_locked(self, key, value) -> bool:
        """Insert/replace + evict; caller holds the lock.  True if new."""
        w = self._weigh(key, value)
        prev = self._entries.get(key)
        if prev is not None:
            self._bytes -= prev[1]
            self.replacements += 1
            new = False
        else:
            self.puts += 1
            new = True
        self._entries[key] = (value, w)
        self._entries.move_to_end(key)
        self._bytes += w
        while len(self._entries) > self._max_entries or (
            self._max_bytes is not None
            and self._bytes > self._max_bytes
            and len(self._entries) > 1
        ):
            _, (_, ew) = self._entries.popitem(last=False)
            self._bytes -= ew
            self.evictions += 1
        return new

    def put(self, key, value) -> bool:
        """Insert or replace.  Returns True when ``key`` was new."""
        with self._lock:
            return self._insert_locked(key, value)

    def put_many(self, pairs: Iterable[Tuple[Any, Any]]) -> None:
        """Batch :meth:`put` under ONE lock acquisition — the batch is
        atomic: no interleaved reader observes a half-inserted batch."""
        with self._lock:
            for key, value in pairs:
                self._insert_locked(key, value)

    def add_if_absent(self, key, value=True) -> bool:
        """Atomic membership-add (dedup-set use).  True if newly added;
        an existing entry counts as a hit, a fresh one as a miss."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return False
            self.misses += 1
            self._insert_locked(key, value)
            return True

    def get_or_put(self, key, factory: Callable[[], Any]):
        """Atomic lookup-or-compute.  ``factory`` runs under the lock —
        keep it cheap (for expensive values compute outside and race on
        :meth:`put`; last writer wins with identical bytes)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[0]
            self.misses += 1
            value = factory()
            self._insert_locked(key, value)
            return value

    def pop(self, key, default=None):
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return default
            self._bytes -= entry[1]
            return entry[0]

    def clear(self) -> None:
        """Drop all entries AND reset counters (bench epoch boundary)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self.hits = self.misses = self.puts = 0
            self.replacements = self.evictions = 0

    # -- sizing --------------------------------------------------------

    @property
    def max_entries(self) -> int:
        return self._max_entries

    def set_max_entries(self, n: int) -> None:
        """Re-cap; an over-full cache is trimmed immediately."""
        with self._lock:
            self._max_entries = max(1, int(n))
            while len(self._entries) > self._max_entries:
                _, (_, ew) = self._entries.popitem(last=False)
                self._bytes -= ew
                self.evictions += 1

    def approx_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "name": self.name,
                "entries": len(self._entries),
                "max_entries": self._max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "replacements": self.replacements,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
                "approx_bytes": self._bytes,
            }


# ---------------------------------------------------------------------------
# process-wide registry + budget reporting
# ---------------------------------------------------------------------------


def live_caches() -> List[LruCache]:
    """Snapshot of registered caches still alive (dead refs pruned)."""
    with _registry_lock:
        out: List[LruCache] = []
        dead: List[int] = []
        for cid, ref in _registry.items():
            cache = ref()
            if cache is None:
                dead.append(cid)
            else:
                out.append(cache)
        for cid in dead:
            del _registry[cid]
        return out


def cache_budget_bytes() -> Optional[int]:
    """The advisory process-wide budget (None = unset)."""
    raw = os.environ.get(_BUDGET_ENV, "").strip()
    if not raw:
        return None
    try:
        mb = float(raw)
    except ValueError:
        return None
    return int(mb * 1024 * 1024) if mb > 0 else None


def registry_stats() -> dict:
    """Aggregated view of every live cache, grouped by name (several App
    instances each own a ``sig`` cache; the process view sums them)."""
    by_name: Dict[str, dict] = {}
    for cache in live_caches():
        s = cache.stats()
        agg = by_name.get(s["name"])
        if agg is None:
            agg = dict(s)
            agg["instances"] = 1
            del agg["name"]
            by_name[s["name"]] = agg
        else:
            agg["instances"] += 1
            for k in (
                "entries", "hits", "misses", "puts", "replacements",
                "evictions", "approx_bytes",
            ):
                agg[k] += s[k]
            agg["max_entries"] = max(agg["max_entries"], s["max_entries"])
    for agg in by_name.values():
        total = agg["hits"] + agg["misses"]
        agg["hit_rate"] = round(agg["hits"] / total, 4) if total else 0.0
    total_bytes = sum(a["approx_bytes"] for a in by_name.values())
    budget = cache_budget_bytes()
    return {
        "caches": by_name,
        "total_approx_bytes": total_bytes,
        "budget_bytes": budget,
        "over_budget": bool(budget is not None and total_bytes > budget),
    }


# shared weighers ------------------------------------------------------------


def bytes_len_weigher(key, value) -> int:
    """Weigher for bytes-like keys/values (digest caches)."""
    kw = len(key) if isinstance(key, (bytes, bytearray, str)) else 16
    vw = len(value) if isinstance(value, (bytes, bytearray)) else 16
    return kw + vw


def nbytes_weigher(key, value) -> int:
    """Weigher for values exposing numpy-style ``.nbytes`` (possibly
    nested one level in a tuple) — the EDS/DAH pair case."""
    def one(v) -> int:
        # ExtendedDataSquare: size from the share tensor's SHAPE so a
        # device-resident EDS is never pulled to the host just to weigh it
        inner = getattr(v, "tensor", None)
        shape = getattr(inner, "shape", None)
        if shape is not None:
            n = 1
            for d in shape:
                n *= int(d)
            return n
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            return int(nb)
        if isinstance(v, (bytes, bytearray)):
            return len(v)
        return 64
    if isinstance(value, tuple):
        return sum(one(v) for v in value) + 32
    return one(value) + 32
