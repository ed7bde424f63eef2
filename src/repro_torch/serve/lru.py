"""The warm-plan LRU — plan-cache multiplexing for the serving engine
(counterpart of ``repro.serve.lru``).

Plans are expensive to Create (weight building and tap reduction,
pentadiagonal factorisation, a user point function's build) and cheap to
hold (a few small tensors), so the engine keeps the most recently used
ones warm in a bounded LRU keyed by :func:`repro_torch.api.plan_key` —
the reference's key, string for string.

Eviction is *destructive* by default: the evicted plan is passed to
:func:`repro_torch.destroy`, so a stale plan that some caller kept a
reference to refuses further ``repro_torch.compute`` calls instead of
silently serving from outside the cache's accounting.

>>> lru = PlanLRU(capacity=2)
>>> lru.get_or_create("a", lambda: "plan-a")
('plan-a', False)
>>> lru.get_or_create("a", lambda: "never called")
('plan-a', True)
>>> _ = lru.get_or_create("b", lambda: "plan-b")
>>> _ = lru.get_or_create("c", lambda: "plan-c")   # capacity 2: evicts "a"
>>> lru.stats()["evictions"], len(lru)
(1, 2)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from collections.abc import Callable
from typing import Any


class PlanLRU:
    """A bounded, thread-safe, destroy-on-evict LRU of warm plans.

    ``capacity`` is the maximum number of resident plans (>= 1).
    ``destroy_on_evict=False`` keeps evicted plans usable — for callers
    that hand plans out and only want the *cache* bounded, not the plans'
    lifetime managed.
    """

    def __init__(self, capacity: int = 8, *, destroy_on_evict: bool = True):
        if not isinstance(capacity, int) or capacity < 1:
            raise ValueError(f"capacity must be a positive int, got {capacity!r}")
        self.capacity = capacity
        self.destroy_on_evict = destroy_on_evict
        self._plans: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: str):
        """The warm plan for ``key`` (now most-recently-used), or None."""
        with self._lock:
            if key in self._plans:
                self._plans.move_to_end(key)
                self._hits += 1
                return self._plans[key]
            self._misses += 1
            return None

    def put(self, key: str, plan) -> None:
        """Insert ``plan`` as most-recently-used; evict (and destroy) the
        least-recently-used entries beyond capacity."""
        evicted = []
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.capacity:
                _, old = self._plans.popitem(last=False)
                self._evictions += 1
                evicted.append(old)
        for old in evicted:
            self._destroy(old)

    def get_or_create(self, key: str, factory: Callable[[], Any]):
        """``(plan, hit)`` — the warm plan, or ``factory()`` inserted.

        The factory runs outside the lock (plan creation is the slow
        path); with one engine worker that is race-free, and with many,
        the worst case is a duplicate Create whose loser gets evicted
        normally later.
        """
        plan = self.get(key)
        if plan is not None:
            return plan, True
        plan = factory()
        self.put(key, plan)
        return plan, False

    def drop(self, key: str, *, destroy: bool = True) -> bool:
        """Evict one entry by key (e.g. a plan known to be broken after a
        backend failure), destroying it unless ``destroy=False``.
        Returns whether the key was resident; absent keys are a no-op.
        """
        with self._lock:
            plan = self._plans.pop(key, None)
            if plan is None:
                return False
            self._evictions += 1
        if destroy:
            self._destroy(plan)
        return True

    def clear(self, *, destroy: bool = True) -> None:
        """Drop every entry, destroying them unless ``destroy=False``."""
        with self._lock:
            plans = list(self._plans.values())
            self._plans.clear()
        if destroy:
            from repro_torch import api as _api

            for plan in plans:
                _api.destroy(plan)

    def _destroy(self, plan) -> None:
        if self.destroy_on_evict:
            from repro_torch import api as _api

            _api.destroy(plan)

    def stats(self) -> dict:
        """Counters: hits / misses / evictions / size / capacity."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "size": len(self._plans),
                "capacity": self.capacity,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._plans
