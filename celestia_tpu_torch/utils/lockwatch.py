"""Runtime lock-order shadow checker: the dynamic half of celint R6.

The static pass (celestia_tpu_torch/lint/lockorder.py) derives a lock-
acquisition graph from source; this module records the orders the
process ACTUALLY acquires locks in, so the tier-1 concurrency hammers
(tests/test_race.py, tests/test_lru.py — `make lockwatch`) validate the
static graph with execution instead of trusting it:

* an **inversion** — some thread acquired A then B while some thread
  acquired B then A — is detected the moment the second order is
  observed and reported through ``faults.note("lockwatch.inversion")``
  with BOTH acquisition stacks (the two sides of the would-be deadlock);
* the observed pair set is exportable (:func:`observed_pairs`, keyed by
  lock CONSTRUCTION site ``(repo-relative file, line)``) so
  ``lint.lockorder.runtime_crosscheck`` can join it against the static
  graph — an execution order contradicting the derived hierarchy fails
  even when no second thread happened to race the opposite order.

**Arming.**  ``CELESTIA_TPU_TORCH_LOCKWATCH=1`` in the environment installs
the watcher at ``celestia_tpu_torch`` import time (before any module-level
lock is constructed) and arms it; the chaos fixture arms an
already-installed watcher per-test.  Installation replaces
``threading.Lock``/``threading.RLock`` with factories that wrap ONLY
locks constructed from files inside the package (the construction site
is how observations join back to static identities — a stdlib or torch
lock has none); everything else receives the real primitive untouched.
Disarmed and uninstalled — every production run — the module costs
nothing: no factory is installed, no import-time work happens beyond
one environment check.

**Self-instrumentation hazard.**  The reporter itself uses locks
(its own bookkeeping lock, and ``faults._lock`` inside ``note``).  The
bookkeeping lock is created from the saved REAL constructor so it is
never watched, and a thread-local re-entrancy guard keeps the
``faults.note`` call from recursing into pair recording while a report
is being filed.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

ENV = "CELESTIA_TPU_TORCH_LOCKWATCH"

# saved BEFORE install() ever swaps the module attributes
_real_lock_ctor = threading.Lock
_real_rlock_ctor = threading.RLock

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

_installed = False
_armed = False
_state_lock = _real_lock_ctor()  # deliberately unwatched (see docstring)
# (site_a, site_b) -> acquisition stack of the B-acquire that created the
# pair; sites are (repo-relative path, line) construction sites
_pairs: Dict[Tuple[Tuple[str, int], Tuple[str, int]], str] = {}  # celint: guarded-by(_state_lock)
_inversions: List[dict] = []  # celint: guarded-by(_state_lock)
# lock-free fast-path dedup: a pair already seen skips the stack capture
# entirely (benign race: a duplicate capture is re-deduped under the lock)
_seen_fast: set = set()

_tls = threading.local()

Site = Tuple[str, int]


class WatchedLock:
    """A wrapped threading.Lock/RLock that records acquisition order
    while the watcher is armed.  ``site`` is the construction site the
    static analysis knows this lock by."""

    __slots__ = ("_real", "site", "reentrant")

    def __init__(self, real, site: Site, reentrant: bool):
        self._real = real
        self.site = site
        self.reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok and _armed:
            _on_acquired(self)
        return ok

    def release(self) -> None:
        # balance the held list even while DISARMED: a lock acquired
        # armed and released across a disarm window would otherwise
        # linger in _tls.held and fabricate pairs after re-arming
        _on_released(self)
        self._real.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        probe = getattr(self._real, "locked", None)
        return bool(probe()) if callable(probe) else False

    def __repr__(self) -> str:
        return f"<WatchedLock {self.site[0]}:{self.site[1]}>"


def _held() -> List[WatchedLock]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _on_acquired(lock: WatchedLock) -> None:
    held = _held()
    if any(h is lock for h in held):
        held.append(lock)  # reentrant reacquire: balance releases only
        return
    fresh = [
        (h.site, lock.site)
        for h in held
        if h.site != lock.site and (h.site, lock.site) not in _seen_fast
    ]
    held.append(lock)
    if not fresh or getattr(_tls, "in_hook", False):
        return
    _tls.in_hook = True
    try:
        stack = "".join(traceback.format_stack(limit=16)[:-1])
        new_inversions: List[dict] = []
        with _state_lock:
            for pair in fresh:
                _seen_fast.add(pair)
                if pair in _pairs:
                    continue
                _pairs[pair] = stack
                rev = (pair[1], pair[0])
                if rev in _pairs:
                    new_inversions.append(
                        {
                            "first": pair[0],
                            "second": pair[1],
                            "stack_ab": stack,
                            "stack_ba": _pairs[rev],
                        }
                    )
                    _inversions.append(new_inversions[-1])
        for inv in new_inversions:
            _report_inversion(inv)
    finally:
        _tls.in_hook = False


def _report_inversion(inv: dict) -> None:
    from celestia_tpu_torch.utils import faults

    a = "%s:%d" % inv["first"]
    b = "%s:%d" % inv["second"]
    faults.note(
        "lockwatch.inversion",
        RuntimeError(
            f"lock-order inversion: {a} -> {b} and {b} -> {a} both "
            "observed (full stacks in lockwatch.inversions())"
        ),
    )


def _on_released(lock: WatchedLock) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return
    # acquired before arming (or across a disarm): nothing to balance


# ---------------------------------------------------------------------------
# construction-site wrapping
# ---------------------------------------------------------------------------


def _caller_site() -> Optional[Site]:
    """(repo-relative path, line) of the first frame outside this module
    — None when the construction is not from inside the package (that
    lock has no static identity and stays unwatched)."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return None
    path = f.f_code.co_filename
    if not path.startswith(_PKG_ROOT + os.sep):
        return None
    rel = os.path.relpath(path, _REPO_ROOT).replace(os.sep, "/")
    return (rel, f.f_lineno)


def _make_lock():
    real = _real_lock_ctor()
    site = _caller_site()
    if site is None:
        return real
    return WatchedLock(real, site, reentrant=False)


def _make_rlock():
    real = _real_rlock_ctor()
    site = _caller_site()
    if site is None:
        return real
    return WatchedLock(real, site, reentrant=True)


def watched(reentrant: bool = False, site: Optional[Site] = None) -> WatchedLock:
    """Explicitly construct a watched lock (unit tests inject deliberate
    inversions without installing the global factories)."""
    real = _real_rlock_ctor() if reentrant else _real_lock_ctor()
    if site is None:
        f = sys._getframe(1)
        site = (
            os.path.relpath(f.f_code.co_filename, _REPO_ROOT).replace(os.sep, "/"),
            f.f_lineno,
        )
    return WatchedLock(real, site, reentrant)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def install() -> None:
    """Swap threading.Lock/RLock for the site-filtered factories.  Call
    BEFORE package modules construct their module-level locks (the
    package __init__ does, when the environment arms it)."""
    global _installed
    if _installed:
        return
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    _installed = True


def installed() -> bool:
    return _installed


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


def install_from_env() -> None:
    if os.environ.get(ENV, "").strip():
        install()
        arm()


def reset() -> None:
    with _state_lock:
        _pairs.clear()
        _inversions.clear()
    _seen_fast.clear()


def observed_pairs() -> Dict[Tuple[Site, Site], str]:
    with _state_lock:
        return dict(_pairs)


def inversions() -> List[dict]:
    with _state_lock:
        return [dict(i) for i in _inversions]


def report() -> str:
    """Human-readable summary: every inversion with its two stacks."""
    invs = inversions()
    if not invs:
        with _state_lock:
            n = len(_pairs)
        return f"lockwatch: no inversions ({n} ordered pair(s) observed)"
    lines = [f"lockwatch: {len(invs)} lock-order inversion(s)"]
    for inv in invs:
        a = "%s:%d" % inv["first"]
        b = "%s:%d" % inv["second"]
        lines.append(f"--- {a} -> {b} observed here:")
        lines.append(inv["stack_ab"].rstrip())
        lines.append(f"--- and {b} -> {a} observed here:")
        lines.append(inv["stack_ba"].rstrip())
    return "\n".join(lines)
