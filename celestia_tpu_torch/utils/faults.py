"""Deterministic fault injection + the unified retry/degradation policy layer.

The DA hot path is aggressively concurrent (hostpool, the
3-phase native pipeline, six shared LRU caches) and its failure modes
were fixed by hand as they were found — but nothing could *provoke*
a native crash, a dead pool worker, a truncated snapshot chunk, or a
flaky peer on demand, so every recovery path was an untested guess.
This module makes degradation first-class, tested code:

* **Fault-injection registry.**  Named fault points (:data:`FAULT_POINTS`)
  armed via the ``CELESTIA_TPU_TORCH_FAULTS`` environment variable or the
  ``chaos`` test fixture, with a SEEDED schedule — fail-once, fail-rate,
  latency, corrupt-bytes.  Same seed => same decision sequence, across
  processes (seeds are domain-separated through sha256, never Python's
  randomized ``hash()``).  When nothing is armed, :func:`fire` is one
  module-bool check — zero overhead on the hot path.
* **One retry policy.**  :class:`RetryPolicy` (decorrelated-jitter
  backoff from a seeded generator, hard deadline budgets) and
  :class:`CircuitBreaker`/:class:`BreakerRegistry` (per-peer failure
  gating) replace the ad-hoc sleep/backoff logic that had grown
  independently in node/gossip.py, node/coordinator.py, client/remote.py
  and client/signer.py.  celint rule R5 (``sanctioned-retry``) forbids
  hand-rolled ``time.sleep`` retry loops and silent exception swallows
  everywhere but here, so the consolidation cannot regress.
* **Degradation telemetry.**  :func:`note` records exceptions that
  background/pooled threads deliberately survive (named by fault point,
  never silently dropped — the audit-sweep contract), and
  :func:`fault_stats` exposes injected/recovered counts to bench.py's
  ``extras.fault_stats``.

Reproduction: every schedule derives from ``CELESTIA_TPU_TORCH_CHAOS_SEED``
(or an explicit ``seed=``); ``CELESTIA_TPU_TORCH_FAULTS`` takes
``point:mode[,key=value...][;point:mode...]``, e.g.
``gossip.fetch:fail_rate,rate=0.1,seed=7;snapshots.chunk:corrupt``.
See specs/robustness.md for the catalog and the degradation ladder.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

# bounded length of each armed point's decision trace (see _ArmedFault)
_TRACE_CAP = 4096

# ---------------------------------------------------------------------------
# fault points
# ---------------------------------------------------------------------------

FAULT_POINTS = (
    "native.extend",    # native .so ExtendBlock pipeline entry
    "hostpool.worker",  # a pooled host worker dies mid-item
    "gossip.fetch",     # catch-up / status / decided-block pull RPCs
    "snapshots.chunk",  # state-sync chunk fetch (fail or corrupt bytes)
    "server.sample",    # DAS serving-plane handler
    "lru.put",          # a cache insert is dropped (lost write)
)

MODES = ("fail_once", "fail_rate", "latency", "corrupt")

_ENV = "CELESTIA_TPU_TORCH_FAULTS"
_SEED_ENV = "CELESTIA_TPU_TORCH_CHAOS_SEED"


class InjectedFault(RuntimeError):
    """An error raised by an armed fault point (never by real code)."""


class WorkerDeath(InjectedFault):
    """The hostpool.worker flavor: simulates a pool worker dying mid-item
    so utils/hostpool.py can prove it self-heals without losing tasks."""


class Overloaded(RuntimeError):
    """A serving plane shed this request; retry after ``retry_after_ms``.
    Raised client-side on a shed response so :meth:`RetryPolicy.run` can
    honor the server's pushback instead of hammering it."""

    def __init__(self, msg: str, retry_after_ms: float = 25.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


def chaos_seed() -> int:
    """The process-wide chaos seed (``CELESTIA_TPU_TORCH_CHAOS_SEED``, default
    0) — every schedule and every seeded backoff derives from it unless
    given an explicit ``seed=``."""
    raw = os.environ.get(_SEED_ENV, "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def derive_seed(*parts) -> int:
    """Deterministic 64-bit sub-seed from (seed, domain, ...) parts.

    sha256, NOT ``hash()``: Python string hashing is salted per process
    (PYTHONHASHSEED), and the whole point of a chaos seed is that the
    schedule reproduces across runs and machines."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big")


class _ArmedFault:
    """One armed point's schedule state (mutated under ``_lock``)."""

    def __init__(
        self,
        point: str,
        mode: str,
        *,
        rate: float = 1.0,
        delay_ms: float = 0.0,
        count: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: {', '.join(FAULT_POINTS)})"
            )
        if mode not in MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (known: {', '.join(MODES)})"
            )
        self.point = point
        self.mode = mode
        self.rate = float(rate)
        self.delay_ms = float(delay_ms)
        # fail_once defaults to exactly one injection; other modes are
        # unbounded unless count says otherwise
        self.count = (
            int(count)
            if count is not None
            else (1 if mode == "fail_once" else None)
        )
        self.seed = seed if seed is not None else chaos_seed()
        self._rng = random.Random(derive_seed(self.seed, point, mode))
        self.checks = 0
        self.injected = 0
        # per-check trace (determinism assertions); bounded so a point
        # left armed on a long-running chaos node cannot leak — the last
        # _TRACE_CAP decisions are plenty for any suite assertion
        self.decisions: "deque[bool]" = deque(maxlen=_TRACE_CAP)

    def decide_locked(self) -> bool:
        """One schedule decision; caller holds the registry lock."""
        self.checks += 1
        if self.count is not None and self.injected >= self.count:
            self.decisions.append(False)
            return False
        if self.mode == "fail_once":
            hit = True
        else:
            # one rng draw per check keeps the decision sequence a pure
            # function of (seed, point, mode, check index)
            hit = self._rng.random() < self.rate
        if hit:
            self.injected += 1
        self.decisions.append(hit)
        return hit

    def corrupt_locked(self, data: bytes) -> bytes:
        """Deterministically flip one byte of ``data`` (corrupt mode)."""
        if not data:
            return data
        idx = self._rng.randrange(len(data))
        flip = self._rng.randrange(1, 256)
        out = bytearray(data)
        out[idx] ^= flip
        return bytes(out)

    def spec(self) -> dict:
        return {
            "mode": self.mode,
            "rate": self.rate,
            "delay_ms": self.delay_ms,
            "count": self.count,
            "seed": self.seed,
            "checks": self.checks,
            "injected": self.injected,
        }


_lock = threading.Lock()
# point -> schedule; celint: guarded-by(_lock)
_armed: Dict[str, _ArmedFault] = {}
# fast-path gate: fire()/should_drop()/corrupt() return immediately when
# False, so a disarmed node pays one bool check per fault point
_active = False
# swallowed-exception telemetry: name -> [count, last repr];
# celint: guarded-by(_lock)
_notes: Dict[str, list] = {}
# degradations recorded by poison()/self-heal paths;
# celint: guarded-by(_lock)
_degradations: List[dict] = []


def arm(
    point: str,
    mode: str,
    *,
    rate: float = 1.0,
    delay_ms: float = 0.0,
    count: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Arm one fault point with a seeded schedule (replaces any previous
    schedule for the point)."""
    global _active
    f = _ArmedFault(
        point, mode, rate=rate, delay_ms=delay_ms, count=count, seed=seed
    )
    with _lock:
        _armed[point] = f
        _active = True


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point, or everything when ``point`` is None."""
    global _active
    with _lock:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)
        _active = bool(_armed)


def armed_points() -> Dict[str, dict]:
    with _lock:
        return {p: f.spec() for p, f in _armed.items()}


def arm_from_spec(spec: str) -> None:
    """Arm from a ``CELESTIA_TPU_TORCH_FAULTS``-style spec string:
    ``point:mode[,key=value...]`` entries separated by ``;``."""
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, _, tail = entry.partition(",")
        point, _, mode = head.partition(":")
        if not mode:
            raise ValueError(
                f"fault spec entry {entry!r} must be point:mode[,k=v...]"
            )
        kwargs: Dict[str, Any] = {}
        for kv in tail.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            if k == "rate":
                kwargs["rate"] = float(v)
            elif k == "delay_ms":
                kwargs["delay_ms"] = float(v)
            elif k == "count":
                kwargs["count"] = int(v)
            elif k == "seed":
                kwargs["seed"] = int(v)
            else:
                raise ValueError(f"unknown fault spec key {k!r} in {entry!r}")
        arm(point.strip(), mode.strip(), **kwargs)


def arm_from_env() -> None:
    """Arm from ``CELESTIA_TPU_TORCH_FAULTS`` (no-op when unset).  Called once
    at import so a chaos-configured process needs no code changes; a
    malformed spec raises loudly — silently ignoring a typo'd chaos spec
    would fake a green chaos run."""
    spec = os.environ.get(_ENV, "").strip()
    if spec:
        arm_from_spec(spec)


def fire(point: str) -> None:
    """The injection hook: no-op when ``point`` is disarmed; raises
    :class:`InjectedFault` (``WorkerDeath`` for hostpool.worker) or
    sleeps per the armed schedule otherwise.  Call it at the top of the
    operation the point names."""
    if not _active:
        return
    with _lock:
        f = _armed.get(point)
        if f is None or f.mode == "corrupt":
            return  # corrupt mode only acts through corrupt()
        hit = f.decide_locked()
        mode = f.mode
        delay = f.delay_ms if (hit and mode == "latency") else 0.0
    if not hit:
        return
    if mode == "latency":
        time.sleep(delay / 1000.0)
        return
    if point == "hostpool.worker":
        raise WorkerDeath(f"injected worker death at {point}")
    raise InjectedFault(f"injected fault at {point}")


def should_drop(point: str) -> bool:
    """Non-raising schedule check for lost-write style faults (lru.put):
    True means the caller must silently drop the operation, exactly like
    a write that never landed."""
    if not _active:
        return False
    with _lock:
        f = _armed.get(point)
        if f is None:
            return False
        return f.decide_locked()


def corrupt(point: str, data: bytes) -> bytes:
    """Pass ``data`` through the point's corrupt schedule: identity when
    disarmed or when the schedule says no, one deterministic bit-flip
    otherwise."""
    if not _active:
        return data
    with _lock:
        f = _armed.get(point)
        if f is None or f.mode != "corrupt":
            return data
        if not f.decide_locked():
            return data
        return f.corrupt_locked(data)


# ---------------------------------------------------------------------------
# swallowed-exception / degradation telemetry
# ---------------------------------------------------------------------------


def note(point: str, exc: BaseException) -> None:
    """Record an exception a background/pooled thread deliberately
    survives.  The audit-sweep contract (celint R5): a worker may keep
    its loop alive, but the failure must land in telemetry under a named
    point — never vanish in ``except Exception: pass``."""
    r = repr(exc)[:200]
    with _lock:
        entry = _notes.get(point)
        if entry is None:
            _notes[point] = [1, r]
        else:
            entry[0] += 1
            entry[1] = r
    # the swallow also lands on the active trace as an instant event so
    # a trace reader sees WHERE in the block the failure was absorbed
    # (guarded: with tracing off this must stay one enabled() check,
    # and it runs outside the lock on purpose)
    from celestia_tpu_torch.utils import tracing

    if tracing.enabled():
        tracing.instant("fault.note", cat="fault", point=point, error=r[:120])


def record_degradation(subsystem: str, reason: str) -> None:
    """Log a one-way degradation event (native poison, pool respawn) so
    operators see WHEN the node stepped down a rung, not just that it is
    slow now."""
    with _lock:
        _degradations.append({"subsystem": subsystem, "reason": reason[:300]})
    from celestia_tpu_torch.utils import tracing

    if tracing.enabled():
        tracing.instant(
            "degradation", cat="fault", subsystem=subsystem,
            reason=reason[:160],
        )


def fault_stats() -> dict:
    """Aggregate injection/recovery view for bench.py and the chaos
    suite: per-point schedules + counters, swallow notes, degradations."""
    with _lock:
        return {
            "armed": {p: f.spec() for p, f in _armed.items()},
            "notes": {k: {"count": v[0], "last": v[1]} for k, v in _notes.items()},
            "degradations": list(_degradations),
        }


def decision_trace(point: str) -> List[bool]:
    """The armed point's per-check decision sequence so far (chaos suite
    determinism assertions: same seed => same trace)."""
    with _lock:
        f = _armed.get(point)
        return list(f.decisions) if f is not None else []


def reset_stats() -> None:
    with _lock:
        _notes.clear()
        _degradations.clear()


# ---------------------------------------------------------------------------
# RetryPolicy: the ONE retry/backoff implementation
# ---------------------------------------------------------------------------

# default-seed derivation for policies constructed without seed=: each
# instance must get a DISTINCT backoff sequence (N clients shed by one
# saturated server must not sleep identically and return as one stampede)
_policy_counter = itertools.count()
_proc_nonce: Optional[int] = None
_proc_nonce_lock = threading.Lock()


def _default_policy_seed() -> int:
    """Per-instance default seed.  Under an explicit chaos seed
    (CELESTIA_TPU_TORCH_CHAOS_SEED) the sequence of constructed policies is
    fully reproducible (seed x construction index); without one —
    production — a per-process entropy nonce is mixed in so independent
    clients jitter independently instead of in lockstep."""
    global _proc_nonce
    n = next(_policy_counter)
    if os.environ.get(_SEED_ENV, "").strip():
        return derive_seed(chaos_seed(), "retry", n)
    with _proc_nonce_lock:
        if _proc_nonce is None:
            _proc_nonce = int.from_bytes(os.urandom(8), "big")
        return derive_seed(_proc_nonce, "retry", n)


class RetryPolicy:
    """Bounded retry with decorrelated-jitter backoff and a deadline
    budget, from a SEEDED generator.

    * backoff: ``sleep_n = min(cap_s, uniform(base_s, sleep_{n-1} * 3))``
      — decorrelated jitter spreads retry storms without synchronizing
      clients the way exponential-with-full-jitter resets do.
    * seeding: an explicit ``seed=`` (or a set CELESTIA_TPU_TORCH_CHAOS_SEED)
      makes the sequence reproducible; otherwise each instance mixes a
      per-process entropy nonce so independent clients never jitter in
      lockstep (see :func:`_default_policy_seed`).
    * ``deadline_s`` is a hard budget over the whole run/poll, including
      sleeps: a retry that cannot finish before the deadline is not
      attempted.
    * ``sleep``/``clock`` are injectable for tests (virtual time).
    """

    def __init__(
        self,
        *,
        attempts: int = 4,
        base_s: float = 0.05,
        cap_s: float = 2.0,
        deadline_s: Optional[float] = None,
        seed: Optional[int] = None,
        sleep: Optional[Callable[[float], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.deadline_s = deadline_s
        self._rng = random.Random(
            derive_seed(seed, "retry")
            if seed is not None
            else _default_policy_seed()
        )
        self._sleep = sleep if sleep is not None else time.sleep
        self._clock = clock if clock is not None else time.monotonic

    def backoffs(self) -> Iterator[float]:
        """The (deterministic, seeded) backoff sequence."""
        prev = self.base_s
        while True:
            prev = min(self.cap_s, self._rng.uniform(self.base_s, prev * 3))
            yield prev

    def run(
        self,
        fn: Callable[[], Any],
        *,
        retry_on: Tuple[type, ...] = (Exception,),
        no_retry_on: Tuple[type, ...] = (),
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ) -> Any:
        """Call ``fn`` up to ``attempts`` times within the deadline.

        Retries only on ``retry_on`` (``no_retry_on`` carves exceptions
        back out — e.g. a resource-bound violation subclassing a
        retriable base is hostile, not transient); an :class:`Overloaded`
        failure's ``retry_after_ms`` floors the next sleep (server
        pushback wins over local jitter).  The last failure re-raises
        unchanged."""
        start = self._clock()
        backoff = self.backoffs()
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except no_retry_on:
                raise
            except retry_on as e:
                delay = next(backoff)
                floor = getattr(e, "retry_after_ms", None)
                if floor is not None:
                    delay = max(delay, float(floor) / 1000.0)
                out_of_time = self.deadline_s is not None and (
                    self._clock() - start + delay >= self.deadline_s
                )
                if attempt >= self.attempts or out_of_time:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def poll(
        self,
        predicate: Callable[[], Any],
        *,
        what: str = "condition",
    ) -> Any:
        """Sleep-poll ``predicate`` until it returns a truthy value and
        return that value; :class:`TimeoutError` at the deadline (which
        is REQUIRED here — an unbounded poll is exactly the hand-rolled
        loop this class exists to retire).  Attempts are not counted:
        polling is bounded by time, not tries."""
        if self.deadline_s is None:
            raise ValueError("poll() requires deadline_s")
        start = self._clock()
        while True:
            value = predicate()
            if value:
                return value
            elapsed = self._clock() - start
            if elapsed >= self.deadline_s:
                raise TimeoutError(
                    f"{what} not reached within {self.deadline_s:.1f}s"
                )
            # jittered base-interval sleeps, clipped to the budget
            delay = min(
                self._rng.uniform(self.base_s, self.base_s * 2),
                self.cap_s,
                max(0.0, self.deadline_s - elapsed),
            )
            self._sleep(delay)


# ---------------------------------------------------------------------------
# circuit breakers (per-peer failure gating)
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """closed -> open after N consecutive failures -> half-open probe
    after the cooldown.  One success closes; a failed probe re-opens."""

    def __init__(
        self,
        *,
        failures_to_open: int = 3,
        cooldown_s: float = 10.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.failures_to_open = int(failures_to_open)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._failures = 0  # celint: guarded-by(self._lock)
        self._open_until = 0.0  # celint: guarded-by(self._lock)
        self._probing = False  # celint: guarded-by(self._lock)

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the one half-open
        probe after cooldown)."""
        with self._lock:
            if self._failures < self.failures_to_open:
                return True
            if self._clock() < self._open_until:
                return False
            if self._probing:
                return False  # one probe at a time
            self._probing = True
            return True

    def record_ok(self) -> None:
        with self._lock:
            self._failures = 0
            self._open_until = 0.0
            self._probing = False

    def record_failure(self, cooldown_s: Optional[float] = None) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.failures_to_open:
                self._open_until = self._clock() + (
                    self.cooldown_s if cooldown_s is None else float(cooldown_s)
                )

    def trip(self, cooldown_s: Optional[float] = None) -> None:
        """Open immediately (resource-bound violations: no honest peer
        trips these, so don't wait for the failure budget)."""
        with self._lock:
            self._failures = max(self._failures + 1, self.failures_to_open)
            self._probing = False
            self._open_until = self._clock() + (
                self.cooldown_s if cooldown_s is None else float(cooldown_s)
            )

    @property
    def state(self) -> str:
        with self._lock:
            if self._failures < self.failures_to_open:
                return "closed"
            return "open" if self._clock() < self._open_until else "half-open"

    def cooldown_remaining(self) -> float:
        with self._lock:
            return max(0.0, self._open_until - self._clock())


class BreakerRegistry:
    """Keyed circuit breakers (one per peer address) behind one lock —
    the per-peer gating layer node/gossip.py's catch-up/state-sync pulls
    route through instead of hand-rolled cooldown dicts."""

    def __init__(self, **breaker_kwargs):
        self._kwargs = breaker_kwargs
        self._lock = threading.Lock()
        # key -> breaker; celint: guarded-by(self._lock)
        self._breakers: Dict[Any, CircuitBreaker] = {}

    def _get(self, key) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(**self._kwargs)
                self._breakers[key] = b
            return b

    def allow(self, key) -> bool:
        return self._get(key).allow()

    def available(self, key) -> bool:
        """Side-effect-free view: True unless the breaker is open.  Use
        for building candidate lists; ``allow`` (which claims the single
        half-open probe) gates the actual call."""
        return self._get(key).state != "open"

    def record_ok(self, key) -> None:
        self._get(key).record_ok()

    def record_failure(self, key, cooldown_s: Optional[float] = None) -> None:
        self._get(key).record_failure(cooldown_s)

    def trip(self, key, cooldown_s: Optional[float] = None) -> None:
        self._get(key).trip(cooldown_s)

    def cooldown_remaining(self, key) -> float:
        return self._get(key).cooldown_remaining()

    def drop(self, key) -> None:
        with self._lock:
            self._breakers.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
        return {str(k): b.state for k, b in items}


# ---------------------------------------------------------------------------
# load shedding (bounded-concurrency admission for serving planes)
# ---------------------------------------------------------------------------


class LoadShedGate:
    """Admit up to ``max_inflight`` concurrent units of work; shed the
    rest with a retry-after hint instead of queueing unboundedly.
    Shedding keeps the served requests fast (bounded queue => bounded
    latency) and gives honest clients an explicit, retriable signal —
    the serving plane degrades, it does not collapse.

    Admission is WEIGHTED: a batch request passes its work size (the
    DAS batch plane weighs a chunk by the distinct rows it proves), so
    batching cannot launder n requests' load past a gate sized for
    single-cell traffic.  An oversize weight (> ``max_inflight``) is
    admitted only when the gate is fully idle — bounded overshoot beats
    a request class that can never be served.

    QoS LANES (opt-in): pass ``lanes`` as a sequence of
    ``(name, reserved)`` pairs (or a mapping name -> reserved) to split
    ``max_inflight`` into per-lane reserved capacity plus one shared
    pool (``max_inflight - sum(reserved)``).  A lane's inflight up to
    its reservation never touches the shared pool, so a flood on a
    zero-reserved lane (``bulk``/``hostile``) can saturate only the
    shared pool and can never starve a reserved lane's admissions.
    Per-lane admitted/shed/inflight are tracked alongside the global
    counters.  With ``lanes=None`` (the default) the gate runs the
    original single-lane code path unchanged — the weighted single-gate
    behavior IS the degenerate one-lane case."""

    def __init__(
        self,
        max_inflight: int = 8,
        retry_after_ms: float = 25.0,
        lanes: Optional[Any] = None,
    ):
        self.max_inflight = max(1, int(max_inflight))
        self.retry_after_ms = float(retry_after_ms)
        self._lock = threading.Lock()
        self._inflight = 0  # celint: guarded-by(self._lock)
        self.admitted = 0  # celint: guarded-by(self._lock)
        self.shed = 0  # celint: guarded-by(self._lock)
        self._lanes: Optional[Dict[str, Dict[str, int]]] = None
        self._shared_capacity = 0
        self._shared_used = 0  # celint: guarded-by(self._lock)
        self._default_lane: Optional[str] = None
        if lanes is not None:
            pairs = list(lanes.items()) if hasattr(lanes, "items") else list(lanes)
            if not pairs:
                raise ValueError("lanes must name at least one lane")
            table: Dict[str, Dict[str, int]] = {}
            for name, reserved in pairs:
                name = str(name)
                if name in table:
                    raise ValueError(f"duplicate lane {name!r}")
                # inflight/admitted/shed counters are mutated only
                # under self._lock (same discipline as the gate totals)
                table[name] = {
                    "reserved": max(0, int(reserved)),
                    "inflight": 0,
                    "admitted": 0,
                    "shed": 0,
                }
            total_reserved = sum(st["reserved"] for st in table.values())
            if total_reserved > self.max_inflight:
                raise ValueError(
                    f"reserved capacity {total_reserved} exceeds "
                    f"max_inflight {self.max_inflight}"
                )
            self._lanes = table
            self._shared_capacity = self.max_inflight - total_reserved
            self._default_lane = next(iter(table))

    def _lane_state(self, lane: Optional[str]) -> Dict[str, int]:
        # caller holds self._lock; unknown lane names fall back to the
        # first-declared lane so a stale client label cannot crash serving
        assert self._lanes is not None
        st = self._lanes.get(lane) if lane is not None else None
        if st is None:
            st = self._lanes[self._default_lane]
        return st

    def try_acquire(self, weight: int = 1, lane: Optional[str] = None) -> bool:
        weight = max(1, int(weight))
        with self._lock:
            if self._lanes is None:
                if self._inflight > 0 and (
                    self._inflight + weight > self.max_inflight
                ):
                    self.shed += 1
                    return False
                self._inflight += weight
                self.admitted += 1
                return True
            st = self._lane_state(lane)
            cur = st["inflight"]
            old_excess = max(0, cur - st["reserved"])
            new_excess = max(0, cur + weight - st["reserved"])
            over_shared = (
                self._shared_used - old_excess + new_excess
                > self._shared_capacity
            )
            # global-idle oversize admission is preserved lane-wise: a
            # weight larger than the whole gate is admitted only when
            # NOTHING is inflight anywhere (bounded overshoot, as above)
            if self._inflight > 0 and over_shared:
                self.shed += 1
                st["shed"] += 1
                return False
            st["inflight"] = cur + weight
            st["admitted"] += 1
            self._shared_used += new_excess - old_excess
            self._inflight += weight
            self.admitted += 1
            return True

    def release(self, weight: int = 1, lane: Optional[str] = None) -> None:
        weight = max(1, int(weight))
        with self._lock:
            if self._lanes is None:
                self._inflight = max(0, self._inflight - weight)
                return
            st = self._lane_state(lane)
            cur = st["inflight"]
            take = min(cur, weight)
            old_excess = max(0, cur - st["reserved"])
            new_excess = max(0, cur - take - st["reserved"])
            st["inflight"] = cur - take
            self._shared_used = max(
                0, self._shared_used - (old_excess - new_excess)
            )
            self._inflight = max(0, self._inflight - take)

    def stats(self) -> dict:
        with self._lock:
            out = {
                "max_inflight": self.max_inflight,
                "inflight": self._inflight,
                "admitted": self.admitted,
                "shed": self.shed,
            }
            if self._lanes is not None:
                out["shared_capacity"] = self._shared_capacity
                out["shared_inflight"] = self._shared_used
                out["lanes"] = {
                    name: dict(st) for name, st in self._lanes.items()
                }
            return out


# ---------------------------------------------------------------------------
# QoS tier assignment (deterministic peer -> lane policy)
# ---------------------------------------------------------------------------


class TierPolicy:
    """Deterministic peer -> QoS lane assignment for a laned
    :class:`LoadShedGate`.

    Default policy is RECENT-USAGE DEMOTION: each peer's asked rows are
    counted in a two-bucket sliding window (current + previous epoch of
    ``window_s`` seconds, rotated on an injectable clock, so the signal
    is deterministic under a virtual clock and needs no timers).  A peer
    whose recent asked-rows reach ``demote_rows`` slides from ``light``
    to ``bulk``; reaching ``hostile_rows`` auto-pins it to ``hostile``
    for ``pin_cooldown_s`` (and :meth:`pin` applies the same
    :meth:`CircuitBreaker.trip`-style pinning manually).  Per-peer state
    lives on a bounded :class:`~celestia_tpu_torch.utils.lru.LruCache`, so an
    open swarm cannot grow server memory without bound — an evicted
    peer simply restarts as ``light``.
    """

    LIGHT = "light"
    BULK = "bulk"
    HOSTILE = "hostile"
    LANES = (LIGHT, BULK, HOSTILE)

    def __init__(
        self,
        demote_rows: int = 64,
        hostile_rows: int = 256,
        window_s: float = 2.0,
        pin_cooldown_s: float = 30.0,
        max_peers: int = 1024,
        clock: Optional[Callable[[], float]] = None,
    ):
        from celestia_tpu_torch.utils.lru import LruCache

        self.demote_rows = max(1, int(demote_rows))
        self.hostile_rows = max(self.demote_rows, int(hostile_rows))
        self.window_s = max(1e-6, float(window_s))
        self.pin_cooldown_s = max(0.0, float(pin_cooldown_s))
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # entries are mutable dicts mutated only under self._lock
        self._usage = LruCache("qos_peer_usage", max_entries=max(1, int(max_peers)))
        self.pins = 0  # celint: guarded-by(self._lock)

    def _entry(self, peer: str) -> Dict[str, float]:
        # caller holds self._lock
        st = self._usage.get(peer, count=False)
        if st is None:
            st = {"epoch": -1, "cur": 0.0, "prev": 0.0, "pin_until": 0.0}
            self._usage.put(peer, st)
        return st

    def _rotate(self, st: Dict[str, float], epoch: int) -> None:
        # caller holds self._lock
        if epoch == st["epoch"]:
            return
        if epoch == st["epoch"] + 1:
            st["prev"] = st["cur"]
        else:
            st["prev"] = 0.0
        st["cur"] = 0.0
        st["epoch"] = epoch

    def note(self, peer: str, rows: int = 1) -> None:
        """Record ``rows`` of asked work for ``peer`` (asked, not served
        — demotion must see the load a shed over-asker keeps offering)."""
        if not peer:
            return
        with self._lock:
            now = self._clock()
            st = self._entry(peer)
            self._rotate(st, int(now / self.window_s))
            st["cur"] += max(0, int(rows))
            if (
                st["cur"] + st["prev"] >= self.hostile_rows
                and now >= st["pin_until"]
            ):
                st["pin_until"] = now + self.pin_cooldown_s
                self.pins += 1

    def pin(self, peer: str, cooldown_s: Optional[float] = None) -> None:
        """Pin ``peer`` to the hostile lane for ``cooldown_s`` (default
        ``pin_cooldown_s``) — the trip()-style manual override."""
        if not peer:
            return
        with self._lock:
            st = self._entry(peer)
            hold = self.pin_cooldown_s if cooldown_s is None else float(cooldown_s)
            st["pin_until"] = self._clock() + max(0.0, hold)
            self.pins += 1

    def lane_for(self, peer: str) -> str:
        """Deterministic lane for ``peer`` right now.  Unknown / empty
        peers are ``light`` — anonymity costs nothing until usage does."""
        if not peer:
            return self.LIGHT
        with self._lock:
            st = self._usage.get(peer, count=False)
            if st is None:
                return self.LIGHT
            now = self._clock()
            if now < st["pin_until"]:
                return self.HOSTILE
            self._rotate(st, int(now / self.window_s))
            recent = st["cur"] + st["prev"]
            if recent >= self.hostile_rows:
                return self.HOSTILE
            if recent >= self.demote_rows:
                return self.BULK
            return self.LIGHT

    def stats(self) -> dict:
        with self._lock:
            return {
                "peers": self._usage.stats()["entries"],
                "pins": self.pins,
                "demote_rows": self.demote_rows,
                "hostile_rows": self.hostile_rows,
                "window_s": self.window_s,
            }


# arm from the environment at import: a chaos-configured process needs no
# code changes, and a bad spec fails the process loudly at startup
arm_from_env()
