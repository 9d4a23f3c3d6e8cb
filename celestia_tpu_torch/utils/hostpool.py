"""Process-wide host worker pool for the CPU DA pipeline.

Every host-side leg of the DA path (native NMT/SHA hashing, the Leopard
erasure decode, the pure-Python fallbacks) fans out over ONE shared pool
so the node never oversubscribes the machine: N subsystems each spawning
``os.cpu_count()`` threads would thrash; one pool sized once does not.

Thread-count resolution order (first match wins):

1. an explicit :func:`set_cpu_threads` call (the ``--cpu-threads`` CLI
   flag routes here);
2. the ``CELESTIA_TPU_TORCH_CPU_THREADS`` environment variable;
3. ``os.cpu_count()``.

The native C++ entry points take the resolved count as an ``nthreads``
argument (they spawn their own short-lived ``std::thread`` teams — cheap
relative to the multi-ms work items); the :class:`ThreadPoolExecutor`
from :func:`get_pool` serves the pure-Python legs, where hashlib/numpy
release the GIL.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional

_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_override: Optional[int] = None
_respawns = 0  # pools rebuilt after an observed worker death


def set_cpu_threads(n: Optional[int]) -> None:
    """Pin the pool size (``--cpu-threads``); ``None`` clears the pin.

    Takes effect for every subsequent :func:`cpu_threads` /
    :func:`get_pool` call; an existing pool is rebuilt lazily."""
    global _override
    if n is not None and n < 1:
        raise ValueError(f"cpu threads must be >= 1, got {n}")
    with _lock:
        _override = n


def cpu_threads() -> int:
    """The host worker count every CPU DA leg should use."""
    with _lock:
        if _override is not None:
            return _override
    env = os.environ.get("CELESTIA_TPU_TORCH_CPU_THREADS", "").strip()
    if env:
        try:
            n = int(env)
            if n >= 1:
                return n
        except ValueError:
            pass  # malformed env var: fall through to the default
    return os.cpu_count() or 1


def get_pool() -> ThreadPoolExecutor:
    """The shared executor, (re)built to the current cpu_threads()."""
    global _pool, _pool_size
    n = cpu_threads()
    with _lock:
        if _pool is None or _pool_size != n:
            # the replaced executor is NOT shut down: a concurrent caller
            # may hold it between its get_pool() and .map(), and
            # scheduling on a shut-down executor raises.  It simply
            # drains and idles — a resize is a rare config-time event,
            # and parked workers cost nothing.
            _pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="celestia-host"
            )
            _pool_size = n
        return _pool


def heal_pool() -> None:
    """Drop the executor after an observed worker death so the next
    :func:`get_pool` builds a fresh one.  The broken executor is not
    shut down (other callers may hold it mid-map; its surviving workers
    drain and idle) — the point is that NEW work lands on healthy
    threads."""
    global _pool, _pool_size, _respawns
    with _lock:
        _pool = None
        _pool_size = 0
        _respawns += 1


def stats() -> dict:
    with _lock:
        return {"pool_size": _pool_size, "respawns": _respawns}


def run_sharded(fn: Callable, items: Iterable) -> List:
    """Map ``fn`` over ``items`` on the shared pool, preserving order.

    Runs inline for a single worker or a single item (no pool overhead,
    and results stay deterministic either way — callers rely on the
    threaded path being byte-identical to the serial one).  The first
    worker exception propagates to the submitter (celint R5: pooled work
    never fails silently).

    Worker-death recovery: a :class:`faults.WorkerDeath` (the
    hostpool.worker fault point — the observable stand-in for a worker
    thread dying) marks the pool for rebuild and the lost items re-run
    inline, so a dead worker costs latency, never results.

    Tracing: when the block-lifecycle tracer is enabled AND the caller
    sits inside a span, every item gets a ``hostpool.queue_wait`` span
    (submit -> pick-up: the time the item sat behind other work — the
    visible form of a pipeline tail) and a ``hostpool.task`` run span,
    both parented to the SUBMITTING thread's span (contextvars do not
    cross pool threads; the parent is captured here explicitly)."""
    from celestia_tpu_torch.utils import faults, tracing

    items = list(items)
    if cpu_threads() <= 1 or len(items) <= 1:
        return [fn(x) for x in items]

    parent = tracing.current()  # None when disabled or outside any span
    if parent is not None:
        from celestia_tpu_torch.utils.telemetry import clock as _clock

        # queue-wait spans live on the SUBMITTER's track: they start at
        # submit time, and stamping the worker's tid would overlap that
        # worker's own run spans from earlier items
        submitter = threading.current_thread()
        sub_tid, sub_name = submitter.ident or 0, submitter.name

        def _submit(i, x):
            t_submit = _clock()

            def _traced():
                tracing.record_span(
                    "hostpool.queue_wait", t_submit, _clock(),
                    parent=parent, cat="hostpool", index=i,
                    tid=sub_tid, thread_name=sub_name,
                    # waits overlap each other on the submitter's track
                    # (shared submit instant, staggered pick-ups):
                    # async b/e export is the format's overlap mechanism
                    render_async=True,
                )
                with tracing.span(
                    "hostpool.task", parent=parent, cat="hostpool", index=i
                ):
                    faults.fire("hostpool.worker")
                    return fn(x)

            return get_pool().submit(_traced)

        futures = [_submit(i, x) for i, x in enumerate(items)]
    else:
        def _guarded(x):
            faults.fire("hostpool.worker")
            return fn(x)

        futures = [get_pool().submit(_guarded, x) for x in items]
    out: List = []
    lost: List[int] = []
    for i, fut in enumerate(futures):
        try:
            out.append(fut.result())
        except faults.WorkerDeath as e:
            faults.note("hostpool.worker", e)
            out.append(None)
            lost.append(i)
    if lost:
        heal_pool()  # queued work on the old pool still drains
        for i in lost:
            out[i] = fn(items[i])  # the item is never lost
    return out
