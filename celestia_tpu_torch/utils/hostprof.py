"""Continuous host profiling: wall-clock stack sampling over all threads.

The observability plane sees every *instrumented* span (utils/tracing.py),
every device dispatch (utils/devprof.py) and every periodic snapshot
(utils/timeseries.py) — but the host CPU between spans is a black box:
bench's ``trace_summary`` pins real ``untraced_ms`` tails (the phase-3
column-root tail, inter-phase glue, the ingress filter leg) that no span
names.  This module closes that gap with a sampling profiler in the same
bounded-structure, zero-overhead-disarmed idiom as the rest of the plane:

* **Wall-clock sampling.**  A single daemon thread wakes at a
  configurable rate (``--host-profile [HZ]`` / ``CELESTIA_TPU_TORCH_HOST_PROFILE``,
  default :data:`DEFAULT_HZ`), snapshots ``sys._current_frames()`` and
  records one bounded stack per live thread.  No signals, no tracing
  hooks — the profiled code pays nothing per call; the only cost is the
  sampler's own tick, which is measured and reported as
  ``overhead_pct`` (bench + ``tools/bench_check.py`` alarm at >2%).
* **Span attribution.**  Each sample is joined to the sampled thread's
  ACTIVE span via :func:`tracing.thread_span` (the tid -> span registry
  the span tracer maintains), so a busy hostpool worker's frames land
  under its ``hostpool.task`` span and an ``untraced_ms`` figure
  decomposes into named frames.  Thread NAMES ride along too — hostpool
  workers (``celestia-host-*``), gossip/BFT pumps, the timeseries
  sampler and the block producer are attributed by name, not by bare
  tid.
* **Two exports.**  (1) *Folded stacks* — ``thread;[span:name;]f1;f2 N``
  lines, directly consumable by any flamegraph tool — aggregated into a
  bounded map (:data:`MAX_FOLDED` distinct stacks + an overflow
  counter).  (2) *Chrome-trace sample events* — ``ph:"i"``/``cat:"sample"``
  instants on the SAME per-thread Perfetto tracks the span tracer uses
  (:func:`merged_trace_dump`), so frames line up with spans on ONE
  timeline.
* **Bounded, zero overhead disarmed.**  Raw samples live in a
  ``deque(maxlen=MAX_SAMPLES)``; disarmed, every public entry is one
  module-bool check and the sampler thread does not exist
  (tests/test_hostprof.py pins the disarmed cost, same style as
  tracing's).

celint R3: this module is on the SANCTIONED_CHANNELS list — its clock
reads go through :func:`telemetry.clock` and the entropy bans still
apply inside it (a sampler seeded from ``random`` would launder
nondeterminism through the one open door).
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Dict, List, Optional

from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.telemetry import clock

ENV_FLAG = "CELESTIA_TPU_TORCH_HOST_PROFILE"

# default sampling rate: high enough to catch a multi-ms tail inside one
# block, low enough that the measured tick cost stays well under the 2%
# overhead alarm.  A non-round number avoids lockstep with 10 ms timer
# beats (a sampler phase-locked to the work it measures sees aliases,
# not a profile).
DEFAULT_HZ = 67.0
MAX_HZ = 1000.0

MAX_SAMPLES = 4096   # raw sample ring (Chrome-event export window)
MAX_FOLDED = 8192    # distinct folded stacks kept (overflow counted)
MAX_STACK_DEPTH = 48

_lock = threading.Lock()
_enabled = False
_hz = DEFAULT_HZ
# raw recent samples (dicts; see sample_once); celint: guarded-by(_lock)
_samples: "deque[dict]" = deque(maxlen=MAX_SAMPLES)
# folded stack -> count, bounded with an overflow counter (same
# bounded-accumulator shape as devprof's kernel table);
# celint: guarded-by(_lock)
_folded: Dict[str, int] = {}
_folded_dropped = 0  # celint: guarded-by(_lock)
_samples_total = 0   # lifetime per-thread samples; celint: guarded-by(_lock)
_ticks_total = 0     # sampler wake-ups; celint: guarded-by(_lock)
_sampling_s = 0.0    # cumulative time spent INSIDE ticks; celint: guarded-by(_lock)
_window_t0 = 0.0     # armed-window start; celint: guarded-by(_lock)
_window_t1: Optional[float] = None  # window end (stop()); celint: guarded-by(_lock)
_thread: Optional[threading.Thread] = None
_sampler_tid: Optional[int] = None  # the loop thread's own ident
_stop = threading.Event()


def enabled() -> bool:
    return _enabled


def hz() -> float:
    return _hz


def _frame_stack(frame) -> List[str]:
    """Root-first ``module.func`` frames of one thread, bounded depth.
    Module is the file's basename (no .py): short enough to fold, unique
    enough to read.  A deeper-than-cap stack keeps its LEAF end (the
    code actually on-CPU) and drops the root."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < MAX_STACK_DEPTH:
        code = f.f_code
        mod = code.co_filename.rsplit("/", 1)[-1]
        if mod.endswith(".py"):
            mod = mod[:-3]
        out.append(f"{mod}.{code.co_name}")
        f = f.f_back
    out.reverse()
    return out


def sample_once() -> int:
    """Take ONE sample of every live thread (the sampler tick; public so
    tests and bench drive it deterministically).  Returns the number of
    per-thread samples recorded.  No-op disarmed."""
    global _samples_total, _ticks_total, _sampling_s, _folded_dropped
    if not _enabled:
        return 0
    t0 = clock()
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    recorded = 0
    new: List[dict] = []
    folds: List[str] = []
    for tid, frame in frames.items():
        if tid == _sampler_tid:
            continue  # the sampler thread never profiles itself (a
            # DIRECT sample_once() caller — tests, bench — is real work
            # and IS profiled)
        stack = _frame_stack(frame)
        if not stack:
            continue
        tname = names.get(tid, f"thread-{tid}")
        sp = tracing.thread_span(tid)
        entry = {
            "ts": t0,
            "tid": tid,
            "thread": tname,
            "stack": stack,
            "span_id": sp.span_id if sp is not None else 0,
            "span": sp.name if sp is not None else "",
        }
        # folded key: thread name, then the active span (so untraced
        # time decomposes UNDER the span that owns it), then frames
        parts = [tname]
        if sp is not None:
            parts.append(f"span:{sp.name}")
        parts.extend(stack)
        folds.append(";".join(parts))
        new.append(entry)
        recorded += 1
    dt = clock() - t0
    with _lock:
        _samples.extend(new)
        for key in folds:
            if key in _folded:
                _folded[key] += 1
            elif len(_folded) < MAX_FOLDED:
                _folded[key] = 1
            else:
                _folded_dropped += 1
        _samples_total += recorded
        _ticks_total += 1
        _sampling_s += max(0.0, dt)
    return recorded


def _loop() -> None:
    # Event.wait paces the cadence (no sleep-in-loop, celint R5); a
    # sampler tick can never raise — sys._current_frames returns plain
    # frames and the fold path is pure dict work — but the loop still
    # guards via faults.note so a future collector bug degrades the
    # profile, never kills the thread.
    global _sampler_tid

    from celestia_tpu_torch.utils import faults

    _sampler_tid = threading.get_ident()
    interval = 1.0 / max(0.001, _hz)
    while not _stop.wait(interval):
        try:
            sample_once()
        except Exception as e:  # pragma: no cover - defensive
            faults.note("hostprof.tick", e)


def start(hz: Optional[float] = None) -> None:
    """Arm the sampler (idempotent; a new rate restarts the thread).
    ``hz`` is clamped to (0, MAX_HZ]."""
    global _enabled, _hz, _thread, _window_t0, _window_t1
    with _lock:
        rate = float(hz) if hz else DEFAULT_HZ
        rate = min(MAX_HZ, max(0.1, rate))
        if _enabled and _thread is not None and rate == _hz:
            return
        _hz = rate
    stop()
    with _lock:
        _enabled = True
        _window_t0 = clock()
        _window_t1 = None
    _stop.clear()
    t = threading.Thread(target=_loop, name="hostprof-sampler", daemon=True)
    _thread = t
    t.start()


def stop() -> None:
    """Disarm the sampler and join its thread.  Recorded samples stay
    readable (a flight bundle dumps them after the incident)."""
    global _enabled, _thread, _window_t1
    was_enabled = _enabled
    _enabled = False
    _stop.set()
    t = _thread
    _thread = None
    if t is not None and t.is_alive():
        t.join(timeout=5)
    _stop.clear()
    if was_enabled:
        with _lock:
            # freeze the overhead window: stats() read after stop must
            # report sampling cost over the ARMED wall, not dilute as
            # idle time accrues
            _window_t1 = clock()


def clear() -> None:
    """Drop all recorded samples + accounting (tests, bench legs)."""
    global _folded_dropped, _samples_total, _ticks_total, _sampling_s
    global _window_t0, _window_t1
    with _lock:
        _samples.clear()
        _folded.clear()
        _folded_dropped = 0
        _samples_total = 0
        _ticks_total = 0
        _sampling_s = 0.0
        _window_t0 = clock()
        _window_t1 = None


def stats() -> dict:
    """Sampler accounting: rates and the measured self-overhead (the
    figure bench records and tools/bench_check.py alarms on >2%)."""
    with _lock:
        end = _window_t1 if _window_t1 is not None else clock()
        window_s = max(0.0, end - _window_t0) if _window_t0 else 0.0
        return {
            "enabled": _enabled,
            "hz": _hz,
            "samples_total": _samples_total,
            "samples_kept": len(_samples),
            "ticks": _ticks_total,
            "folded_unique": len(_folded),
            "folded_dropped": _folded_dropped,
            "sampling_ms_total": round(_sampling_s * 1000.0, 3),
            "window_s": round(window_s, 3),
            "samples_per_s": (
                round(_samples_total / window_s, 1) if window_s > 0 else 0.0
            ),
            "overhead_pct": (
                round(100.0 * _sampling_s / window_s, 3)
                if window_s > 0
                else 0.0
            ),
        }


def samples(last: Optional[int] = None) -> List[dict]:
    with _lock:
        out = list(_samples)
    if last is not None:
        out = out[-max(0, int(last)):]
    return out


def folded_stacks() -> Dict[str, int]:
    """folded-stack -> sample count (flamegraph input as a dict)."""
    with _lock:
        return dict(_folded)


def folded_text(top: Optional[int] = None) -> str:
    """The classic folded format — one ``stack count`` line per distinct
    stack, count-descending — ``flamegraph.pl``/speedscope-ready and the
    ``stacks.folded`` artifact of a flight bundle."""
    items = sorted(
        folded_stacks().items(), key=lambda kv: (-kv[1], kv[0])
    )
    if top is not None:
        items = items[: max(0, int(top))]
    return "\n".join(f"{stack} {count}" for stack, count in items) + (
        "\n" if items else ""
    )


def top_frames(n: int = 10) -> List[dict]:
    """Self-time ranking: the LEAF frame of each sample is where the CPU
    actually was; counts aggregate per leaf across threads."""
    leaf: Dict[str, int] = {}
    total = 0
    with _lock:
        for key, count in _folded.items():
            leaf_frame = key.rsplit(";", 1)[-1]
            leaf[leaf_frame] = leaf.get(leaf_frame, 0) + count
            total += count
    ranked = sorted(leaf.items(), key=lambda kv: (-kv[1], kv[0]))
    return [
        {
            "frame": frame,
            "samples": count,
            "pct": round(100.0 * count / total, 2) if total else 0.0,
        }
        for frame, count in ranked[: max(0, int(n))]
    ]


def chrome_events(last: Optional[int] = None) -> List[dict]:
    """The raw sample ring as Chrome trace instants (``cat="sample"``)
    on the sampled threads' OWN tracks — merged next to the span
    tracer's events they land on the same Perfetto timeline rows."""
    out: List[dict] = []
    for s in samples(last):
        args = {"stack": ";".join(s["stack"])}
        if s["span_id"]:
            args["span_id_sampled"] = s["span_id"]
            args["span"] = s["span"]
        out.append(
            {
                "ph": "i",
                "name": s["stack"][-1],
                "cat": "sample",
                "ts": round(s["ts"] * 1e6, 3),
                "pid": 1,
                "tid": s["tid"],
                "s": "t",
                "args": args,
            }
        )
    return out


def merged_trace_dump(last: Optional[int] = None) -> dict:
    """One Chrome trace document: the span tracer's dump PLUS this
    module's sample instants, with thread_name metadata for sampled
    threads the tracer never saw (gossip pumps, grpc workers) — open in
    Perfetto and frames line up with spans on one timeline."""
    dump = tracing.trace_dump(last)
    events = dump.get("traceEvents", [])
    named = {
        ev.get("tid")
        for ev in events
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    }
    nid = tracing.node_id()
    sample_events = chrome_events()
    if nid:
        sample_events = [
            dict(ev, args=dict(ev["args"], node_id=nid))
            for ev in sample_events
        ]
    meta: List[dict] = []
    seen: Dict[int, str] = {}
    for s in samples():
        seen.setdefault(s["tid"], s["thread"])
    for tid, tname in sorted(seen.items()):
        if tid not in named:
            meta.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
    dump["traceEvents"] = meta + events + sample_events
    dump.setdefault("otherData", {})["host_samples"] = len(sample_events)
    return dump


def exposition_lines() -> List[str]:
    """Prometheus lines for the metrics plane (zero lines disarmed with
    nothing recorded — absent means unknown, same contract as devprof)."""
    st = stats()
    if not st["enabled"] and st["samples_total"] == 0:
        return []
    return [
        "# TYPE celestia_tpu_hostprof_samples_total counter",
        f"celestia_tpu_hostprof_samples_total {st['samples_total']}",
        f"celestia_tpu_hostprof_enabled {1 if st['enabled'] else 0}",
        f"celestia_tpu_hostprof_hz {st['hz']}",
        f"celestia_tpu_hostprof_overhead_pct {st['overhead_pct']}",
    ]


def _arm_from_env() -> None:
    """CELESTIA_TPU_TORCH_HOST_PROFILE: truthy arms at the default rate, a
    number arms at that Hz, falsy/absent stays off — same contract as
    CELESTIA_TPU_TORCH_TRACE / CELESTIA_TPU_TORCH_DEVICE_PROFILE."""
    import os

    raw = os.environ.get(ENV_FLAG, "").strip().lower()
    if not raw or raw in ("0", "false", "no", "off"):
        return
    if raw in ("1", "true", "yes", "on"):
        start()
        return
    try:
        start(float(raw))
    except ValueError:
        start()


_arm_from_env()
