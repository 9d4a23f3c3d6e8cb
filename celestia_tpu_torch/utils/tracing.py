"""Block-lifecycle span tracing: where inside a block does the time go.

The telemetry layer (utils/telemetry.py) answers "how long do prepares
take on average"; it cannot answer "why was THIS prepare slow" — the
question every ROADMAP perf item (streaming proposer, the phase-3
column-root tail, the DAS serving plane) stalls on.  This module is the
per-height, per-phase structure: a thread-aware span tracer whose output
opens directly in Perfetto (chrome://tracing JSON), ring-buffered over
the last N blocks and exported over gRPC (node/server.py ``TraceDump``).

Design constraints, in order:

* **Near-zero overhead disabled.**  Every public entry checks one module
  bool first; ``span()`` returns a shared no-op context manager, and no
  clock is read, no object allocated, no lock taken.  The <50 ms
  PrepareProposal gate must not notice a disabled tracer.
* **Deterministic ids.**  Span ids come from one process-wide
  ``itertools.count`` — never ``random`` or wall-clock bits — so the
  tracer passes celint R3 (consensus-determinism: the sanctioned-channel
  list names this module) and two runs of the same block sequence
  produce structurally identical trees (tests/test_tracing.py pins it).
* **Thread-aware.**  Parent linkage rides a :mod:`contextvars` variable,
  which follows the logical call stack per thread; work fanned to the
  hostpool carries its parent EXPLICITLY (the submitting thread's
  current span), so per-task queue-wait + run spans nest under the phase
  that scheduled them and the phase-3 tail becomes a visible gap.
* **Bounded memory.**  Completed block traces live in a
  ``deque(maxlen=N)``; each block keeps at most ``MAX_SPANS_PER_BLOCK``
  spans (overflow is counted, never silently ignored); background spans
  (gossip rounds, DAS samples, snapshot chunk fetches — work that
  belongs to no block) live in their own bounded ring.

Clock: durations are measured through :func:`telemetry.clock` — the one
sanctioned wall-clock channel (celint R3) — and only ever feed
telemetry/trace output, never consensus bytes.

Cross-node tracing: the workload is inherently multi-node — one
block's causal chain is the proposer's prepare, every validator's
process, gossip dissemination and DAS serving, split across machines.
This module therefore also carries:

* a stable **node id** (:func:`set_node_id`; ``CELESTIA_TPU_TORCH_NODE_ID`` or
  the gRPC bind address) stamped onto every exported event, so merged
  timelines attribute spans/faults to the right machine;
* a compact **wire trace context** (:func:`wire_context` — origin node
  id, parent span id, height, send timestamp) that rides cross-node RPC
  envelopes as an optional ``"_tc"`` field old peers silently ignore;
  the receiving side opens an :func:`rpc_span` that records the remote
  parent EXPLICITLY (``remote_node``/``remote_span`` args — local span
  ids are per-process, so cross-node parentage is by (node, span) pair,
  resolved into Chrome flow events by ``tools/trace_merge.py``);
* a **clock-offset probe** (:func:`estimate_clock_offset` — RPC midpoint
  method over this module's sanctioned clock) so N nodes' dumps merge
  onto one aligned timeline.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from celestia_tpu_torch.utils.telemetry import Log2Histogram, clock

ENV_FLAG = "CELESTIA_TPU_TORCH_TRACE"
ENV_BLOCKS = "CELESTIA_TPU_TORCH_TRACE_BLOCKS"
ENV_NODE_ID = "CELESTIA_TPU_TORCH_NODE_ID"

DEFAULT_MAX_BLOCKS = 8
MAX_SPANS_PER_BLOCK = 8192
MAX_BACKGROUND_SPANS = 2048

# ---------------------------------------------------------------------------
# node identity (cross-node attribution)
# ---------------------------------------------------------------------------

# the stable identity of THIS process in a mesh: stamped onto every
# exported trace event and carried as the origin of outbound trace
# contexts.  Set once (env wins over code); empty = single-node.
_node_id = ""


def set_node_id(node_id: str, force: bool = False) -> None:
    """Set this process's node id (first write wins unless ``force``):
    the NodeServer sets its bind address at start, the env var overrides
    at import, tests force their own."""
    global _node_id
    if _node_id and not force:
        return
    _node_id = str(node_id)[:128]


def node_id() -> str:
    return _node_id

# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# one process-wide monotonic id stream: deterministic (no random/time
# bits) and unique across threads (itertools.count.__next__ is atomic
# under the GIL)
_span_ids = itertools.count(1)

# the active span of the current logical context (per-thread via
# contextvars; explicitly captured + passed for pool-fanned work)
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "celestia_tpu_trace_span", default=None
)

# live span per OS thread id — the CROSS-thread view the host sampling
# profiler (utils/hostprof.py) joins wall-clock samples against
# (contextvars are only readable from their own thread; a sampler
# walking sys._current_frames() needs tid -> span).  Written only on
# the enabled span enter/exit path; single dict item ops are atomic
# under the GIL, so readers never need the tracer lock.
_active_by_thread: Dict[int, Span] = {}


class Span:
    """One timed operation.  ``t0``/``t1`` are telemetry-clock seconds."""

    __slots__ = (
        "span_id", "parent_id", "name", "cat", "t0", "t1", "tid",
        "thread_name", "args", "_sink", "_token",
    )

    def __init__(self, name, cat, parent_id, sink, args, t0=None, t1=0.0):
        """``t0=None`` stamps the span open NOW (the context-manager
        form); explicit t0/t1 build an already-measured span (the
        queue-wait form used by :meth:`Tracer.record_span`)."""
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.args = args
        self._sink = sink
        self._token = None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.t0 = clock() if t0 is None else t0
        self.t1 = t1

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0

    def annotate(self, **kv) -> None:
        """Attach key/value args to a live span (e.g. cache hit/miss)."""
        self.args.update(kv)

    def to_event(self) -> dict:
        """Chrome trace-event 'X' (complete) form, ts/dur in µs."""
        return {
            "ph": "X",
            "name": self.name,
            "cat": self.cat,
            "ts": round(self.t0 * 1e6, 3),
            "dur": round(max(0.0, self.t1 - self.t0) * 1e6, 3),
            "pid": 1,
            "tid": self.tid,
            "args": {
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                **{k: v for k, v in self.args.items() if k != "_render"},
            },
        }

    def to_async_events(self) -> List[dict]:
        """Chrome ASYNC ('b'/'e' + id) form: the export for spans that
        legitimately overlap others on one track (queue waits all start
        at submit time and end at staggered pick-ups — complete 'X'
        events would mis-stack in Perfetto, async tracks render them)."""
        base = {
            "name": self.name,
            "cat": self.cat,
            "id": str(self.span_id),
            "pid": 1,
            "tid": self.tid,
            "args": {
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                **{k: v for k, v in self.args.items() if k != "_render"},
            },
        }
        return [
            dict(base, ph="b", ts=round(self.t0 * 1e6, 3)),
            dict(base, ph="e", ts=round(self.t1 * 1e6, 3)),
        ]

    def export_events(self) -> List[dict]:
        if self.args.get("_render") == "async":
            return self.to_async_events()
        return [self.to_event()]


class _NullSpan:
    """The disabled-path span: one shared instance, every operation a
    no-op.  Returned by ``span()``/``block_span()`` when tracing is off
    so call sites never branch."""

    __slots__ = ()
    span_id = 0
    parent_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv) -> None:
        pass


NULL_SPAN = _NullSpan()


class BlockTrace:
    """All spans + instant events of one per-height root span (one
    prepare, one process, ...).  Span/instant appends are serialized by
    the tracer lock (pool workers finish spans concurrently)."""

    __slots__ = (
        "name", "height", "root_id", "spans", "instants", "dropped",
        "complete",
    )

    def __init__(self, name: str, height: int, root_id: int):
        self.name = name
        self.height = height
        self.root_id = root_id
        self.spans: List[Span] = []
        self.instants: List[dict] = []
        self.dropped = 0
        self.complete = False

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def to_events(self) -> List[dict]:
        events: List[dict] = []
        for s in self.spans:
            events.extend(s.export_events())
        events.extend(self.instants)
        return events

    def tree(self) -> dict:
        """Structural form (no durations, no ids): {name, children}
        nested by parent links — what the determinism tests compare.
        Children are sorted by name: pool workers finish in arbitrary
        order, and completion order is timing, not structure."""
        by_id = {s.span_id: {"name": s.name, "children": []} for s in self.spans}
        root = None
        for s in self.spans:
            node = by_id[s.span_id]
            parent = by_id.get(s.parent_id)
            if parent is not None:
                parent["children"].append(node)
            elif s.span_id == self.root_id:
                root = node
        for node in by_id.values():
            node["children"].sort(key=lambda n: n["name"])
        return root or {"name": self.name, "children": []}


class Tracer:
    """The process tracer: a ring of recent block traces + a background
    ring for spans that belong to no block."""

    def __init__(self, max_blocks: int = DEFAULT_MAX_BLOCKS):
        self._lock = threading.Lock()
        # completed block traces, oldest evicted first;
        # celint: guarded-by(self._lock)
        self._blocks: "deque[BlockTrace]" = deque(maxlen=max_blocks)
        # spans/instants outside any block (gossip, DAS serving, ...);
        # celint: guarded-by(self._lock)
        self._background: "deque[dict]" = deque(maxlen=MAX_BACKGROUND_SPANS)
        # per-name duration aggregation (bounded histograms) feeding the
        # telemetry summary; celint: guarded-by(self._lock)
        self._agg: Dict[str, Log2Histogram] = {}
        # cumulative span/instant drops across ALL traces (per-trace
        # ``dropped`` dies with its ring slot; a busy node silently
        # truncating must be detectable remotely long after);
        # celint: guarded-by(self._lock)
        self._span_drops_total = 0
        self.enabled = False

    # -- lifecycle -----------------------------------------------------

    def enable(self, max_blocks: Optional[int] = None) -> None:
        global _enabled
        with self._lock:
            if max_blocks is not None and max_blocks != self._blocks.maxlen:
                self._blocks = deque(self._blocks, maxlen=max(1, max_blocks))
            self.enabled = True
        _enabled = True

    def disable(self) -> None:
        global _enabled
        with self._lock:
            self.enabled = False
        _enabled = False

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._background.clear()
            self._agg.clear()
            self._span_drops_total = 0
        _active_by_thread.clear()

    @property
    def max_blocks(self) -> int:
        return self._blocks.maxlen or DEFAULT_MAX_BLOCKS

    # -- span API ------------------------------------------------------

    def span(
        self,
        name: str,
        cat: str = "block",
        parent: Optional[Span] = None,
        **args,
    ):
        """Context manager for one timed operation, parented to the
        current contextvar span (or an explicit ``parent`` — the
        cross-thread form pool workers use)."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            parent = _current.get()
        sink = parent._sink if isinstance(parent, Span) else None
        s = Span(name, cat, parent.span_id if parent else 0, sink, args)
        return _SpanCtx(self, s)

    def block_span(self, name: str, height: int, **args):
        """A per-height ROOT span: opens a fresh :class:`BlockTrace`
        that collects every descendant span; the trace enters the ring
        when this span ends.

        The root's parent_id stays 0 (a block trace is its own tree),
        but when an enclosing span is active — e.g. the server-side
        ``rpc.*`` span a cross-node RPC opened — its id is recorded as
        ``link_span_id`` and any remote-origin args it carries
        (``remote_node``/``remote_span``/``remote_send_ts``) are
        inherited, so the proposer's prepare on node A links explicitly
        to the validator's process root on node B."""
        if not self.enabled:
            return NULL_SPAN
        s = Span(name, "block", 0, None, {"height": height, **args})
        enc = _current.get()
        if enc is not None:
            s.args.setdefault("link_span_id", enc.span_id)
            for k in ("remote_node", "remote_span", "remote_send_ts"):
                if k in enc.args:
                    s.args.setdefault(k, enc.args[k])
        s._sink = BlockTrace(name, height, s.span_id)
        return _SpanCtx(self, s)

    def current(self) -> Optional[Span]:
        """The active span of this thread's context (capture it before
        handing work to a pool; None when disabled or outside spans)."""
        if not self.enabled:
            return None
        return _current.get()

    def record_span(
        self,
        name: str,
        t0: float,
        t1: float,
        parent: Optional[Span] = None,
        cat: str = "block",
        tid: Optional[int] = None,
        thread_name: Optional[str] = None,
        render_async: bool = False,
        **args,
    ) -> None:
        """Record an already-measured span (explicit timestamps) — the
        queue-wait form: the submitting thread stamps t0, the worker
        stamps t1, nobody holds a context over the gap.  ``tid`` /
        ``thread_name`` re-home the span onto the thread it conceptually
        belongs to (a queue-wait starts on the SUBMITTER's track; the
        worker that eventually picks the item up merely records it —
        stamping the worker's tid would overlap its own run spans).
        ``render_async=True`` exports the span as a Chrome async
        ('b'/'e') pair instead of a complete 'X' event — required when
        same-track spans legitimately overlap (N queue waits share one
        submit instant but end at staggered pick-ups)."""
        if not self.enabled:
            return
        if render_async:
            args["_render"] = "async"
        sink = parent._sink if isinstance(parent, Span) else None
        s = Span(
            name, cat, parent.span_id if parent else 0, sink, args,
            t0=t0, t1=t1,
        )
        if tid is not None:
            s.tid = tid
        if thread_name is not None:
            s.thread_name = thread_name
        self._finish(s)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """An instant event ('i') on the active trace — fault notes,
        degradations, cache hit/miss marks."""
        if not self.enabled:
            return
        parent = _current.get()
        t = threading.current_thread()
        ev = {
            "ph": "i",
            "name": name,
            "cat": cat,
            "ts": round(clock() * 1e6, 3),
            "pid": 1,
            "tid": t.ident or 0,
            "s": "t",
            "args": {
                "parent_id": parent.span_id if parent else 0,
                **args,
            },
        }
        sink = parent._sink if parent is not None else None
        with self._lock:
            if sink is not None:
                if len(sink.instants) + len(sink.spans) < MAX_SPANS_PER_BLOCK:
                    sink.instants.append(ev)
                else:
                    sink.dropped += 1
                    self._span_drops_total += 1
            else:
                self._background.append(ev)

    # -- internals -----------------------------------------------------

    def _finish(self, s: Span) -> None:
        with self._lock:
            hist = self._agg.get(s.name)
            if hist is None:
                hist = self._agg[s.name] = Log2Histogram()
            hist.observe(max(0.0, s.t1 - s.t0))
            sink = s._sink
            if sink is not None:
                is_root = s.span_id == sink.root_id
                # the ROOT is exempt from the cap: it finishes last, and
                # dropping it would turn an over-full trace into an
                # empty tree (no parent for anything) instead of a
                # truncated-but-readable one
                if is_root or (
                    len(sink.spans) + len(sink.instants) < MAX_SPANS_PER_BLOCK
                ):
                    sink.spans.append(s)
                else:
                    sink.dropped += 1
                    self._span_drops_total += 1
                if is_root:
                    sink.complete = True
                    self._blocks.append(sink)
            else:
                self._background.extend(s.export_events())

    # -- export --------------------------------------------------------

    def block_traces(self, last: Optional[int] = None) -> List[BlockTrace]:
        with self._lock:
            traces = list(self._blocks)
        if last is not None:
            traces = traces[-max(0, int(last)):]
        return traces

    def ring_stats(self) -> dict:
        """Ring-health counters for the metrics plane (satellite: silent
        trace truncation on a busy node must be detectable REMOTELY, not
        only in a local dump): cumulative span/instant drops, the
        background-ring depth, and the block-ring fill."""
        with self._lock:
            return {
                "span_drops_total": self._span_drops_total,
                "background_depth": len(self._background),
                "blocks_kept": len(self._blocks),
                "max_blocks": self._blocks.maxlen or DEFAULT_MAX_BLOCKS,
            }

    def span_summary(self) -> Dict[str, dict]:
        """Per-span-name duration aggregates (count/p50/p95/p99/max) for
        the telemetry summary."""
        with self._lock:
            return {name: h.summary() for name, h in sorted(self._agg.items())}

    def _agg_snapshot(self) -> Dict[str, Log2Histogram]:
        """Stable view of the per-name histograms for the Prometheus
        export (histograms are internally locked; the dict copy is what
        needs the tracer lock)."""
        with self._lock:
            return dict(self._agg)

    def trace_dump(self, last: Optional[int] = None) -> dict:
        """Chrome trace-event JSON of the last N block traces plus the
        background ring — open it in Perfetto (ui.perfetto.dev) or
        chrome://tracing as-is."""
        traces = self.block_traces(last)
        with self._lock:
            background = list(self._background)
        events: List[dict] = []
        seen_threads: Dict[int, str] = {}
        for tr in traces:
            events.extend(tr.to_events())
            for s in tr.spans:
                seen_threads.setdefault(s.tid, s.thread_name)
        events.extend(background)
        nid = _node_id
        if nid:
            # tag every span with the stable node id (cross-node merge
            # attribution).  Background events are the live ring's dicts;
            # copy before stamping so the export never mutates the ring.
            events = [
                dict(ev, args=dict(ev.get("args", {}), node_id=nid))
                for ev in events
            ]
        meta = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 1,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(seen_threads.items())
        ]
        if nid:
            meta.insert(
                0,
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": 1,
                    "args": {"name": nid},
                },
            )
        return {
            "displayTimeUnit": "ms",
            "traceEvents": meta + events,
            "otherData": {
                "tracer": "celestia-tpu",
                "node_id": nid,
                "blocks": [
                    {
                        "name": tr.name,
                        "height": tr.height,
                        "spans": len(tr.spans),
                        "instants": len(tr.instants),
                        "dropped": tr.dropped,
                    }
                    for tr in traces
                ],
            },
        }

    def phase_breakdown(self, trace: BlockTrace) -> Dict[str, float]:
        """Per-phase ms of one block trace: each DIRECT child of the
        root contributes its duration under its name (duplicate names
        sum); ``total_ms`` is the root span itself and ``untraced_ms``
        the root time no direct child covers.

        For every phase that has sub-spans of its own (e.g. ``extend``
        containing ``extend.native``/``roots``/hostpool tasks) the
        breakdown also reports ``<phase>_untraced_ms`` — the phase time
        its own children do not cover.  THAT is the intra-phase
        pipeline-tail figure (the root-level ``untraced_ms`` only sees
        glue between top-level phases).  Parallel children can sum past
        their parent's wall time, so the remainder clamps at zero —
        a fully-overlapped phase has no serial tail to report."""
        out: Dict[str, float] = {}
        root_dur = 0.0
        direct_sum = 0.0
        # parent span id -> summed child wall time
        child_sum: Dict[int, float] = {}
        for s in trace.spans:
            if s.span_id != trace.root_id:
                child_sum[s.parent_id] = (
                    child_sum.get(s.parent_id, 0.0) + s.duration_ms
                )
        for s in trace.spans:
            if s.span_id == trace.root_id:
                root_dur = s.duration_ms
            elif s.parent_id == trace.root_id:
                key = f"{s.name}_ms"
                out[key] = out.get(key, 0.0) + s.duration_ms
                direct_sum += s.duration_ms
                if s.span_id in child_sum:
                    ukey = f"{s.name}_untraced_ms"
                    out[ukey] = out.get(ukey, 0.0) + max(
                        0.0, s.duration_ms - child_sum[s.span_id]
                    )
        out["total_ms"] = root_dur
        out["untraced_ms"] = max(0.0, root_dur - direct_sum)
        return {k: round(v, 3) for k, v in out.items()}


class _SpanCtx:
    """Context manager that ends one live span (restores the contextvar
    even when the body raises; the error is annotated, never swallowed).

    The contextvar is set in ``__enter__``, NOT at span construction: a
    span object that is created but never entered (held in a variable,
    discarded on a branch) must not corrupt the thread's parent chain."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._span._token = _current.set(self._span)
        _active_by_thread[self._span.tid] = self._span
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        if exc is not None:
            s.args["error"] = repr(exc)[:200]
        s.t1 = clock()
        if s._token is not None:
            # restore the thread's sampler-visible span to whatever was
            # active before this one (the token records the old value)
            old = s._token.old_value
            if old is contextvars.Token.MISSING:
                old = None
            if old is None:
                _active_by_thread.pop(s.tid, None)
            else:
                _active_by_thread[s.tid] = old
            _current.reset(s._token)
        self._tracer._finish(s)
        return False


# ---------------------------------------------------------------------------
# module-level surface (one process tracer, like the faults registry)
# ---------------------------------------------------------------------------

TRACER = Tracer()

# fast-path gate mirrored at module level: the disabled hot path is one
# global load + truth test, no attribute chase
_enabled = False


def enable(max_blocks: Optional[int] = None) -> None:
    TRACER.enable(max_blocks)


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return _enabled


def clear() -> None:
    TRACER.clear()


def span(name: str, cat: str = "block", parent: Optional[Span] = None, **args):
    if not _enabled:
        return NULL_SPAN
    return TRACER.span(name, cat=cat, parent=parent, **args)


def block_span(name: str, height: int, **args):
    if not _enabled:
        return NULL_SPAN
    return TRACER.block_span(name, height, **args)


def current() -> Optional[Span]:
    if not _enabled:
        return None
    return TRACER.current()


def thread_span(tid: int) -> Optional[Span]:
    """The span currently active on the thread with OS id ``tid`` —
    the cross-thread join point for the host sampling profiler
    (utils/hostprof.py): a wall-clock sample of a pool worker lands
    under that worker's live ``hostpool.task`` span, so ``untraced_ms``
    decomposes into named frames.  None when tracing is disabled or the
    thread is between spans."""
    if not _enabled:
        return None
    return _active_by_thread.get(tid)


def record_span(
    name, t0, t1, parent=None, cat="block", tid=None, thread_name=None,
    render_async=False, **args,
) -> None:
    if not _enabled:
        return
    TRACER.record_span(
        name, t0, t1, parent=parent, cat=cat, tid=tid,
        thread_name=thread_name, render_async=render_async, **args,
    )


def instant(name: str, cat: str = "event", **args) -> None:
    if not _enabled:
        return
    TRACER.instant(name, cat=cat, **args)


def trace_dump(last: Optional[int] = None) -> dict:
    return TRACER.trace_dump(last)


def span_summary() -> Dict[str, dict]:
    return TRACER.span_summary()


def ring_stats() -> dict:
    return TRACER.ring_stats()


def block_traces(last: Optional[int] = None) -> List[BlockTrace]:
    return TRACER.block_traces(last)


# ---------------------------------------------------------------------------
# cross-node trace context (the "_tc" wire field)
# ---------------------------------------------------------------------------
#
# Local span ids are a per-process monotonic count, so cross-node
# parentage can never be a bare id: the wire context names the ORIGIN
# (node id) + the parent span id within that origin, and the merge tool
# resolves (node, span) pairs into Chrome flow events.  The context is
# a plain JSON-safe dict with compact keys:
#
#   {"n": origin node id, "s": parent span id (0 = none),
#    "h": height (0 = n/a), "t": send timestamp (telemetry clock)}
#
# It rides cross-node RPC envelopes as an OPTIONAL "_tc" field that
# un-upgraded peers ignore (their handlers read named keys); a missing,
# truncated or malformed context degrades to "no remote parent" — never
# an error, never a leaked span.


def wire_context(height: int = 0) -> Optional[dict]:
    """The compact trace context of the CURRENT logical call site, for
    attaching to an outbound cross-node RPC.  None when tracing is off
    (the envelope then carries no ``_tc`` at all — zero bytes, zero
    cost on the gossip hot path)."""
    if not _enabled:
        return None
    cur = _current.get()
    return {
        "n": _node_id,
        "s": cur.span_id if cur is not None else 0,
        "h": int(height or 0),
        "t": round(clock(), 6),
    }


def last_block_context(name: Optional[str] = None) -> Optional[dict]:
    """Wire context anchored to the newest completed block trace
    (optionally of a given root name): how a proposer hands the span id
    of its *prepare* root to the coordinator, which forwards it to every
    validator's *process* leg."""
    if not _enabled:
        return None
    for tr in reversed(TRACER.block_traces()):
        if name is None or tr.name == name:
            return {
                "n": _node_id,
                "s": tr.root_id,
                "h": tr.height,
                "t": round(clock(), 6),
            }
    return None


def _context_args(tc) -> dict:
    """Remote-origin span args from a received wire context.  Malformed
    or version-mismatched contexts (old peers, hostile bytes) fold to
    {} — mixed-version meshes must keep working.  A context with no
    parent span (``s`` 0 — e.g. a gossip flood drained from the outbox
    outside any span) still attributes the ORIGIN node; only a valid
    span id adds the flow-linkable ``remote_span``."""
    if not isinstance(tc, dict) or not isinstance(tc.get("n"), str):
        return {}
    try:
        origin = tc["n"][:128]
        span_id = int(tc.get("s", 0) or 0)
        send_ts = float(tc.get("t", 0.0) or 0.0)
    except (TypeError, ValueError):
        return {}
    if not origin:
        return {}
    out = {"remote_node": origin}
    if span_id > 0:
        out["remote_span"] = span_id
    if send_ts > 0.0:
        out["remote_send_ts"] = round(send_ts, 6)
    return out


def rpc_span(name: str, tc=None, cat: str = "rpc", **args):
    """Server-side span for a cross-node RPC: like :func:`span`, but
    records the caller's context as explicit ``remote_node``/
    ``remote_span`` args (local parentage still rides the contextvar).
    A block trace opened inside it inherits the remote link onto its
    root (see :meth:`Tracer.block_span`)."""
    if not _enabled:
        return NULL_SPAN
    return TRACER.span(name, cat=cat, **{**_context_args(tc), **args})


# ---------------------------------------------------------------------------
# clock alignment (RPC midpoint offset probe)
# ---------------------------------------------------------------------------


def estimate_clock_offset(probe_fn, samples: int = 5) -> dict:
    """Estimate a peer's clock offset by the RPC midpoint method.

    ``probe_fn()`` performs one round trip and returns the PEER's
    telemetry-clock timestamp (seconds).  For each sample the peer time
    is compared against the midpoint of the local send/receive stamps —
    the standard symmetric-delay estimator — and the sample with the
    smallest RTT wins (least queueing noise).  All local stamps come
    from the sanctioned telemetry ``clock()`` (celint R3: this module is
    a sanctioned channel).

    Returns ``{"offset_s", "rtt_s", "samples"}`` where ``offset_s`` is
    *peer clock minus local clock*: subtract it from the peer's
    timestamps to land them on the local timeline."""
    best_rtt = float("inf")
    best_offset = 0.0
    n = 0
    for _ in range(max(1, int(samples))):
        t0 = clock()
        peer_ts = float(probe_fn())
        t1 = clock()
        rtt = max(0.0, t1 - t0)
        n += 1
        if rtt < best_rtt:
            best_rtt = rtt
            best_offset = peer_ts - (t0 + t1) / 2.0
    return {
        "offset_s": round(best_offset, 6),
        "rtt_s": round(best_rtt, 6),
        "samples": n,
    }


def validate_chrome_trace(dump: dict) -> List[str]:
    """Schema check of a trace_dump() document (the trace-smoke gate):
    returns a list of problems, empty when the JSON is a well-formed
    Chrome trace-event document Perfetto will open."""
    problems: List[str] = []
    if not isinstance(dump, dict):
        return ["dump is not an object"]
    events = dump.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        problems.append("traceEvents is empty")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "b", "e", "s", "t", "f"):
            problems.append(f"event {i} has unknown phase {ph!r}")
            continue
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                problems.append(f"metadata event {i} lacks name/args")
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} ({ev.get('name')}) lacks {field!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"complete event {i} ({ev.get('name')}) lacks dur")
        if ph in ("b", "e") and "id" not in ev:
            problems.append(f"async event {i} ({ev.get('name')}) lacks id")
        if ph in ("s", "t", "f") and "id" not in ev:
            problems.append(f"flow event {i} ({ev.get('name')}) lacks id")
        if not isinstance(ev.get("ts", 0), (int, float)):
            problems.append(f"event {i} ts is not numeric")
    try:
        json.dumps(dump)
    except (TypeError, ValueError) as e:
        problems.append(f"dump is not JSON-serializable: {e}")
    return problems


# ---------------------------------------------------------------------------
# store-write bridge: ONE tracing surface for block execution
# ---------------------------------------------------------------------------


class trace_store_writes:
    """Route a MultiStore's write tracer into the span tracer: every
    store write/delete becomes an instant event on the active trace
    (SetCommitMultiStoreTracer parity, app/app.go:243 — but through the
    one tracing surface instead of an ad-hoc callback list).

    Context manager; restores the previous store tracer on exit.  The
    captured events are also kept on ``self.events`` so callers (tests,
    debuggers) can assert without digging through the trace dump."""

    def __init__(self, multistore, include_values: bool = False):
        self._store = multistore
        self._include_values = include_values
        self._prev = None
        self._installed = False
        self.events: List[Tuple[str, str, bytes]] = []

    def _on_write(self, op, store, key, value) -> None:
        # only the INSTALLED (innermost) bridge emits the trace instant:
        # chained outer bridges record the event but must not duplicate
        # it on the trace (one write = one store.write instant)
        kv = {"op": op, "store": store, "key": key.hex()}
        if self._include_values and value is not None:
            kv["value"] = value.hex()[:128]
        instant("store.write", cat="store", **kv)
        self._record(op, store, key, value)

    def _record(self, op, store, key, value) -> None:
        """Append to this bridge's event list and chain onward: nested
        bridges record without re-emitting instants; a non-bridge
        previous tracer (operator callback) is invoked as installed."""
        self.events.append((op, store, key))
        prev = self._prev
        if prev is None:
            return
        outer = getattr(prev, "__self__", None)
        if isinstance(outer, trace_store_writes):
            outer._record(op, store, key, value)
        else:
            prev(op, store, key, value)

    def __enter__(self) -> "trace_store_writes":
        self._prev = self._store._tracer_ref[0]
        self._store.set_tracer(self._on_write)
        self._installed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._installed:
            self._store.set_tracer(self._prev)
            self._installed = False
        return False


def _arm_from_env() -> None:
    """Enable at import when CELESTIA_TPU_TORCH_TRACE is truthy — a traced
    node needs no code changes, same contract as the faults registry.
    CELESTIA_TPU_TORCH_TRACE_BLOCKS alone also enables (mirroring the CLI,
    where --trace-blocks implies --trace: sizing a ring you did not
    turn on must not be a silent no-op).  CELESTIA_TPU_TORCH_NODE_ID pins the
    node identity regardless of tracing state (the metrics plane tags
    by it too)."""
    import os

    nid = os.environ.get(ENV_NODE_ID, "").strip()
    if nid:
        set_node_id(nid, force=True)
    flag = os.environ.get(ENV_FLAG, "").strip().lower()
    blocks = os.environ.get(ENV_BLOCKS, "").strip()
    try:
        n = int(blocks) if blocks else None
    except ValueError:
        n = None
    if flag in ("1", "true", "yes", "on") or n is not None:
        enable(n)


_arm_from_env()
