"""Block-lifecycle critical-path analysis over recorded traces.

Consumes either a live :class:`~celestia_tpu_torch.utils.tracing.BlockTrace`
or an already-exported Chrome trace document (a single-node
``trace_dump`` or the ``merge_node_dumps`` multi-node doc from
``node/cluster.py``) and extracts the **critical path** of one block:
the longest blocking chain from the block root to commit, with every
millisecond of the analyzed window attributed to exactly one of four
categories:

* ``self``        — a leaf span actually executing
* ``queue_wait``  — ``hostpool.queue_wait`` spans (the async b/e pairs):
                    work submitted but not yet picked up
* ``flow``        — cross-node edges: the gap between a ``_tc`` send
                    timestamp (shifted onto the collector's clock axis
                    by the estimated clock offset) and the receiving
                    span's start — i.e. per-hop propagation delay
* ``gap``         — unattributed time inside a span that HAS children
                    but none of them covers the moment (decomposed
                    per phase with the same ``{phase}_untraced_ms`` /
                    ``untraced_ms`` names ``Tracer.phase_breakdown``
                    uses), plus inter-span handoff gaps

The walk is a backward sweep: start at the end of the terminal span and
repeatedly descend into the last-finishing child that ends before the
cursor.  By construction the emitted segments PARTITION the analyzed
window — their durations sum to the window wall exactly (float
rounding aside), which is the invariant the smoke gate pins at 1%.

This module is deliberately **clock-free**: it only does arithmetic on
timestamps already recorded by the tracing plane, so it is safe to run
anywhere (celint R3 does not apply) and results are reproducible from
a trace file alone.  It lives in ``utils/`` and therefore must not
import ``node/`` (celint R8); ``node/cluster.py`` imports *us* for the
mesh waterfall rollup.

Negative cross-node deltas (``recv < send_ts`` after the offset shift,
i.e. clock-offset noise) are NEVER reported as negative seconds: the
hop's delay clamps to 0 and the report counts it in
``clock_skew_clamped`` so serving-plane consumers can increment
``celestia_tpu_clock_skew_clamped_total`` instead of poisoning
histograms.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PathSpan",
    "extract_spans",
    "critical_path",
    "propagation_delays",
    "hop_delay_ms",
    "BLOCK_ROOT_NAMES",
    "COMMIT_SPAN_NAMES",
]

# Block lifecycle anchors: block_span roots (carry args.height) and the
# commit-side rpc span that ends the lifecycle on a validator.
BLOCK_ROOT_NAMES = ("prepare_proposal", "process_proposal")
COMMIT_SPAN_NAMES = ("rpc.cons_commit",)

_QUEUE_WAIT_NAME = "hostpool.queue_wait"
_EPS = 1e-9  # seconds; float-noise guard for the cursor arithmetic


class PathSpan:
    """One normalized span on a single merged clock axis (seconds)."""

    __slots__ = ("node", "span_id", "parent_id", "name", "cat", "t0", "t1", "args")

    def __init__(self, node, span_id, parent_id, name, cat, t0, t1, args):
        self.node = node
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.args = args

    @property
    def wall_ms(self) -> float:
        return max(0.0, self.t1 - self.t0) * 1000.0


def _spans_from_blocktrace(trace) -> Tuple[List[PathSpan], Dict[str, float]]:
    """BlockTrace -> spans on the local clock axis; no offsets."""
    out = []
    for s in trace.spans:
        out.append(
            PathSpan("", s.span_id, s.parent_id, s.name, s.cat, s.t0, s.t1, dict(s.args))
        )
    return out, {}


def _spans_from_doc(doc: dict) -> Tuple[List[PathSpan], Dict[str, float]]:
    """Chrome doc (single-node dump or merged) -> spans + clock offsets.

    Merged docs carry ``otherData.nodes`` with per-part ``pid`` and
    ``clock_offset_s`` (peer minus collector — event timestamps were
    already shifted onto the collector axis at merge time; the offsets
    are still needed to shift the RAW ``remote_send_ts`` args, which
    ride untouched on the origin's clock).  Single-node dumps fall back
    to ``otherData.node_id`` / per-event ``args.node_id``.
    """
    other = doc.get("otherData", {}) or {}
    pid_node: Dict[int, str] = {}
    offsets: Dict[str, float] = {}
    for n in other.get("nodes", []) or []:
        nid = str(n.get("node_id", ""))
        try:
            pid_node[int(n.get("pid", 0))] = nid
        except (TypeError, ValueError):
            pass
        try:
            offsets[nid] = float(n.get("clock_offset_s") or 0.0)
        except (TypeError, ValueError):
            offsets[nid] = 0.0
    default_node = str(other.get("node_id", ""))

    spans: List[PathSpan] = []
    pending: Dict[Tuple[int, str], dict] = {}  # (pid, id) -> b event
    for ev in doc.get("traceEvents", []) or []:
        ph = ev.get("ph")
        args = ev.get("args", {}) or {}
        if ph == "X" and "span_id" in args:
            pid = int(ev.get("pid", 1) or 1)
            node = str(args.get("node_id") or pid_node.get(pid, default_node))
            ts = float(ev.get("ts", 0.0)) / 1e6
            dur = max(0.0, float(ev.get("dur", 0.0))) / 1e6
            spans.append(
                PathSpan(
                    node,
                    int(args["span_id"]),
                    int(args.get("parent_id", 0) or 0),
                    str(ev.get("name", "")),
                    str(ev.get("cat", "")),
                    ts,
                    ts + dur,
                    dict(args),
                )
            )
        elif ph == "b" and "span_id" in args:
            pending[(int(ev.get("pid", 1) or 1), str(ev.get("id", "")))] = ev
        elif ph == "e":
            key = (int(ev.get("pid", 1) or 1), str(ev.get("id", "")))
            b = pending.pop(key, None)
            if b is None:
                continue
            bargs = b.get("args", {}) or {}
            pid = key[0]
            node = str(bargs.get("node_id") or pid_node.get(pid, default_node))
            t0 = float(b.get("ts", 0.0)) / 1e6
            t1 = float(ev.get("ts", t0 * 1e6)) / 1e6
            spans.append(
                PathSpan(
                    node,
                    int(bargs.get("span_id", 0) or 0),
                    int(bargs.get("parent_id", 0) or 0),
                    str(b.get("name", "")),
                    str(b.get("cat", "")),
                    t0,
                    max(t0, t1),
                    dict(bargs),
                )
            )
    return spans, offsets


def extract_spans(source) -> Tuple[List[PathSpan], Dict[str, float]]:
    """Normalize a BlockTrace or Chrome doc into ``(spans, offsets)``.

    ``offsets`` maps node id -> clock_offset_s (peer minus collector);
    empty for BlockTrace input (one process, one clock).
    """
    if isinstance(source, dict):
        return _spans_from_doc(source)
    if hasattr(source, "spans"):
        return _spans_from_blocktrace(source)
    raise TypeError(f"unsupported trace source: {type(source).__name__}")


def _is_queue_wait(span: PathSpan) -> bool:
    return span.name == _QUEUE_WAIT_NAME or (
        span.cat == "hostpool" and "queue_wait" in span.name
    )


def _send_ts_local(span: PathSpan, offsets: Dict[str, float]) -> Optional[float]:
    """The span's ``remote_send_ts`` shifted onto the collector axis.

    ``remote_send_ts`` rides RAW on the origin node's clock; subtracting
    the origin's ``clock_offset_s`` (peer minus collector) lands it on
    the same axis as the (already shifted) event timestamps.
    """
    ts = span.args.get("remote_send_ts")
    if ts is None:
        return None
    try:
        ts = float(ts)
    except (TypeError, ValueError):
        return None
    origin = str(span.args.get("remote_node", ""))
    return ts - float(offsets.get(origin, 0.0))


def hop_delay_ms(span: PathSpan, offsets: Dict[str, float]):
    """One receiving span's propagation delay: ``(delay_ms, clamped)``,
    or None when the span carries no cross-node send timestamp.  The
    delay clamps at 0 (``clamped=True`` marks clock-offset noise)."""
    send_local = _send_ts_local(span, offsets)
    if send_local is None:
        return None
    raw = (span.t0 - send_local) * 1000.0
    return (round(max(0.0, raw), 3), raw < 0.0)


class _Walker:
    """Backward sweep emitting partition segments for one window."""

    def __init__(self, kids_of, root_key):
        self.kids_of = kids_of
        self.root_key = root_key
        self.segments: List[dict] = []

    def _emit(self, span: PathSpan, lo: float, hi: float, scope: str) -> None:
        if hi - lo <= _EPS:
            return
        has_kids = bool(self.kids_of.get((span.node, span.span_id)))
        if _is_queue_wait(span):
            kind, phase = "queue_wait", ""
        elif has_kids:
            kind = "gap"
            phase = (
                "untraced_ms"
                if (span.node, span.span_id) == self.root_key
                else f"{span.name}_untraced_ms"
            )
        else:
            kind, phase = "self", ""
        self.segments.append(
            {
                "node": span.node,
                "name": span.name,
                "span_id": span.span_id,
                "kind": kind,
                "phase": phase,
                "scope": scope,
                "t0": lo,
                "t1": hi,
            }
        )

    def walk(self, span: PathSpan, lo: float, hi: float, scope: str) -> None:
        """Attribute ``[lo, hi]`` (clipped to the span's own interval).

        Invariant: the segments emitted for this call sum exactly to
        ``hi - lo`` — children chosen on the path recurse over disjoint
        sub-windows and the cursor arithmetic covers every remainder.
        """
        lo = max(lo, span.t0)
        hi = min(hi, span.t1)
        if hi - lo <= _EPS:
            return
        kids = self.kids_of.get((span.node, span.span_id), ())
        cursor = hi
        for c in sorted(kids, key=lambda c: c.t1, reverse=True):
            c_hi = min(c.t1, cursor)
            c_lo = max(lo, c.t0)
            if c_hi - c_lo <= _EPS:
                continue
            if cursor - c_hi > _EPS:
                self._emit(span, c_hi, cursor, scope)
            self.walk(c, c_lo, c_hi, scope)
            cursor = c_lo
            if cursor - lo <= _EPS:
                break
        if cursor - lo > _EPS:
            self._emit(span, lo, cursor, scope)


def _pick_anchor(
    spans: Sequence[PathSpan], height: Optional[int], root_id: Optional[int]
) -> Optional[PathSpan]:
    if root_id is not None:
        for s in spans:
            if s.span_id == root_id:
                return s
    best = None
    for s in spans:
        if s.name not in BLOCK_ROOT_NAMES:
            continue
        if height is not None and s.args.get("height") not in (height, str(height)):
            continue
        if best is None or s.t1 > best.t1:
            best = s
    return best


def propagation_delays(source, offsets: Optional[Dict[str, float]] = None) -> List[dict]:
    """Every cross-node hop recorded in the source, one entry per hop.

    delay = receiving span's start − (``remote_send_ts`` − origin clock
    offset), clamped at 0 (``clamped: True`` marks hops where the raw
    delta went negative — clock-offset noise, never a real negative
    flight time).  Hops are deduped on (origin, remote_span, send_ts):
    the rpc envelope and the block root it contains carry the same
    context; the EARLIEST receiving span (the true receipt) wins.
    """
    if offsets is None:
        spans, offsets = extract_spans(source)
    else:
        spans, _ = extract_spans(source)
    hops: Dict[tuple, dict] = {}
    for s in spans:
        send_local = _send_ts_local(s, offsets)
        if send_local is None:
            continue
        key = (
            str(s.args.get("remote_node", "")),
            s.args.get("remote_span"),
            s.args.get("remote_send_ts"),
        )
        prev = hops.get(key)
        if prev is not None and prev["_t0"] <= s.t0:
            continue
        raw_ms = (s.t0 - send_local) * 1000.0
        hops[key] = {
            "from_node": key[0],
            "to_node": s.node,
            "name": s.name,
            "delay_ms": round(max(0.0, raw_ms), 3),
            "clamped": raw_ms < 0.0,
            "_t0": s.t0,
        }
    out = sorted(hops.values(), key=lambda h: h["_t0"])
    for h in out:
        del h["_t0"]
    return out


def critical_path(source, height: Optional[int] = None) -> dict:
    """Extract the critical path of one block lifecycle.

    The chain is assembled backward from the terminal span:

    1. **anchor** — the latest-ending block root (``prepare_proposal``
       / ``process_proposal``) for ``height`` (BlockTrace input: its
       own root); its subtree is swept over its full wall.
    2. **commit extension** — the first ``rpc.cons_commit`` span on the
       anchor's node starting at/after the anchor's end extends the
       chain through commit; the handoff gap is attributed as ``gap``
       (phase ``commit_lag``) and surfaced as ``commit_lag_ms``.
    3. **upstream** — if the anchor carries cross-node origin args, a
       ``flow`` edge covers [send, anchor start] (the propagation hop,
       clamped at 0 on skew) and, when the origin span is resolvable
       in a merged doc, the origin's subtree is swept up to the send
       timestamp with the origin→send handoff as ``gap``.

    Returns a report dict; ``attribution_ms`` sums the whole chain and
    ``root_attribution_ms`` sums only the anchor-wall segments (the
    partition identity the acceptance gate checks against
    ``root_wall_ms``).
    """
    spans, offsets = extract_spans(source)
    root_id = getattr(source, "root_id", None) if not isinstance(source, dict) else None
    if height is None and not isinstance(source, dict):
        height = getattr(source, "height", None)

    anchor = _pick_anchor(spans, height, root_id)
    if anchor is None:
        return {
            "height": height,
            "root": None,
            "steps": [],
            "total_ms": 0.0,
            "root_wall_ms": 0.0,
            "attribution_ms": {"self": 0.0, "queue_wait": 0.0, "flow": 0.0, "gap": 0.0},
            "root_attribution_ms": {
                "self": 0.0,
                "queue_wait": 0.0,
                "flow": 0.0,
                "gap": 0.0,
            },
            "gap_by_phase_ms": {},
            "top_contributors": [],
            "propagation": [],
            "clock_skew_clamped": 0,
            "unresolved_links": 0,
            "commit_lag_ms": None,
        }

    kids_of: Dict[Tuple[str, int], List[PathSpan]] = {}
    index: Dict[Tuple[str, int], PathSpan] = {}
    for s in spans:
        index[(s.node, s.span_id)] = s
        if s.parent_id:
            kids_of.setdefault((s.node, s.parent_id), []).append(s)

    walker = _Walker(kids_of, (anchor.node, anchor.span_id))
    unresolved = 0

    # --- upstream: flow edge + origin subtree (merged docs) -----------
    send_local = _send_ts_local(anchor, offsets)
    origin_key = (
        str(anchor.args.get("remote_node", "")),
        int(anchor.args.get("remote_span", 0) or 0),
    )
    origin = index.get(origin_key) if origin_key[1] else None
    if origin is None and origin_key[1]:
        unresolved += 1
    if send_local is not None:
        raw_ms = (anchor.t0 - send_local) * 1000.0
        flow_lo = min(send_local, anchor.t0)
        if origin is not None:
            walker.walk(origin, origin.t0, min(origin.t1, flow_lo), "upstream")
            if flow_lo - origin.t1 > _EPS:
                walker.segments.append(
                    {
                        "node": origin.node,
                        "name": f"{origin.name}→send",
                        "span_id": origin.span_id,
                        "kind": "gap",
                        "phase": "handoff",
                        "scope": "upstream",
                        "t0": origin.t1,
                        "t1": flow_lo,
                    }
                )
        walker.segments.append(
            {
                "node": anchor.node,
                "name": "propagation",
                "span_id": 0,
                "kind": "flow",
                "phase": "",
                "scope": "flow",
                "t0": flow_lo,
                "t1": anchor.t0,
                "clamped": raw_ms < 0.0,
            }
        )

    # --- the anchor root itself --------------------------------------
    walker.walk(anchor, anchor.t0, anchor.t1, "root")

    # --- commit extension --------------------------------------------
    commit = None
    for s in spans:
        if s.name not in COMMIT_SPAN_NAMES or s.node != anchor.node:
            continue
        if s.t0 < anchor.t1 - _EPS:
            continue
        if commit is None or s.t0 < commit.t0:
            commit = s
    commit_lag_ms = None
    if commit is not None:
        commit_lag_ms = round(max(0.0, commit.t0 - anchor.t1) * 1000.0, 3)
        if commit.t0 - anchor.t1 > _EPS:
            walker.segments.append(
                {
                    "node": anchor.node,
                    "name": "commit_handoff",
                    "span_id": 0,
                    "kind": "gap",
                    "phase": "commit_lag",
                    "scope": "commit",
                    "t0": anchor.t1,
                    "t1": commit.t0,
                }
            )
        walker.walk(commit, commit.t0, commit.t1, "commit")

    # --- assemble the report -----------------------------------------
    segments = sorted(walker.segments, key=lambda g: g["t0"])
    chain_t0 = segments[0]["t0"] if segments else anchor.t0
    attribution = {"self": 0.0, "queue_wait": 0.0, "flow": 0.0, "gap": 0.0}
    root_attribution = {"self": 0.0, "queue_wait": 0.0, "flow": 0.0, "gap": 0.0}
    gap_by_phase: Dict[str, float] = {}
    contrib: Dict[Tuple[str, str, str], float] = {}
    steps = []
    for g in segments:
        ms = (g["t1"] - g["t0"]) * 1000.0
        attribution[g["kind"]] += ms
        if g["scope"] == "root":
            root_attribution[g["kind"]] += ms
        if g["kind"] == "gap" and g["phase"]:
            gap_by_phase[g["phase"]] = gap_by_phase.get(g["phase"], 0.0) + ms
        contrib_key = (g["node"], g["name"], g["kind"])
        contrib[contrib_key] = contrib.get(contrib_key, 0.0) + ms
        steps.append(
            {
                "node": g["node"],
                "name": g["name"],
                "span_id": g["span_id"],
                "kind": g["kind"],
                "scope": g["scope"],
                "ms": round(ms, 3),
                "t0_ms": round((g["t0"] - chain_t0) * 1000.0, 3),
                "t1_ms": round((g["t1"] - chain_t0) * 1000.0, 3),
            }
        )

    top = sorted(
        (
            {"node": k[0], "name": k[1], "kind": k[2], "ms": round(v, 3)}
            for k, v in contrib.items()
        ),
        key=lambda c: c["ms"],
        reverse=True,
    )[:3]

    prop = propagation_delays(source)
    clamped = sum(1 for h in prop if h["clamped"])

    return {
        "height": anchor.args.get("height", height),
        "node": anchor.node,
        "root": {"name": anchor.name, "node": anchor.node, "span_id": anchor.span_id},
        "end": {
            "name": commit.name if commit is not None else anchor.name,
            "node": anchor.node,
            "span_id": commit.span_id if commit is not None else anchor.span_id,
        },
        "root_wall_ms": round(anchor.wall_ms, 3),
        "total_ms": round(sum(attribution.values()), 3),
        "steps": steps,
        "attribution_ms": {k: round(v, 3) for k, v in attribution.items()},
        "root_attribution_ms": {k: round(v, 3) for k, v in root_attribution.items()},
        "gap_by_phase_ms": {k: round(v, 3) for k, v in sorted(gap_by_phase.items())},
        "top_contributors": top,
        "propagation": prop,
        "propagation_delay_ms": prop[0]["delay_ms"] if prop else None,
        "clock_skew_clamped": clamped,
        "unresolved_links": unresolved,
        "commit_lag_ms": commit_lag_ms,
    }
