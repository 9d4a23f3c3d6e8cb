"""Telemetry: counters + BOUNDED latency histograms around the hot path.

Parity role: cosmos-sdk telemetry as used by the reference
(telemetry.MeasureSince in Prepare/Process at app/prepare_proposal.go:24 and
app/process_proposal.go:25, invalid-tx counters validate_txs.go:58,88,
panic counter process_proposal.go:31, mint gauges x/mint/abci.go:15,72).

Timings are fixed log2-bucket histograms (:class:`Log2Histogram`) — a
node that stays up for a million blocks holds the same few hundred bytes
per metric it held after ten, while still answering p50/p90/p95/p99/max.
The Prometheus surface exports them as proper ``histogram`` metrics
(cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), with metric and
label names escaped so a cache named ``row_memo.v2-beta`` cannot emit a
malformed exposition line.

The per-span trace aggregation (utils/tracing.py) reuses
:class:`Log2Histogram` and lands in :meth:`Telemetry.summary` under
``"spans"`` whenever the tracer is enabled.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional


def clock() -> float:
    """Wall-clock read for DURATION measurement only.  celint rule R3
    (consensus-determinism) bans direct time.* reads in state/ and da/;
    this function (and Telemetry.clock) is the sanctioned channel — a
    value obtained here feeds telemetry/bench/tracing, never consensus
    bytes."""
    return time.time()


# ---------------------------------------------------------------------------
# bounded histograms
# ---------------------------------------------------------------------------

# log2 bucket upper bounds in SECONDS: 2^-20 (~1 µs) .. 2^6 (64 s).
# 27 finite buckets + one overflow bucket; anything a block pipeline or
# an RPC does lands inside this range with <2x relative quantile error.
BUCKET_BOUNDS: tuple = tuple(2.0**e for e in range(-20, 7))


class Log2Histogram:
    """Fixed-size latency histogram (seconds): 27 log2 buckets + overflow.

    Replaces the unbounded per-metric ``List[float]`` the Telemetry
    class once accumulated — O(1) memory, O(log B) observe, and
    p50/p90/p95/p99 answered by linear interpolation inside the owning
    bucket (exact min/max/sum/count are tracked separately)."""

    __slots__ = ("counts", "count", "total", "vmax", "vmin", "_lock")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self.vmin = float("inf")
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        v = max(0.0, float(seconds))
        idx = bisect.bisect_left(BUCKET_BOUNDS, v)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.total += v
            if v > self.vmax:
                self.vmax = v
            if v < self.vmin:
                self.vmin = v

    def quantile(self, q: float) -> float:
        """Approximate q-quantile in seconds (linear interpolation within
        the owning log2 bucket, clamped to the observed min/max)."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                    hi = (
                        BUCKET_BOUNDS[i]
                        if i < len(BUCKET_BOUNDS)
                        else max(self.vmax, lo)
                    )
                    frac = (target - cum) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self.vmin), self.vmax)
                cum += c
            return self.vmax

    def summary(self) -> dict:
        with self._lock:
            count, vmax = self.count, self.vmax
        if count == 0:
            return {
                "count": 0, "p50_ms": 0.0, "p90_ms": 0.0, "p95_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0,
            }
        return {
            "count": count,
            "p50_ms": self.quantile(0.50) * 1000.0,
            "p90_ms": self.quantile(0.90) * 1000.0,
            "p95_ms": self.quantile(0.95) * 1000.0,
            "p99_ms": self.quantile(0.99) * 1000.0,
            "max_ms": vmax * 1000.0,
        }

    def prometheus_lines(self, metric: str) -> List[str]:
        """Proper histogram exposition: cumulative buckets + sum + count."""
        with self._lock:
            counts = list(self.counts)
            total, count = self.total, self.count
        lines = [f"# TYPE {metric} histogram"]
        cum = 0
        for bound, c in zip(BUCKET_BOUNDS, counts):
            cum += c
            lines.append(
                f'{metric}_bucket{{le="{format(bound, ".9g")}"}} {cum}'
            )
        lines.append(f'{metric}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{metric}_sum {total:.9g}")
        lines.append(f"{metric}_count {count}")
        return lines


# ---------------------------------------------------------------------------
# exposition hygiene
# ---------------------------------------------------------------------------

_METRIC_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_METRIC_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


# one validator for the whole tree (tests + make trace-smoke share it):
# every exposition line must be blank, a TYPE/HELP comment, or a sample
# `name{label="value",...} value`
_EXPO_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" [+-]?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$"
)
_EXPO_COMMENT_RE = re.compile(r"^# (TYPE|HELP) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")


def validate_exposition(text: str) -> List[str]:
    """Parse every line of a Prometheus text exposition; returns the
    malformed lines (empty list = valid).  The format-validity gate for
    the Metrics RPC — escaped label values and sanitized metric names
    must survive any cache/metric naming."""
    bad: List[str] = []
    for ln in text.splitlines():
        if not ln:
            continue
        if not (_EXPO_SAMPLE_RE.match(ln) or _EXPO_COMMENT_RE.match(ln)):
            bad.append(ln)
    return bad


def snake_case(name: str) -> str:
    """CamelCase RPC method name -> metric-safe snake case (Broadcast ->
    broadcast, DasSample -> das_sample).  The ONE fold shared by the
    server-side ``rpc_{method}_*`` and client-side
    ``rpc_client_{method}_*`` counter families — per-method names must
    line up for the cluster-health rollup to join them."""
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def sanitize_metric_name(name: str) -> str:
    """Fold an internal metric name (dots, dashes, anything) into a
    valid Prometheus metric name; idempotent for already-valid names."""
    out = _METRIC_BAD_CHARS.sub("_", name)
    if not out or not _METRIC_OK.match(out):
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def jain_fairness_index(values) -> Optional[float]:
    """Jain's fairness index over per-peer allocation counts:
    ``(sum x)^2 / (n * sum x^2)``.  1.0 = perfectly even, 1/n = one peer
    took everything.  Zero-allocation peers COUNT (a starved peer is the
    unfairness being measured); returns ``None`` when there is no signal
    at all (no peers, or nothing served yet) so callers can honor the
    skip-absent contract instead of reporting a fake 0."""
    xs = [max(0.0, float(v)) for v in values]
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return None
    total = sum(xs)
    return (total * total) / (len(xs) * sq)


class Telemetry:
    def __init__(self):
        # one lock over the metric MAPS (first-insert + snapshot): the
        # Metrics RPC made export/summary a concurrently-invoked remote
        # surface, and iterating a dict a producer thread is growing
        # raises mid-scrape.  Histogram counts have their own lock.
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, Log2Histogram] = defaultdict(Log2Histogram)

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def _hist(self, name: str) -> Log2Histogram:
        # defaultdict __missing__ under the lock: two threads racing the
        # first observation of one name must share ONE histogram
        with self._lock:
            return self.timings[name]

    def measure_since(self, name: str, t0: float) -> None:
        # the sanctioned clock() channel, NOT a direct time.time() read:
        # both ends of every duration go through the same auditable door
        self._hist(name).observe(clock() - t0)

    def observe(self, name: str, value_ms: float) -> None:
        """Record an externally-measured duration (milliseconds)."""
        self._hist(name).observe(value_ms / 1000.0)

    def _snapshot(self):
        with self._lock:
            return dict(self.counters), dict(self.gauges), dict(self.timings)

    def clock(self) -> float:
        """Wall-clock read for DURATION measurement only.  state/ and da/
        code must take timestamps through here (or carry a celint allow):
        celint rule R3 (consensus-determinism) bans direct time.* reads
        there, and this indirection is the auditable sanctioned channel —
        a value obtained from clock() feeds telemetry, never consensus
        bytes."""
        return clock()

    def summary(self, include_caches: bool = False) -> dict:
        counters, gauges, timings = self._snapshot()
        out: dict = {"counters": counters, "gauges": gauges}
        if include_caches:
            out["caches"] = cache_stats()
        for name, hist in timings.items():
            out[name] = hist.summary()
        # per-span aggregation from the block-lifecycle tracer: one
        # summary document answers both "how long" (timings) and "which
        # phase" (spans).  Imported lazily — tracing builds on this
        # module's clock/histograms.
        from celestia_tpu_torch.utils import tracing

        if tracing.enabled():
            spans = tracing.span_summary()
            if spans:
                out["spans"] = spans
        return out

    def export_prometheus(self) -> str:
        """Prometheus text exposition (the node-level metrics endpoint role
        — comet's DefaultMetricsProvider, test/util/testnode/full_node.go:44).
        Served over gRPC by node/server.py's ``Metrics`` RPC."""
        counters, gauges, timings = self._snapshot()
        lines: List[str] = []
        for name, val in sorted(counters.items()):
            metric = sanitize_metric_name(f"celestia_tpu_{name}_total")
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        for name, val in sorted(gauges.items()):
            metric = sanitize_metric_name(f"celestia_tpu_{name}")
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {val}")
        for name, hist in sorted(timings.items()):
            metric = sanitize_metric_name(f"celestia_tpu_{name}_seconds")
            lines.extend(hist.prometheus_lines(metric))
        # per-span duration histograms from the tracer (same bounded
        # buckets), labeled by span name
        from celestia_tpu_torch.utils import tracing

        if tracing.enabled():
            for name, hist in sorted(tracing.TRACER._agg_snapshot().items()):
                metric = sanitize_metric_name(
                    f"celestia_tpu_span_{name}_seconds"
                )
                lines.extend(hist.prometheus_lines(metric))
        # process-wide unified cache stats (utils/lru.py registry) — the
        # one-dashboard view of every bounded cache in the node
        cs = cache_stats()
        for name, agg in sorted(cs.get("caches", {}).items()):
            label = escape_label_value(name)
            for field in ("hits", "misses", "puts", "evictions"):
                metric = f"celestia_tpu_cache_{field}_total"
                lines.append(f'{metric}{{cache="{label}"}} {agg[field]}')
            for field in ("entries", "approx_bytes"):
                metric = f"celestia_tpu_cache_{field}"
                lines.append(f'{metric}{{cache="{label}"}} {agg[field]}')
        lines.append(
            f"celestia_tpu_cache_total_approx_bytes {cs['total_approx_bytes']}"
        )
        return "\n".join(lines) + "\n"


def cache_stats() -> dict:
    """Aggregated stats of every live bounded cache (utils/lru.py
    registry): per-cache hits/misses/evictions/entries/approx bytes plus
    the process-wide total against the CELESTIA_TPU_TORCH_CACHE_BUDGET_MB
    advisory budget."""
    from celestia_tpu_torch.utils import lru

    return lru.registry_stats()
