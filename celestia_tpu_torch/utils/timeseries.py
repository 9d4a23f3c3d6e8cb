"""Continuous telemetry: a bounded snapshot ring + declarative alerts.

The metrics plane so far is point-in-time — a scrape answers "what is
the hit rate NOW", never "has it been collapsing for five minutes" or
"when did the height stop moving".  This module adds the time axis with
the same bounded-structure discipline as the rest of the plane:

* :class:`TimeSeries` — a ring (``deque(maxlen=N)``) of periodic
  telemetry snapshots ``{"ts", "values": {name: float}}`` with
  rate/derivative queries (``rate``, ``delta``, ``rates``).  A node
  that stays up for a month holds the same few KB it held after an
  hour.
* :class:`AlertRule` / :class:`AlertEngine` — a small declarative rule
  engine over the ring.  Three kinds: ``value`` (threshold with a
  *sustained-burn* window — the predicate must hold over ``for_s``
  seconds of consecutive samples, not one noisy scrape), ``rate``
  (threshold on the per-second derivative) and ``stall`` (the metric
  has not changed for ``for_s`` — the height-stall detector).  Rules
  skip metrics a snapshot does not carry, so a CPU-only node never
  false-fires a device-memory rule and a fresh cache (no lookups yet)
  never false-fires the hit-rate floor.
* :func:`collect_node_sample` — the one snapshot builder: height,
  eds-cache hit rate, gossip breaker states, fault/degradation totals,
  trace-ring drops, device busy/occupancy + memory watermark
  (utils/devprof.py), DAS serving health (shed + samples-served
  counters, das_rows proof-cache hit rate).

Operators extend the rule set declaratively via the
``CELESTIA_TPU_TORCH_ALERT_RULES`` environment variable (a JSON list of rule
objects — the schema is the :class:`AlertRule` constructor), which is
how the profile-smoke gate trips a synthetic rule without code changes.

Served by node/server.py (``TimeSeries`` RPC + sampler thread +
``celestia_tpu_alert_firing`` exposition lines), consumed by
``query timeseries`` / ``query alerts`` (cli.py) and folded into
``cluster_health`` so a degrading node is flagged across the mesh.

Clock: :func:`telemetry.clock` — the sanctioned channel.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from celestia_tpu_torch.utils.telemetry import clock

ENV_RULES = "CELESTIA_TPU_TORCH_ALERT_RULES"

DEFAULT_MAX_SAMPLES = 720  # 1 h at a 5 s cadence, ~few KB resident

# default-rule thresholds (module constants so tests/docs can cite them)
EDS_HIT_RATE_FLOOR = 0.05
EDS_HIT_RATE_FOR_S = 120.0
BREAKERS_OPEN_FOR_S = 30.0
DEVICE_MEM_FRAC_CEIL = 0.9
DEVICE_MEM_FOR_S = 30.0
HEIGHT_STALL_FOR_S = 60.0
# Jain fairness over per-peer served DAS samples: below this the crowd
# is being served unfairly (hostile over-askers crowding light clients).
# for_s=0 — fairness is computed over cumulative counts, so one bad
# sample already summarizes sustained skew; the metric is skip-absent
# (only exists once an identified peer has been served), so anonymous
# traffic can never fire it.
DAS_FAIRNESS_FLOOR = 0.8


class TimeSeries:
    """Bounded ring of telemetry snapshots with derivative queries."""

    def __init__(self, max_samples: int = DEFAULT_MAX_SAMPLES):
        self._lock = threading.Lock()
        # snapshot dicts, oldest evicted first; celint: guarded-by(self._lock)
        self._samples: "deque[dict]" = deque(maxlen=max(2, int(max_samples)))

    def record(self, values: Dict[str, float], ts: Optional[float] = None) -> None:
        """Append one snapshot (``ts`` defaults to the sanctioned clock).
        Values must be a flat name -> number map; non-numeric entries
        are dropped so a buggy collector cannot poison the ring."""
        clean = {
            k: float(v)
            for k, v in values.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        snap = {"ts": float(ts if ts is not None else clock()), "values": clean}
        with self._lock:
            self._samples.append(snap)

    def samples(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._samples)
        if last is not None:
            out = out[-max(0, int(last)):]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def max_samples(self) -> int:
        return self._samples.maxlen or DEFAULT_MAX_SAMPLES

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()

    # -- queries -------------------------------------------------------

    def _points(self, name: str, window_s: Optional[float]) -> List[tuple]:
        pts = [
            (s["ts"], s["values"][name])
            for s in self.samples()
            if name in s["values"]
        ]
        if window_s is not None and pts:
            cutoff = pts[-1][0] - float(window_s)
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def latest(self, name: str):
        pts = self._points(name, None)
        return pts[-1][1] if pts else None

    def delta(self, name: str, window_s: Optional[float] = None):
        """last - first over the window; None with <2 points."""
        pts = self._points(name, window_s)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, window_s: Optional[float] = None):
        """Per-second derivative (last-first)/dt over the window; None
        with <2 points or a zero time span."""
        pts = self._points(name, window_s)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def rates(self, window_s: Optional[float] = None) -> Dict[str, float]:
        """Per-second derivative of EVERY metric with >=2 points — the
        ``query timeseries`` "computed rates" section."""
        names: Dict[str, None] = {}
        for s in self.samples():
            for k in s["values"]:
                names.setdefault(k)
        out: Dict[str, float] = {}
        for name in names:
            r = self.rate(name, window_s)
            if r is not None:
                out[name] = round(r, 6)
        return out


# ---------------------------------------------------------------------------
# alert rules
# ---------------------------------------------------------------------------

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
}

_KINDS = ("value", "rate", "stall")


class AlertRule:
    """One declarative rule.  ``kind``:

    * ``value`` — fires when the trailing run of consecutive samples
      satisfying ``<metric> <op> <threshold>`` spans >= ``for_s``
      seconds (``for_s=0``: the latest sample alone decides) —
      sustained-burn, not single-scrape noise.
    * ``rate`` — fires when the per-second derivative over the last
      ``for_s`` seconds (whole ring when 0) satisfies the predicate.
    * ``stall`` — fires when the metric has not CHANGED for >= ``for_s``
      seconds (>= 2 samples required); ``op``/``threshold`` unused.
    """

    __slots__ = ("name", "metric", "op", "threshold", "kind", "for_s", "severity")

    def __init__(
        self,
        name: str,
        metric: str,
        op: str = ">",
        threshold: float = 0.0,
        kind: str = "value",
        for_s: float = 0.0,
        severity: str = "warning",
    ):
        if kind not in _KINDS:
            raise ValueError(f"unknown alert kind {kind!r} (expected {_KINDS})")
        if op not in _OPS:
            raise ValueError(f"unknown alert op {op!r} (expected {tuple(_OPS)})")
        self.name = str(name)
        self.metric = str(metric)
        self.op = op
        self.threshold = float(threshold)
        self.kind = kind
        self.for_s = max(0.0, float(for_s))
        self.severity = str(severity)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "metric": self.metric,
            "op": self.op,
            "threshold": self.threshold,
            "kind": self.kind,
            "for_s": self.for_s,
            "severity": self.severity,
        }

    def _pred(self, v: float) -> bool:
        return _OPS[self.op](v, self.threshold)

    def evaluate(self, series: TimeSeries) -> dict:
        out = dict(self.to_dict())
        out.update({"firing": False, "value": None, "held_s": 0.0})
        pts = series._points(self.metric, None)
        if not pts:
            return out  # metric absent from every snapshot: never fires
        out["value"] = pts[-1][1]
        if self.kind == "rate":
            r = series.rate(self.metric, self.for_s or None)
            out["value"] = r
            out["firing"] = r is not None and self._pred(r)
            return out
        if self.kind == "stall":
            if len(pts) < 2:
                return out
            latest = pts[-1][1]
            # the stall clock starts at the FIRST sample of the trailing
            # flat run (the ring's start when every sample is flat)
            since = pts[-1][0]
            for ts, v in reversed(pts[:-1]):
                if v != latest:
                    break
                since = ts
            held = pts[-1][0] - since
            out["held_s"] = round(held, 3)
            out["firing"] = held >= self.for_s
            return out
        # value: trailing consecutive run satisfying the predicate
        run_start = None
        for ts, v in reversed(pts):
            if self._pred(v):
                run_start = ts
            else:
                break
        if run_start is None:
            return out
        held = pts[-1][0] - run_start
        out["held_s"] = round(held, 3)
        out["firing"] = held >= self.for_s
        return out


class AlertEngine:
    """An ordered rule set evaluated against one TimeSeries."""

    def __init__(self, rules: Optional[List[AlertRule]] = None):
        self._lock = threading.Lock()
        # celint: guarded-by(self._lock)
        self._rules: List[AlertRule] = list(rules or [])

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self._rules.append(rule)

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    def evaluate(self, series: TimeSeries) -> List[dict]:
        return [r.evaluate(series) for r in self.rules()]

    def firing(self, series: TimeSeries) -> List[dict]:
        return [a for a in self.evaluate(series) if a["firing"]]


def default_rules() -> List[AlertRule]:
    """The stock rule set every node serves (thresholds are the module
    constants above; each rule self-disables on platforms whose
    snapshots lack its metric)."""
    return [
        AlertRule(
            "eds_cache_hit_rate_floor",
            metric="eds_cache_hit_rate",
            op="<",
            threshold=EDS_HIT_RATE_FLOOR,
            for_s=EDS_HIT_RATE_FOR_S,
            severity="warning",
        ),
        AlertRule(
            "breakers_open",
            metric="breakers_open",
            op=">",
            threshold=0,
            for_s=BREAKERS_OPEN_FOR_S,
            severity="warning",
        ),
        AlertRule(
            # keyed on CURRENT usage (device_mem_frac), sustained: the
            # lifetime peak_frac never falls, so a rule on it would
            # latch critical forever off one transient spike
            "device_mem_watermark",
            metric="device_mem_frac",
            op=">",
            threshold=DEVICE_MEM_FRAC_CEIL,
            for_s=DEVICE_MEM_FOR_S,
            severity="critical",
        ),
        AlertRule(
            "height_stall",
            metric="height",
            kind="stall",
            for_s=HEIGHT_STALL_FOR_S,
            severity="critical",
        ),
        AlertRule(
            "degradations",
            metric="degradations",
            op=">",
            threshold=0,
            for_s=0.0,
            severity="warning",
        ),
        AlertRule(
            # swarm fairness collapse (hostile over-askers starving the
            # light tier): trips the flight recorder into an incident
            # bundle — see specs/da_serving.md "QoS lanes & per-peer
            # accounting" for the fairness definition
            "das_fairness_floor",
            metric="das_fairness_index",
            op="<",
            threshold=DAS_FAIRNESS_FLOOR,
            for_s=0.0,
            severity="warning",
        ),
    ]


def rules_from_json(text: str) -> List[AlertRule]:
    """Parse a JSON list of rule objects (the AlertRule constructor
    schema).  Raises ValueError on malformed input — rule configuration
    errors must be loud at boot, not silent at the first incident."""
    try:
        docs = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"alert rules are not valid JSON: {e}")
    if not isinstance(docs, list):
        raise ValueError("alert rules must be a JSON LIST of rule objects")
    out = []
    for i, doc in enumerate(docs):
        if not isinstance(doc, dict) or "name" not in doc or "metric" not in doc:
            raise ValueError(f"alert rule [{i}] needs at least name+metric")
        allowed = {
            "name", "metric", "op", "threshold", "kind", "for_s", "severity",
        }
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"alert rule [{i}] has unknown keys {sorted(unknown)}")
        out.append(AlertRule(**doc))
    return out


def rules_from_env() -> List[AlertRule]:
    """Operator-declared extra rules (CELESTIA_TPU_TORCH_ALERT_RULES)."""
    raw = os.environ.get(ENV_RULES, "").strip()
    if not raw:
        return []
    return rules_from_json(raw)


# ---------------------------------------------------------------------------
# SLO plane: per-phase latency budgets + dual-window burn-rate alerts
# ---------------------------------------------------------------------------

ENV_SLO = "CELESTIA_TPU_TORCH_SLO"

# Stock budgets for the block lifecycle (scorecard observations recorded
# by node/server.py): generous for the tiny-k dev path, meaningful for a
# production square.  The objective is the fraction of observations that
# must land under budget; burn rate = breach fraction / error budget.
BLOCK_E2E_BUDGET_MS = 2000.0
PROPAGATION_BUDGET_MS = 250.0
SLO_OBJECTIVE = 0.99
# Dual windows (classic multiwindow burn-rate alerting): the FAST window
# at a high burn threshold catches spikes within a couple of samples;
# the SLOW window at a low threshold catches budgets bleeding out over
# minutes.  Either tripping fires the SLO.
SLO_FAST_WINDOW_S = 60.0
SLO_SLOW_WINDOW_S = 600.0
SLO_FAST_BURN = 14.0
SLO_SLOW_BURN = 2.0


class SLO:
    """One latency budget evaluated by dual-window burn rate.

    Observations are latency samples (ms) in the node TimeSeries (e.g.
    ``block_e2e_ms`` recorded per committed height).  A sample over
    ``budget_ms`` is a breach; breach fraction over a trailing window
    divided by the error budget (1 - objective) is the burn rate.
    Firing when EITHER window exceeds its threshold; the verdict dict is
    AlertRule-shaped (``name``/``firing``/``severity``/``value``) so
    firing transitions ride the existing flight-recorder path
    unchanged.  Skip-absent contract: a metric with no points in the
    slow window never fires.
    """

    __slots__ = (
        "name",
        "metric",
        "budget_ms",
        "objective",
        "fast_window_s",
        "slow_window_s",
        "fast_burn",
        "slow_burn",
        "severity",
    )

    def __init__(
        self,
        name: str,
        *,
        metric: str,
        budget_ms: float,
        objective: float = SLO_OBJECTIVE,
        fast_window_s: float = SLO_FAST_WINDOW_S,
        slow_window_s: float = SLO_SLOW_WINDOW_S,
        fast_burn: float = SLO_FAST_BURN,
        slow_burn: float = SLO_SLOW_BURN,
        severity: str = "critical",
    ):
        if not name or not metric:
            raise ValueError("SLO needs a name and a metric")
        if budget_ms <= 0:
            raise ValueError(f"SLO {name}: budget_ms must be positive")
        if not (0.0 < objective < 1.0):
            raise ValueError(f"SLO {name}: objective must be in (0, 1)")
        if fast_window_s <= 0 or slow_window_s <= 0:
            raise ValueError(f"SLO {name}: windows must be positive")
        self.name = name
        self.metric = metric
        self.budget_ms = float(budget_ms)
        self.objective = float(objective)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.severity = severity

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "metric": self.metric,
            "kind": "slo",
            "budget_ms": self.budget_ms,
            "objective": self.objective,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn": self.fast_burn,
            "slow_burn": self.slow_burn,
            "severity": self.severity,
        }

    def _burn(self, pts: List[tuple]):
        if not pts:
            return None
        breach = sum(1 for _, v in pts if v > self.budget_ms)
        return (breach / len(pts)) / max(1e-9, 1.0 - self.objective)

    def evaluate(self, series: TimeSeries) -> dict:
        out = dict(self.to_dict())
        out.update(
            {"firing": False, "value": None, "burn_fast": None, "burn_slow": None,
             "window": ""}
        )
        slow_pts = series._points(self.metric, self.slow_window_s)
        if not slow_pts:
            return out  # metric absent: never fires
        fast_pts = series._points(self.metric, self.fast_window_s)
        bf = self._burn(fast_pts)
        bs = self._burn(slow_pts)
        out["burn_fast"] = None if bf is None else round(bf, 3)
        out["burn_slow"] = None if bs is None else round(bs, 3)
        out["value"] = out["burn_fast"] if bf is not None else out["burn_slow"]
        fast_hit = bf is not None and bf >= self.fast_burn
        slow_hit = bs is not None and bs >= self.slow_burn
        out["firing"] = fast_hit or slow_hit
        out["window"] = "fast" if fast_hit else ("slow" if slow_hit else "")
        return out


def default_slos() -> List[SLO]:
    """The stock block-lifecycle SLOs (scorecard-fed metrics)."""
    return [
        SLO(
            "block_e2e_slo",
            metric="block_e2e_ms",
            budget_ms=BLOCK_E2E_BUDGET_MS,
            severity="critical",
        ),
        SLO(
            "propagation_slo",
            metric="block_propagation_ms",
            budget_ms=PROPAGATION_BUDGET_MS,
            severity="warning",
        ),
    ]


def slos_from_json(text: str) -> List[SLO]:
    """Parse a JSON list of SLO objects (the SLO constructor schema).
    Raises ValueError on malformed input — budget configuration errors
    must be loud at boot, not silent at the first breach."""
    try:
        docs = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"SLO config is not valid JSON: {e}")
    if not isinstance(docs, list):
        raise ValueError("SLO config must be a JSON LIST of SLO objects")
    allowed = {
        "name", "metric", "budget_ms", "objective", "fast_window_s",
        "slow_window_s", "fast_burn", "slow_burn", "severity",
    }
    out = []
    for i, doc in enumerate(docs):
        if not isinstance(doc, dict) or "name" not in doc or "metric" not in doc:
            raise ValueError(f"SLO [{i}] needs at least name+metric")
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"SLO [{i}] has unknown keys {sorted(unknown)}")
        if "budget_ms" not in doc:
            raise ValueError(f"SLO [{i}] needs budget_ms")
        kw = dict(doc)
        out.append(SLO(kw.pop("name"), **kw))
    return out


def effective_slos() -> List[SLO]:
    """Stock SLOs with operator overrides applied (CELESTIA_TPU_TORCH_SLO).

    An env SLO whose name matches a stock one REPLACES it (that is the
    override path); unmatched names append.  Malformed JSON raises —
    same loud-at-boot contract as ``rules_from_json``.
    """
    slos = default_slos()
    raw = os.environ.get(ENV_SLO, "").strip()
    if not raw:
        return slos
    by_name = {s.name: i for i, s in enumerate(slos)}
    for s in slos_from_json(raw):
        if s.name in by_name:
            slos[by_name[s.name]] = s
        else:
            slos.append(s)
    return slos


# ---------------------------------------------------------------------------
# the node snapshot collector
# ---------------------------------------------------------------------------


def collect_node_sample(node) -> Dict[str, float]:
    """One flat snapshot of a node's operational signals.  Metrics a
    platform cannot answer are OMITTED (not zeroed): the alert engine's
    skip-absent contract depends on it."""
    from celestia_tpu_torch.utils import devprof, faults, lru, tracing

    values: Dict[str, float] = {}
    values["height"] = float(getattr(node, "height", 0) or 0)
    # unified cache registry: the eds hit rate is the flagship signal;
    # it is omitted until the cache has seen a counted lookup
    reg = lru.registry_stats()
    eds = reg["caches"].get("eds")
    if eds is not None and (eds["hits"] + eds["misses"]) > 0:
        values["eds_cache_hit_rate"] = float(eds["hit_rate"])
    values["cache_total_bytes"] = float(reg["total_approx_bytes"])
    # robustness ladder totals
    fs = faults.fault_stats()
    values["degradations"] = float(len(fs["degradations"]))
    values["fault_notes"] = float(
        sum(v["count"] for v in fs["notes"].values())
    )
    # gossip breakers (meshed nodes only)
    eng = getattr(node, "gossip_engine", None)
    if eng is not None:
        try:
            breakers = eng.stats().get("pull_breakers", {})
            values["breakers_open"] = float(
                sum(1 for s in breakers.values() if s != "closed")
            )
        except Exception as e:
            faults.note("timeseries.breakers", e)
    # trace-ring truncation (satellite: remote detectability)
    rs = tracing.ring_stats()
    values["trace_span_drops"] = float(rs["span_drops_total"])
    values["trace_background_depth"] = float(rs["background_depth"])
    # device plane — ONLY when dispatch bracketing is armed (tracing on
    # or a collect window open): with the bracket off nothing measures
    # busy time, and recording a hard 0.0 would read as "device idle"
    # to every occupancy alert while the chip is fully loaded.  Absent
    # means unknown; zero means measured-idle (skip-absent contract).
    # Occupancy is the INTER-PROBE delta (devprof.occupancy_probe) — the
    # since-reset aggregate decays toward zero on a long-lived node and
    # would make every alert on it meaningless; the first armed sample
    # omits it (no previous probe), like every platform-absent metric.
    if devprof.active():
        prof = devprof.device_profile()
        values["device_busy_ms_total"] = float(prof["device_busy_ms_total"])
        occ = devprof.occupancy_probe()
        if occ is not None:
            values["device_occupancy_pct"] = float(occ)
        mem = prof["mem"]
        if isinstance(mem, dict) and mem.get("bytes_in_use") is not None:
            values["device_mem_bytes_in_use"] = float(mem["bytes_in_use"])
            values["device_mem_peak_bytes"] = float(mem["peak_bytes_in_use"])
            # frac (CURRENT usage / limit) is the alertable signal —
            # peak_frac is a monotone lifetime high-water mark the allocator never
            # lowers, so a rule on it could fire forever off one spike
            if "frac" in mem:
                values["device_mem_frac"] = float(mem["frac"])
            if "peak_frac" in mem:
                values["device_mem_peak_frac"] = float(mem["peak_frac"])
    # serving-plane pressure + throughput: shed and served counters so
    # the stock rate rules can watch serving health, plus the das_rows
    # hit rate (omitted until the cache has seen a counted lookup —
    # same skip-absent contract as the eds rate)
    app = getattr(node, "app", None)
    telemetry = getattr(app, "telemetry", None)
    if telemetry is not None:
        counters, _g, _t = telemetry._snapshot()
        values["das_shed"] = float(
            counters.get("das_sample_shed", 0)
            + counters.get("das_batch_shed", 0)
        )
        values["das_samples_served"] = float(
            counters.get("das_samples_served", 0)
        )
        values["blocks_prepared"] = float(
            counters.get("eds_cache_hit_prepare", 0)
            + counters.get("eds_cache_miss_prepare", 0)
        )
    das_rows = reg["caches"].get("das_rows")
    if das_rows is not None and (das_rows["hits"] + das_rows["misses"]) > 0:
        values["das_rows_hit_rate"] = float(das_rows["hit_rate"])
    # per-peer QoS plane (node/server.py NodeService backref): gate +
    # per-lane pressure and the Jain fairness index.  Fairness is
    # skip-absent — it only exists once an identified peer has been
    # served, so the stock das_fairness_floor rule self-disables on
    # nodes serving purely anonymous traffic
    svc = getattr(node, "_das_service", None)
    if svc is not None:
        gate = svc.das_gate.stats()
        values["das_gate_inflight"] = float(gate["inflight"])
        values["das_gate_shed"] = float(gate["shed"])
        for lane, lst in (gate.get("lanes") or {}).items():
            values[f"das_lane_inflight_{lane}"] = float(lst["inflight"])
            values[f"das_lane_shed_{lane}"] = float(lst["shed"])
        fairness = svc.das_peers.fairness_index()
        if fairness is not None:
            values["das_fairness_index"] = float(fairness)
    return values
