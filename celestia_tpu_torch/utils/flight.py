"""Anomaly flight recorder: black-box incident capture on alert firing.

The alert engine (utils/timeseries.py) can SAY a node is degrading —
but when a human finally looks, the evidence has evaporated: the trace
ring rolled over, the timeseries window slid past the spike, the stacks
that were on-CPU are gone.  A production node serving millions of light
clients needs black-box incident capture, not a dashboard watcher.

This module is that recorder.  It subscribes to AlertEngine *firing
transitions* (a rule flipping not-firing -> firing; steady-state firing
never re-triggers) plus an optional slow-block threshold, and on each
trigger dumps ONE bounded on-disk **incident bundle**:

    <flight-dir>/inc-<seq>-<reason>/
        manifest.json     schema + trigger + per-file sha256 manifest
        trace.json        Chrome trace (spans + host-profiler samples,
                          utils/hostprof.merged_trace_dump — opens in
                          Perfetto as-is)
        timeseries.json   the telemetry ring window at trigger time
        metrics.prom      full Prometheus exposition text
        stacks.folded     folded host stacks (flamegraph-ready)
        faults.json       fault notes / degradations / armed points
        alerts.json       every rule verdict (firing and not)

Bundles live in a **size-capped ring of incident dirs**: at most
``max_incidents`` directories and ``max_total_bytes`` on disk, oldest
evicted first — a flapping node cannot fill the volume.  Triggers are
rate-limited (``min_interval_s``) so one bad minute produces one
bundle, not sixty.

Layering (celint R8): this is a utils/ module — it reads only other
utils surfaces (tracing, hostprof, faults, telemetry clock).  Node-side
context (height, exposition text, the timeseries window, alert
verdicts) is HANDED IN by node/server.py, which owns the recorder and
drives :meth:`FlightRecorder.on_alerts` from its sampler tick.

Served by the ``FlightList`` / ``FlightFetch`` RPCs (node/server.py),
``query incidents`` / ``query incident --out`` / ``query
cluster-incidents`` (cli.py) and the ``make incident-smoke`` gate.

Clock: :func:`telemetry.clock` — this module is on celint R3's
SANCTIONED_CHANNELS list (clock reads sanctioned, entropy still
banned: incident ids are sequence numbers, never random).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.telemetry import clock

MANIFEST_SCHEMA_VERSION = 1

DEFAULT_MAX_INCIDENTS = 8
DEFAULT_MAX_TOTAL_BYTES = 64 * 1024 * 1024
DEFAULT_MIN_INTERVAL_S = 10.0

ENV_SLOW_BLOCK_MS = "CELESTIA_TPU_TORCH_FLIGHT_SLOW_BLOCK_MS"

# every bundle carries exactly these artifacts (manifest.json is the
# index, not a member); validate_manifest pins the set
BUNDLE_FILES = (
    "trace.json",
    "timeseries.json",
    "metrics.prom",
    "stacks.folded",
    "faults.json",
    "alerts.json",
)

_ID_RE = re.compile(r"^inc-(\d{6})(?:-[a-z0-9_.-]*)?$")


def _slug(reason: str) -> str:
    out = re.sub(r"[^a-z0-9_.-]+", "-", reason.lower()).strip("-")
    return out[:48] or "incident"


def validate_manifest(doc: dict) -> List[str]:
    """Schema check of a manifest.json document (the incident-smoke
    gate): a list of problems, empty when well-formed."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["manifest is not an object"]
    if doc.get("schema_version") != MANIFEST_SCHEMA_VERSION:
        problems.append(
            f"schema_version is {doc.get('schema_version')!r} "
            f"(expected {MANIFEST_SCHEMA_VERSION})"
        )
    for field, typ in (
        ("id", str), ("reason", str), ("node_id", str), ("ts", float),
        ("height", int), ("seq", int), ("rules", list), ("files", list),
    ):
        if not isinstance(doc.get(field), typ):
            problems.append(
                f"{field!r} missing or not {typ.__name__}"
            )
    files = doc.get("files")
    if isinstance(files, list):
        names = set()
        for i, f in enumerate(files):
            if not isinstance(f, dict):
                problems.append(f"files[{i}] is not an object")
                continue
            for field in ("name", "bytes", "sha256"):
                if field not in f:
                    problems.append(f"files[{i}] lacks {field!r}")
            names.add(f.get("name"))
        for want in BUNDLE_FILES:
            if want not in names:
                problems.append(f"bundle file {want!r} not in manifest")
    return problems


class FlightRecorder:
    """The incident ring: trigger detection + bundle dump + eviction."""

    def __init__(
        self,
        root_dir: str,
        max_incidents: int = DEFAULT_MAX_INCIDENTS,
        max_total_bytes: int = DEFAULT_MAX_TOTAL_BYTES,
        min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
        slow_block_ms: Optional[float] = None,
    ):
        self.root = os.path.abspath(root_dir)
        os.makedirs(self.root, exist_ok=True)
        self.max_incidents = max(1, int(max_incidents))
        self.max_total_bytes = max(1, int(max_total_bytes))
        self.min_interval_s = max(0.0, float(min_interval_s))
        if slow_block_ms is None:
            raw = os.environ.get(ENV_SLOW_BLOCK_MS, "").strip()
            if raw:
                try:
                    slow_block_ms = float(raw)
                except ValueError:
                    slow_block_ms = None
        self.slow_block_ms = slow_block_ms
        self._lock = threading.Lock()
        # rules observed firing at the previous on_alerts tick (firing
        # TRANSITIONS trigger, steady state does not);
        # celint: guarded-by(self._lock)
        self._prev_firing: set = set()
        # last trigger timestamp (rate limit) + lifetime trigger count;
        # celint: guarded-by(self._lock)
        self._last_trigger_ts: Optional[float] = None
        self._triggered_total = 0
        # heights whose slow-block verdict was already judged;
        # celint: guarded-by(self._lock)
        self._last_slow_height = 0
        # next incident sequence number: resumes past existing dirs so a
        # restarted node never reuses an id; celint: guarded-by(self._lock)
        self._seq = self._max_existing_seq() + 1

    # -- trigger detection --------------------------------------------

    def on_alerts(
        self,
        verdicts: List[dict],
        *,
        height: int = 0,
        metrics_text: str = "",
        timeseries_snapshots: Optional[List[dict]] = None,
    ) -> Optional[str]:
        """Feed one alert-engine evaluation (the sampler tick).  A rule
        transitioning into ``firing`` triggers a bundle; returns the new
        incident id, or None."""
        firing = {v["name"] for v in verdicts if v.get("firing")}
        with self._lock:
            new = firing - self._prev_firing
            # cleared rules re-arm immediately; NEW rules are only
            # marked handled below once their bundle actually dumped —
            # a rate-limit suppression or a failed dump must retry on
            # the next tick, not silently spend the transition
            self._prev_firing &= firing
        if not new:
            return None
        inc = self.trigger(
            "alert:" + "+".join(sorted(new)),
            rules=sorted(new),
            verdicts=verdicts,
            height=height,
            metrics_text=metrics_text,
            timeseries_snapshots=timeseries_snapshots,
        )
        if inc is not None:
            with self._lock:
                self._prev_firing |= new
        return inc

    def on_block(
        self,
        height: int,
        total_ms: float,
        *,
        metrics_text: str = "",
        timeseries_snapshots: Optional[List[dict]] = None,
    ) -> Optional[str]:
        """Feed one completed block's wall time; a block over the
        slow-block threshold triggers (once per height)."""
        if self.slow_block_ms is None or total_ms <= self.slow_block_ms:
            return None
        with self._lock:
            if height <= self._last_slow_height:
                return None
        inc = self._trigger_slow_block(
            height, total_ms,
            metrics_text=metrics_text,
            timeseries_snapshots=timeseries_snapshots,
        )
        if inc is not None:
            with self._lock:
                # judged-once only after a SUCCESSFUL dump: a
                # rate-limited tick retries the same height next time
                self._last_slow_height = max(self._last_slow_height, height)
        return inc

    def _trigger_slow_block(
        self, height, total_ms, *, metrics_text, timeseries_snapshots
    ) -> Optional[str]:
        return self.trigger(
            "slow_block",
            rules=["slow_block"],
            verdicts=[
                {
                    "name": "slow_block",
                    "firing": True,
                    "value": round(total_ms, 3),
                    "threshold": self.slow_block_ms,
                }
            ],
            height=height,
            metrics_text=metrics_text,
            timeseries_snapshots=timeseries_snapshots,
        )

    # -- bundle dump ---------------------------------------------------

    def trigger(
        self,
        reason: str,
        *,
        rules: Optional[List[str]] = None,
        verdicts: Optional[List[dict]] = None,
        height: int = 0,
        metrics_text: str = "",
        timeseries_snapshots: Optional[List[dict]] = None,
    ) -> Optional[str]:
        """Dump one incident bundle NOW (rate-limited).  Returns the
        incident id, or None when suppressed by the rate limit.  A dump
        failure is reported through faults.note — the recorder must
        never take the node down with it."""
        from celestia_tpu_torch.utils import faults

        now = clock()
        with self._lock:
            if (
                self._last_trigger_ts is not None
                and now - self._last_trigger_ts < self.min_interval_s
            ):
                return None
            prev_ts = self._last_trigger_ts
            self._last_trigger_ts = now
            seq = self._seq
            self._seq += 1
            self._triggered_total += 1
        incident_id = f"inc-{seq:06d}-{_slug(reason)}"
        try:
            artifacts = self._collect(
                reason, verdicts or [], metrics_text,
                timeseries_snapshots or [],
            )
            self._write_bundle(
                incident_id, seq, reason, rules or [], height, now,
                artifacts,
            )
            self._evict()
        except Exception as e:
            faults.note("flight.dump", e)
            with self._lock:
                # a FAILED dump must not burn the rate-limit window or
                # inflate the incident counter (the seq stays consumed:
                # a half-written tmp dir may exist under the old id)
                self._last_trigger_ts = prev_ts
                self._triggered_total -= 1
            return None
        if tracing.enabled():
            tracing.instant(
                "flight.incident", cat="fault", id=incident_id,
                reason=reason[:120],
            )
        return incident_id

    def _collect(
        self, reason, verdicts, metrics_text, snapshots
    ) -> Dict[str, bytes]:
        """Build every bundle artifact in memory (no recorder lock held:
        the collectors take their own module locks).  ``metrics_text``
        and ``snapshots`` may be CALLABLES — resolved only here, so the
        no-trigger tick never pays for an exposition build."""
        from celestia_tpu_torch.utils import faults, hostprof

        if callable(metrics_text):
            metrics_text = metrics_text()
        if callable(snapshots):
            snapshots = snapshots()
        trace_doc = hostprof.merged_trace_dump()
        return {
            "trace.json": json.dumps(trace_doc).encode(),
            "timeseries.json": json.dumps(
                {"snapshots": snapshots}
            ).encode(),
            "metrics.prom": (metrics_text or "").encode(),
            "stacks.folded": hostprof.folded_text().encode(),
            "faults.json": json.dumps(
                faults.fault_stats(), default=str
            ).encode(),
            "alerts.json": json.dumps(
                {"reason": reason, "verdicts": verdicts}
            ).encode(),
        }

    def _write_bundle(
        self, incident_id, seq, reason, rules, height, ts, artifacts
    ) -> None:
        """Write tmp dir -> fsync-free rename: a torn dump (crash mid
        write) never shows up as a listable incident."""
        final = os.path.join(self.root, incident_id)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        files = []
        for name in BUNDLE_FILES:
            data = artifacts.get(name, b"")
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
            files.append(
                {
                    "name": name,
                    "bytes": len(data),
                    "sha256": hashlib.sha256(data).hexdigest(),
                }
            )
        manifest = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "id": incident_id,
            "seq": int(seq),
            "reason": str(reason)[:200],
            "rules": [str(r) for r in rules],
            "node_id": tracing.node_id(),
            "height": int(height),
            "ts": float(round(ts, 6)),
            "files": files,
            "total_bytes": sum(f["bytes"] for f in files),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        if os.path.exists(final):  # id collision cannot happen (seq is
            shutil.rmtree(final)   # monotone) except after a crash loop
        os.replace(tmp, final)

    def _evict(self) -> None:
        """Enforce the ring bounds: oldest incidents out first until both
        the count cap and the byte cap hold.  The NEWEST bundle is never
        evicted — a byte cap smaller than one bundle must not erase the
        very evidence the recorder exists to keep."""
        with self._lock:
            entries = self._scan()
            total = sum(size for _, _, size in entries)
            while len(entries) > 1 and (  # celint: allow(no-handrolled-cache) — an on-disk incident-dir ring, not an in-memory cache; LruCache cannot own directories
                len(entries) > self.max_incidents
                or total > self.max_total_bytes
            ):
                _seq, path, size = entries.pop(0)
                shutil.rmtree(path, ignore_errors=True)
                total -= size

    # -- listing / retrieval ------------------------------------------

    def _max_existing_seq(self) -> int:
        best = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        for name in names:
            if name.endswith(".tmp"):
                continue
            m = _ID_RE.match(name)
            if m:
                best = max(best, int(m.group(1)))
        return best

    def _scan(self) -> List[Tuple[int, str, int]]:
        """(seq, path, bytes) of every complete incident dir, oldest
        first.  *.tmp dirs (torn dumps) are ignored."""
        out: List[Tuple[int, str, int]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if name.endswith(".tmp"):
                continue  # torn dump mid-write: never listable
            m = _ID_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            size = 0
            for fn in os.listdir(path):
                try:
                    size += os.path.getsize(os.path.join(path, fn))
                except OSError:
                    continue
            out.append((int(m.group(1)), path, size))
        out.sort()
        return out

    def list_incidents(self) -> List[dict]:
        """Manifest summaries of every kept incident, oldest first.  A
        dir whose manifest is unreadable is reported with its error, not
        silently dropped."""
        out: List[dict] = []
        for _seq, path, size in self._scan():
            mpath = os.path.join(path, "manifest.json")
            try:
                with open(mpath) as f:
                    doc = json.load(f)
                out.append(
                    {
                        "id": doc.get("id", os.path.basename(path)),
                        "seq": doc.get("seq", _seq),
                        "reason": doc.get("reason", ""),
                        "rules": doc.get("rules", []),
                        "height": doc.get("height", 0),
                        "ts": doc.get("ts", 0.0),
                        "node_id": doc.get("node_id", ""),
                        "total_bytes": size,
                    }
                )
            except (OSError, ValueError) as e:
                out.append(
                    {
                        "id": os.path.basename(path),
                        "seq": _seq,
                        "error": str(e)[:200],
                        "total_bytes": size,
                    }
                )
        return out

    def load_bundle(self, incident_id: str) -> Optional[dict]:
        """One full bundle: ``{"manifest": dict, "files": {name: text}}``
        or None when the id is unknown.  Files are returned as TEXT (the
        bundle members are all JSON/text by construction)."""
        if not _ID_RE.match(incident_id or "") or incident_id.endswith(".tmp"):
            return None
        path = os.path.join(self.root, incident_id)
        mpath = os.path.join(path, "manifest.json")
        if not os.path.isfile(mpath):
            return None
        with open(mpath) as f:
            manifest = json.load(f)
        files: Dict[str, str] = {}
        for entry in manifest.get("files", []):
            name = entry.get("name", "")
            if name not in BUNDLE_FILES:
                continue
            try:
                with open(os.path.join(path, name), "rb") as f:
                    files[name] = f.read().decode("utf-8", "replace")
            except OSError as e:
                files[name] = f"<unreadable: {e}>"
        return {"manifest": manifest, "files": files}

    def stats(self) -> dict:
        entries = self._scan()
        with self._lock:
            return {
                "dir": self.root,
                "incidents_kept": len(entries),
                "incidents_total": self._triggered_total,
                "next_seq": self._seq,
                "total_bytes": sum(s for _, _, s in entries),
                "max_incidents": self.max_incidents,
                "max_total_bytes": self.max_total_bytes,
                "min_interval_s": self.min_interval_s,
                "slow_block_ms": self.slow_block_ms,
            }
