"""Device-side observability: the DEVICE half of the tracing plane.

Re-homed from ``celestia_tpu/utils/devprof.py`` for the card.  The span
tracer (utils/tracing.py) sees host wall-clock only: CUDA launches return
before the card has run them, so a host span around a launch sequence
measures its ENQUEUE time.  This module closes the gap with four
mechanisms:

* **Per-dispatch device timing** (:func:`dispatch`).  A dispatch bracket
  records a ``torch.cuda.Event`` on the device's current stream before the
  launch sequence and one after it; :meth:`Dispatch.done` synchronises the
  end event.  The events' elapsed time is recorded as a span on a
  per-device **"device" Chrome-trace track** (``thread_name=
  "device:cuda:<ordinal>"``) parented under the host span that issued the
  dispatch, with the host's enqueue and drain times in its args.  On the
  CPU the plain versions run synchronously, so the track is
  ``device:cpu:0`` and the host clock times the call.  A CUDA error at the
  synchronise raises (the JAX module notes it and returns).
* **The cost table**, in the role of the JAX module's ``note_compile`` /
  ``cost_analysis``: per dispatch name, the HBM bytes and the 32-bit
  integer operations of the least-work form of the function at the
  dispatch's shape, from the formulas below (the ones ``chip_smoke.py``
  prices its kernels with), and the bound they give on an H100.  The count
  is of the function's work, whatever kernel implements it
  (``celestia_tpu_kernel_*`` on the exposition).
* **Device-memory watermarks** (:func:`sample_memory`): each completed
  dispatch samples ``torch.cuda.memory_stats`` and the device's total
  memory; the CPU has none (a note, never an exception).
* **The transfer ledger** (:func:`record_transfer`, :func:`fetch`): every
  host<->device crossing of the plane charged to a named leg.

Activation: device-track spans ride the ONE tracing switch
(``tracing.enabled()``); a measurement leg arms the module directly with
:func:`collect`.  Inactive, :func:`dispatch` returns the shared no-op: no
event is recorded and nothing synchronises, so the launches stay async.

The optional capture (``--device-profile DIR`` /
``CELESTIA_TPU_TORCH_DEVICE_PROFILE``) wraps :func:`start_profiler` /
:func:`stop_profiler` around the node's lifetime: ``torch.profiler`` with
CPU and CUDA activities, written as a Chrome trace into DIR.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
from typing import Any, Dict, List, Optional, Tuple

from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.telemetry import (
    Log2Histogram,
    clock,
    escape_label_value,
    sanitize_metric_name,
)

ENV_PROFILE = "CELESTIA_TPU_TORCH_DEVICE_PROFILE"
PROFILE_TRACE_FILE = "torch_trace.json"

# Synthetic Chrome tid base for the per-device tracks: far above any OS
# thread id (tid = base + device ordinal).
DEVICE_TID_BASE = 1 << 40

_MAX_KERNELS = 128
_MAX_NOTES = 64
_MAX_TRANSFER_LEGS = 64

_lock = threading.Lock()
_force = False  # collection armed without the tracer
_window_t0: float = clock()  # occupancy window start (reset())
# per-device busy seconds + dispatch counts; celint: guarded-by(_lock)
_busy_s: Dict[str, float] = {}
_dispatch_counts: Dict[str, int] = {}
# per-dispatch-name cost rows; celint: guarded-by(_lock)
_kernels: Dict[str, dict] = {}
# degradation notes (platform gaps): kind -> {count, last}; celint: guarded-by(_lock)
_notes: Dict[str, dict] = {}
# per-dispatch-name device-time histograms; celint: guarded-by(_lock)
_dispatch_hist: Dict[str, Log2Histogram] = {}
# per-leg H2D/D2H transfer accounting; celint: guarded-by(_lock)
_transfers: Dict[str, dict] = {}
# last sampled memory watermark; celint: guarded-by(_lock)
_mem: Optional[dict] = None
# previous occupancy probe (ts, summed busy seconds); celint: guarded-by(_lock)
_probe_prev: Optional[Tuple[float, float]] = None
_profiler = None  # the running torch.profiler.profile
_profiler_dir: Optional[str] = None
_card: Optional[dict] = None  # nvidia-smi's name and power limit, read once


def active() -> bool:
    """True when dispatch bracketing is armed: the tracer is on or a
    :func:`collect` window is open."""
    return _force or tracing.enabled()


def note(kind: str, exc: BaseException) -> None:
    """Record a degradation note (bounded): a platform gap (no memory
    stats on the CPU, no ``nvidia-smi``) lands here."""
    with _lock:
        rec = _notes.get(kind)
        if rec is None:
            if len(_notes) >= _MAX_NOTES:
                return
            rec = _notes[kind] = {"count": 0, "last": ""}
        rec["count"] += 1
        rec["last"] = repr(exc)[:200]


def reset() -> None:
    """Drop all accounting and restart the occupancy window."""
    global _window_t0, _mem, _probe_prev
    with _lock:
        _busy_s.clear()
        _dispatch_counts.clear()
        _kernels.clear()
        _notes.clear()
        _dispatch_hist.clear()
        _transfers.clear()
        _mem = None
        _probe_prev = None
        _window_t0 = clock()


def restart_window() -> None:
    """Restart ONLY the occupancy window (busy counters + t0), keeping the
    cost table and notes: a measurement leg excludes its warm-up."""
    global _window_t0
    with _lock:
        _busy_s.clear()
        _dispatch_counts.clear()
        _window_t0 = clock()


def occupancy_probe() -> Optional[float]:
    """Busy percent of the device over the interval since the PREVIOUS
    probe call (the time-series sampler's gauge); None on the first probe
    or an empty interval."""
    global _probe_prev
    now = clock()
    with _lock:
        busy = sum(_busy_s.values())
        prev = _probe_prev
        _probe_prev = (now, busy)
    if prev is None:
        return None
    dt = now - prev[0]
    if dt <= 0:
        return None
    return round(max(0.0, min(100.0, 100.0 * (busy - prev[1]) / dt)), 2)


@contextlib.contextmanager
def collect():
    """Arm dispatch/cost collection for a scoped window without the
    tracer: stats are reset on entry and the occupancy window spans exactly
    the ``with`` body."""
    global _force
    reset()
    _force = True
    try:
        yield
    finally:
        _force = False


# ---------------------------------------------------------------------------
# the cost table's formulas (chip_smoke.py prices its kernels with these)
# ---------------------------------------------------------------------------

# H100 SXM peaks: HBM3 bandwidth from NVIDIA's data sheet; the int32 rate is
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# dense int8 tensor-core peak (NVIDIA's data sheet): the floor of the
# bit-GEMM form that K5, K5b, K8b and K9a compute
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer operations of one SHA-256 compression, counted from
# csrc/sha256.cuh as sm_90 issues them: a rotate is one funnel shift, 3-input
# logic one LOP3, and up to three addends (an immediate among them) one
# IADD3.  A schedule word is sigma0 and sigma1 (2 SHF + SHR + LOP3 each) and
# 2 IADD3 = 10; a round is Sigma1 4 + ch 1 + t1 2 + Sigma0 4 + maj 1 + e 1 +
# a 1 = 14; then 8 final adds.
SHA_OPS_PER_COMPRESSION = 48 * 10 + 64 * 14 + 8
NMT_DIGEST = 90  # ns || ns || sha256
SHARE = 512


def compressions(msg_len: int) -> int:
    """SHA-256 compressions of one message of ``msg_len`` bytes."""
    return (msg_len + 9 + 63) // 64


def leopard_extend_ops(k: int) -> int:
    """32-bit operations of the least-work form of the Leopard (leopard-ff8)
    extension, counted low: per codeword of k shares an IFFT and an FFT of
    (k/2)*log2(k) butterflies ``x ^= y*w; y ^= x`` each, on 512-byte shares,
    at 3 operations per 4-byte word (the multiply counted as one, two XORs),
    for the 3k codewords of Q1, Q2 and Q3.  The JAX package's bit-lift
    matrix form, 2*(8k)^2*3k*512 int8 operations, does far more work."""
    butterflies = 2 * (k // 2) * (k.bit_length() - 1)
    return 3 * k * butterflies * (512 // 4) * 3


def leopard_partial_ops(k: int, R: int) -> int:
    """32-bit operations of the least-work form of the R row shards'
    column-parity partials (K9a under leopard-ff8), counted low as
    ``leopard_extend_ops`` counts the extension: per shard and column
    codeword of the 2k, the IFFT inside the shard's block of m = k/R rows,
    (m/2)*log2(m) butterflies at 3 operations per 4-byte word; the k - m
    butterflies that spread it over the k points, each with one zero
    operand, at 1 (the multiply); and the FFT's (k/2)*log2(k) at 3."""
    m = k // R
    full = 3 * ((m // 2) * (m.bit_length() - 1) + (k // 2) * (k.bit_length() - 1))
    return R * 2 * k * (full + (k - m)) * (512 // 4)


def leopard_decode_ops(k: int, axes: int) -> int:
    """32-bit operations of the least-work Leopard erasure decode of
    ``axes`` codewords, counted low as ``leopard_extend_ops`` counts the
    extension: an IFFT and an FFT over the 2k positions,
    (2k/2)*log2(2k) butterflies each, at 3 operations per 4-byte word."""
    butterflies = 2 * k * ((2 * k).bit_length() - 1)
    return axes * butterflies * (512 // 4) * 3


def decode_matrix_ops(k: int, axes: int) -> int:
    """Operations of building ``axes`` Lagrange decode matrices (K8a), each
    term an XOR, a table lookup and an add: k^2 for the denominators, and
    per output row k for its numerator sum and k for its entries."""
    return axes * (k * k + 2 * (2 * k) * k) * 3


def bit_gemm_ops(rows: int, depth: int, cols: int) -> int:
    """int8 operations of a GF(2) bit-GEMM: G (rows x depth) times the
    inputs' bit planes (depth x cols), a multiply and an add each."""
    return 2 * rows * depth * cols


def bound(nbytes: float, ops: float, ops_rate: float):
    """(ms, "bytes" | "operations"): the least time of the work on an H100,
    the larger of its bytes over HBM bandwidth and its ops over ``ops_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def eds_hash_ops(k: int) -> int:
    """int32 operations of every NMT of a 2k x 2k EDS from its shares: each
    cell's leaf digest once (its row and its column tree share it), then
    the 2k - 1 inner nodes of each of the 4k trees."""
    n2 = 2 * k
    leaves = n2 * n2 * compressions(1 + 29 + SHARE)
    inner = 2 * n2 * (n2 - 1) * compressions(1 + 2 * NMT_DIGEST)
    return (leaves + inner) * SHA_OPS_PER_COMPRESSION


def root_tree_ops(k: int) -> int:
    """int32 operations of the RFC-6962 tree over the 4k axis roots: 4k leaf
    hashes and 4k - 1 inner nodes."""
    return (4 * k * compressions(1 + NMT_DIGEST) + (4 * k - 1) * compressions(65)) * (
        SHA_OPS_PER_COMPRESSION)


def extend_work(k: int, levels: bool) -> Tuple[int, int]:
    """(bytes, ops) of one block's extension and roots: the square read, the
    EDS written and, with ``levels`` (the plane's ``extend_levels``), the
    leaf digests, every NMT level and the root tree written; without, the
    4k axis roots and the data root."""
    n2 = 2 * k
    nbytes = k * k * SHARE + n2 * n2 * SHARE
    if levels:
        nbytes += n2 * n2 * NMT_DIGEST + 2 * n2 * (n2 - 1) * NMT_DIGEST + (8 * k - 1) * 32
    else:
        nbytes += 2 * n2 * NMT_DIGEST + 32
    return nbytes, leopard_extend_ops(k) + eds_hash_ops(k) + root_tree_ops(k)


def _cost_extend_levels(a):
    return extend_work(a["k"], levels=True)


def _cost_extend_sharded(a):
    n = a.get("batch", 1)
    b, o = extend_work(a["k"], levels=False)
    return n * b, n * o


def _cost_rs_extend_batched(a):
    k, n = a["k"], a["n"]
    return n * (k * k * SHARE + 4 * k * k * SHARE), n * leopard_extend_ops(k)


def _cost_das_proof_gather(a):
    # each item read once, each record written once, and the cells' triples
    return a["payload_bytes"] + a["record_bytes"] + 12 * a["cells"], 0


def _cost_rs_repair_verify(a):
    """The provided EDS and the mask read, the repaired EDS and both verdict
    masks written; the decode of the schedule's axes, the re-extension of
    Q0 and, with roots, every NMT of the result."""
    k, axes = a["k"], a["axes"]
    n2 = 2 * k
    nbytes = 2 * n2 * n2 * SHARE + 3 * n2 * n2
    ops = decode_matrix_ops(k, axes) + leopard_decode_ops(k, axes) + leopard_extend_ops(k)
    if a["roots"]:
        nbytes += 2 * n2 * NMT_DIGEST
        ops += eds_hash_ops(k)
    return nbytes, ops


def _cost_eds_nmt_roots(a):
    n2 = a["n2"]
    return n2 * n2 * SHARE + 2 * n2 * NMT_DIGEST, eds_hash_ops(n2 // 2)


def _cost_sha256_batch(a):
    n, L = a["n"], a["msg_len"]
    return n * (L + 32), n * compressions(L) * SHA_OPS_PER_COMPRESSION


# dispatch name -> (bytes, int32 ops) of its function at the dispatch's args
COSTS = {
    "extend_levels": _cost_extend_levels,
    "das_proof_gather": _cost_das_proof_gather,
    "rs_extend_batched": _cost_rs_extend_batched,
    "rs_repair_verify": _cost_rs_repair_verify,
    "eds_nmt_roots": _cost_eds_nmt_roots,
    "sha256_batch": _cost_sha256_batch,
    "extend_sharded": _cost_extend_sharded,
    "extend_sharded_batch": _cost_extend_sharded,
}


def cost_row(name: str, args: dict) -> dict:
    """The cost-table row of one dispatch: its shape, HBM bytes, int32
    operations and H100 bound."""
    nbytes, ops = COSTS[name](args)
    ms, by = bound(nbytes, ops, INT32_OPS_PER_S)
    return {"shape": {k: v for k, v in sorted(args.items()) if isinstance(v, (int, str))},
            "bytes": int(nbytes), "ops": int(ops), "bound_ms": ms, "bound_by": by}


def _note_cost(name: str, args: dict) -> None:
    row = cost_row(name, args)
    with _lock:
        if name in _kernels or len(_kernels) < _MAX_KERNELS:
            _kernels[name] = row


# ---------------------------------------------------------------------------
# dispatch bracketing (the device track)
# ---------------------------------------------------------------------------


class _NullDispatch:
    """Inactive-path dispatch: one shared instance, ``done`` is identity."""

    __slots__ = ()

    def done(self, out):
        return out


NULL_DISPATCH = _NullDispatch()


def _key(dev) -> Tuple[str, int]:
    import torch

    dev = torch.device(dev)
    if dev.type == "cuda":
        return "cuda", dev.index if dev.index is not None else torch.cuda.current_device()
    return dev.type, dev.index or 0


def _sample_memory_of(dev) -> Optional[dict]:
    """The watermark dict of one device, or None on a device without
    memory stats (the CPU: a note)."""
    global _mem
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        note("memory_stats", ValueError(f"no memory stats on {dev}"))
        return None
    stats = torch.cuda.memory_stats(dev)
    limit = int(torch.cuda.get_device_properties(dev).total_memory)
    out = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": limit,
    }
    out["frac"] = round(out["bytes_in_use"] / float(limit), 4)
    out["peak_frac"] = round(out["peak_bytes_in_use"] / float(limit), 4)
    with _lock:
        _mem = dict(out)
    return out


def sample_memory(device=None) -> Optional[dict]:
    """One watermark sample of ``device`` (default: ``cuda:0`` when a card is
    present): ``{"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
    "bytes_limit", "frac", "peak_frac"}``, or None without a card (noted)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            note("memory_stats", RuntimeError("no CUDA device"))
            return None
        device = "cuda:0"
    return _sample_memory_of(device)


class Dispatch:
    """One device dispatch bracket.  Construct BEFORE the launch sequence
    (on the card: a start event on each device's current stream); call
    :meth:`done` with its result: on the card it records the end events and
    synchronises them (a CUDA error raises), records the device-track span,
    the busy time and the memory watermark, and returns the result.

    With several devices (a mesh's sharded dispatch) one span and one busy
    contribution per device, each from its own events."""

    __slots__ = ("name", "args", "_t0", "_parent", "_devices", "_starts")

    def __init__(self, name: str, args: dict, devices):
        import torch

        self.name = name
        self.args = args
        self._parent = tracing.current()
        self._devices = []
        for d in devices:
            d = torch.device(d)
            if d not in self._devices:
                self._devices.append(d)
        self._starts = {}
        for d in self._devices:
            if d.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                self._starts[d] = ev
        self._t0 = clock()

    def done(self, out):
        import torch

        t1 = clock()  # the launches are enqueued; the card may still run them
        ends = {}
        for d, start in self._starts.items():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            ends[d] = ev
        for ev in ends.values():
            ev.synchronize()  # a CUDA error raises here
        t2 = clock()
        busy = {}
        for d in self._devices:
            if d in self._starts:
                busy[d] = self._starts[d].elapsed_time(ends[d]) / 1000.0
            else:  # the plain versions ran synchronously inside the bracket
                busy[d] = max(0.0, t2 - self._t0)
        with _lock:
            for d, sec in busy.items():
                key = "%s:%d" % _key(d)
                _busy_s[key] = _busy_s.get(key, 0.0) + sec
            _dispatch_counts[self.name] = _dispatch_counts.get(self.name, 0) + 1
            hist = _dispatch_hist.get(self.name)
            if hist is None:
                hist = _dispatch_hist[self.name] = Log2Histogram()
        for sec in busy.values():
            hist.observe(sec)
        if self.name in COSTS:
            _note_cost(self.name, self.args)
        mems = {d: _sample_memory_of(d) for d in self._devices if d.type == "cuda"}
        if tracing.enabled():
            for d, sec in busy.items():
                platform, ordinal = _key(d)
                key = f"{platform}:{ordinal}"
                span_args = dict(self.args)
                span_args["enqueue_ms"] = round((t1 - self._t0) * 1000.0, 3)
                span_args["drain_ms"] = round((t2 - t1) * 1000.0, 3)
                span_args["device_ms"] = round(sec * 1000.0, 4)
                span_args["device"] = key
                mem = mems.get(d)
                if mem is not None:
                    span_args["mem_bytes_in_use"] = mem["bytes_in_use"]
                    span_args["mem_peak_bytes"] = mem["peak_bytes_in_use"]
                # the device ran sec seconds that ended by t2 and began no
                # earlier than the first launch
                tracing.record_span(
                    f"device.{self.name}",
                    max(self._t0, t2 - sec),
                    t2,
                    parent=self._parent,
                    cat="device",
                    tid=DEVICE_TID_BASE + ordinal,
                    thread_name=f"device:{key}",
                    **span_args,
                )
        return out


def dispatch(name: str, device, multi_device: bool = False, **args) -> Any:
    """Open a dispatch bracket on ``device`` (the shared no-op when
    inactive).  ``multi_device=True`` takes a sequence of devices (a mesh's)
    and records the bracket on each of them (one span per device track)."""
    if not active():
        return NULL_DISPATCH
    return Dispatch(name, args, list(device) if multi_device else [device])


# ---------------------------------------------------------------------------
# H2D/D2H transfer accounting (the device-resident plane's ledger)
# ---------------------------------------------------------------------------


def record_transfer(leg: str, direction: str, nbytes: int, ms: float = 0.0) -> None:
    """Charge one host<->device crossing to a named leg (``direction`` is
    ``"h2d"`` or ``"d2h"``).  Bytes are computed by the caller from shapes.
    Inactive, a no-op."""
    if not active():
        return
    if direction not in ("h2d", "d2h"):
        raise ValueError(f"direction must be h2d/d2h, got {direction!r}")
    with _lock:
        rec = _transfers.get(leg)
        if rec is None:
            if len(_transfers) >= _MAX_TRANSFER_LEGS:
                return
            rec = _transfers[leg] = {
                "h2d_bytes": 0, "h2d_ms": 0.0, "h2d_events": 0,
                "d2h_bytes": 0, "d2h_ms": 0.0, "d2h_events": 0,
            }
        rec[f"{direction}_bytes"] += int(nbytes)
        rec[f"{direction}_ms"] += float(ms)
        rec[f"{direction}_events"] += 1


def fetch(leg: str, tensor, legs: Optional[List[Tuple[str, int]]] = None):
    """``tensor.cpu()`` with transfer accounting: ONE device-to-host copy,
    charged to ``leg`` with its wall ms and byte count.  ``legs`` splits one
    copy that carries several legs' bytes (``[(leg, nbytes), ...]``, in the
    copy's order) over them, the ms in proportion to the bytes."""
    if not active():
        return tensor.cpu()
    t0 = clock()
    out = tensor.cpu()
    ms = (clock() - t0) * 1000.0
    nbytes = out.numel() * out.element_size()
    for name, part in legs or [(leg, nbytes)]:
        record_transfer(name, "d2h", part, ms * part / nbytes if nbytes else 0.0)
    return out


def transfer_accounting() -> Dict[str, dict]:
    """Per-leg transfer ledger snapshot: ``{leg: {h2d_bytes, h2d_ms,
    h2d_events, d2h_bytes, d2h_ms, d2h_events}}``."""
    with _lock:
        return {
            leg: {k: (round(v, 3) if isinstance(v, float) else v) for k, v in rec.items()}
            for leg, rec in sorted(_transfers.items())
        }


# ---------------------------------------------------------------------------
# aggregate views (time series, exposition)
# ---------------------------------------------------------------------------


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them (read
    once), or ``{}`` without a card or without ``nvidia-smi`` (a note)."""
    global _card
    import torch

    if _card is not None:
        return dict(_card)
    if not torch.cuda.is_available():
        return {}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        note("nvidia_smi", e)
        return {}
    name, _, limit = line.rpartition(",")
    _card = {"name": name.strip(), "power_limit": limit.strip()}
    return dict(_card)


def device_profile() -> dict:
    """The one-document device profile: the cost table, per-dispatch counts
    and busy ms, occupancy over the current window (busy / wall, per device
    that reported busy time), the last memory watermark, the notes, and the
    device identity (the card's name, the device count, the power limit)."""
    import torch

    cuda = torch.cuda.is_available()
    with _lock:
        busy = dict(_busy_s)
        counts = dict(_dispatch_counts)
        kernels = {k: dict(v) for k, v in _kernels.items()}
        notes = {k: dict(v) for k, v in _notes.items()}
        mem = dict(_mem) if _mem is not None else None
        t0 = _window_t0
    wall_s = max(1e-9, clock() - t0)
    busy_ms_total = sum(busy.values()) * 1000.0
    out = {
        "platform": "cuda" if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 0,
        "kernels": kernels,
        "dispatches": counts,
        "device_busy_ms": {k: round(v * 1000.0, 3) for k, v in busy.items()},
        "device_busy_ms_total": round(busy_ms_total, 3),
        "window_s": round(wall_s, 3),
        "device_occupancy_pct": round(
            min(100.0, 100.0 * busy_ms_total / (wall_s * 1000.0 * max(1, len(busy)))), 2
        ),
        "mem": mem if mem is not None else {"available": False},
        "notes": notes,
    }
    if cuda:
        out["device_name"] = torch.cuda.get_device_name(0)
        out.update({f"card_{k}": v for k, v in card().items()})
    return out


def dispatch_summary() -> Dict[str, dict]:
    """Per-dispatch-name device-time aggregates (count/p50/p95/p99/max)."""
    with _lock:
        hists = dict(_dispatch_hist)
    return {name: h.summary() for name, h in sorted(hists.items())}


def exposition_lines() -> List[str]:
    """Prometheus lines for the device plane (``celestia_tpu_kernel_*`` +
    ``celestia_tpu_device_*`` + ``celestia_tpu_devprof_*``), appended to the
    node's Metrics exposition by node/server.py.  Dispatch counts and
    durations ride the span aggregates of the device spans
    (``celestia_tpu_span_device_<name>_seconds``), as in the JAX package;
    the kernel launch counts and the build wall are the port's own."""
    with _lock:
        kernels = {k: dict(v) for k, v in _kernels.items()}
        busy = dict(_busy_s)
        notes_total = sum(v["count"] for v in _notes.values())
        mem = dict(_mem) if _mem is not None else None
    lines: List[str] = []
    for name, rec in sorted(kernels.items()):
        label = escape_label_value(sanitize_metric_name(name))
        for field in ("bytes", "ops", "bound_ms"):
            lines.append(f'celestia_tpu_kernel_{field}{{kernel="{label}"}} {rec[field]}')
    for key, sec in sorted(busy.items()):
        label = escape_label_value(key)
        lines.append(f'celestia_tpu_device_busy_ms{{device="{label}"}} {round(sec * 1000.0, 3)}')
    if mem is not None:
        lines.append(f"celestia_tpu_device_mem_bytes_in_use {mem['bytes_in_use']}")
        lines.append(f"celestia_tpu_device_mem_peak_bytes {mem['peak_bytes_in_use']}")
        lines.append(f"celestia_tpu_device_mem_peak_frac {mem['peak_frac']}")
    lines.append(f"celestia_tpu_devprof_notes_total {notes_total}")
    # this process's kernel launches (kernels.launch_counts), a line for
    # each kernel launched so far, and the wall of its library build (0.0
    # when it loaded a library already built), once it loaded one: how a
    # caller reads them from another process
    from celestia_tpu_torch import kernels

    for name, n in sorted(kernels.launch_counts().items()):
        if n:
            lines.append(f'celestia_tpu_kernel_launches_total{{kernel="{name}"}} {n}')
    if kernels.build_seconds is not None:
        lines.append(f"celestia_tpu_kernel_build_seconds {kernels.build_seconds}")
    return lines


# ---------------------------------------------------------------------------
# optional torch.profiler capture (--device-profile)
# ---------------------------------------------------------------------------


def start_profiler(log_dir: str) -> bool:
    """Start a ``torch.profiler`` capture (CPU activity, and CUDA activity
    when a card is present) that :func:`stop_profiler` writes into
    ``log_dir`` as a Chrome trace (``torch_trace.json``)."""
    global _profiler, _profiler_dir
    import torch

    if _profiler is not None:
        return True  # already capturing; one session per process
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _profiler, _profiler_dir = prof, str(log_dir)
    return True


def stop_profiler() -> Optional[str]:
    """Stop the capture and write its Chrome trace; returns the trace
    file's path when one was running, None otherwise."""
    global _profiler, _profiler_dir
    if _profiler is None:
        return None
    prof, out_dir = _profiler, _profiler_dir
    _profiler = _profiler_dir = None
    prof.stop()
    path = os.path.join(out_dir, PROFILE_TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


def profiler_dir() -> Optional[str]:
    return _profiler_dir
