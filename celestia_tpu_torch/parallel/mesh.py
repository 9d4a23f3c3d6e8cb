"""Mesh provider: whether the block extension runs sharded, and over what.

Re-homed from ``celestia_tpu/parallel/mesh.py``.  Once per process the
provider resolves a spec into a ("data", "row") mesh of the sharded
extension (parallel/sharded.py), or into none (the single-device path):

* **Spec.**  ``configure(spec, devices)`` or the environment variable
  ``CELESTIA_TPU_TORCH_MESH``: ``"DxR"`` (data x row, e.g. ``"2x4"``),
  ``"auto"`` or ``"off"``.  An explicit factoring meshes over the devices
  given to :func:`configure` (default: the visible cards), which may
  repeat, as the tests' ``["cpu"] * 8`` does.
* **Auto.**  All cards on the row axis: ``1 x R`` with R the largest power
  of two <= ``torch.cuda.device_count()``.  Fewer than 2 cards means the
  mesh is off; there is no CPU backend to auto-mesh.
* **Per-square routing.**  :func:`mesh_for_square` returns the mesh only
  when the square's rows split over the row axis (``k >= R`` and ``k % R
  == 0``); other squares take the single-device path, counted in
  ``fallback_squares``.  That is routing, not a fault.

Not ported, as for the device plane: the poison ladder (``poison``,
``poisoned``, ``clear_poison``) and ``faults.record_degradation``.  A
malformed spec raises ``ValueError``, a spec that needs more devices than
it is given raises, and a failing sharded launch raises to the caller.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence, Tuple

import torch

ENV_MESH = "CELESTIA_TPU_TORCH_MESH"

_OFF_SPECS = ("off", "none", "0", "false", "no", "single")
_AUTO_SPECS = ("", "auto", "on", "1", "true", "yes")

# guards the state below; held across first-use resolution, so racing
# first callers share one Mesh and the constants cached under it
_lock = threading.Lock()
_configured: Optional[str] = None  # configure() override; guarded by _lock
_devices: Optional[Tuple[str, ...]] = None  # configure()'s devices; guarded by _lock
# resolved (mesh, data, row) or None, and whether it was resolved (a None
# result is cached too); guarded by _lock
_resolved: Optional[Tuple[object, int, int]] = None
_resolved_done = False
_fallback_k: int = 0  # squares routed single-device (k % row != 0)
_sharded_extends: int = 0  # squares routed through the mesh
_batched_dispatches: int = 0  # batched multi-square runs


def parse_spec(spec: str) -> Optional[Tuple[int, int]]:
    """``"DxR"`` -> (data, row); ``"off"``-family -> (0, 0) sentinel;
    ``"auto"``-family -> None.  Raises ValueError on anything else."""
    s = str(spec).strip().lower()
    if s in _AUTO_SPECS:
        return None
    if s in _OFF_SPECS:
        return (0, 0)
    parts = s.split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"mesh spec must be 'DATAxROW' (e.g. 2x4), 'auto' or 'off'; got {spec!r}"
        )
    data, row = int(parts[0]), int(parts[1])
    if data < 1 or row < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return (data, row)


def configure(spec: Optional[str], devices: Optional[Sequence] = None) -> None:
    """Set the spec (None: the environment's) and the devices an explicit
    factoring meshes over (None: the visible cards).  A malformed spec
    raises here; the cached resolution is dropped."""
    global _configured, _devices, _resolved, _resolved_done
    if spec is not None:
        parse_spec(spec)
    with _lock:
        _configured = spec
        _devices = None if devices is None else tuple(str(torch.device(d)) for d in devices)
        _resolved = None
        _resolved_done = False


def _visible_cards() -> list:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _auto_factoring() -> Optional[Tuple[int, int]]:
    """All cards on the row axis; None (off) with fewer than 2 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        return None
    row = 1
    while row * 2 <= n:
        row *= 2
    return (1, row)


def _resolve():
    """(mesh, data, row) or None from the spec, the environment or auto.
    Raises on a malformed spec and on a spec that needs more devices than
    there are.  Called with _lock held."""
    spec, devices = _configured, _devices
    if spec is None:
        spec = os.environ.get(ENV_MESH, "")
    factoring = parse_spec(spec)
    if factoring == (0, 0):
        return None
    if factoring is None:
        factoring = _auto_factoring()
        devices = None  # auto counts the cards
    if factoring is None:
        return None
    data, row = factoring
    devices = list(devices) if devices is not None else _visible_cards()
    if data * row > len(devices):
        raise ValueError(
            f"mesh spec {data}x{row} needs {data * row} devices, {len(devices)} given"
        )
    from celestia_tpu_torch.parallel.sharded import make_mesh

    return (make_mesh(devices[: data * row], data=data, row=row), data, row)


def device_mesh():
    """The process mesh, or None (the single-device path).  Resolved once;
    :func:`configure` drops the cache.  A failed resolution raises and is
    not cached."""
    global _resolved, _resolved_done
    with _lock:
        if not _resolved_done:
            _resolved = _resolve()
            _resolved_done = True
        return _resolved[0] if _resolved is not None else None


def mesh_shape() -> Optional[Tuple[int, int]]:
    """(data, row) of the active mesh, or None."""
    if device_mesh() is None:
        return None
    with _lock:
        return (_resolved[1], _resolved[2]) if _resolved is not None else None


def mesh_for_square(k: int, count_fallback: bool = True):
    """The mesh when square size ``k`` shards over the row axis (``k % row
    == 0`` and ``k >= row``), else None: the square takes the single-device
    path and is counted in ``fallback_squares`` (unless
    ``count_fallback=False``, for group probes such as
    :func:`mesh_for_batch`, whose squares are counted on their own routing)."""
    global _fallback_k
    mesh = device_mesh()
    if mesh is None:
        return None
    row = int(mesh.shape["row"])
    if k < row or k % row:
        if count_fallback:
            with _lock:
                _fallback_k += 1
        return None
    return mesh


def mesh_for_batch(k: int, n: int):
    """The mesh when a batch of ``n`` same-k squares can run the batched leg
    (the caller pads the batch to a multiple of the ``data`` axis)."""
    if n < 1:
        return None
    return mesh_for_square(k, count_fallback=False)


def record_sharded_extend(batched: bool = False, squares: int = 1) -> None:
    """Bookkeeping from the sharded entries (parallel/sharded.py)."""
    global _sharded_extends, _batched_dispatches
    with _lock:
        _sharded_extends += squares
        if batched:
            _batched_dispatches += 1


def stats() -> dict:
    """Operational snapshot."""
    with _lock:
        resolved = _resolved
        out = {
            "configured": _configured,
            "env": os.environ.get(ENV_MESH, ""),
            "resolved": _resolved_done,
            "active": resolved is not None,
            "fallback_squares": _fallback_k,
            "sharded_extends": _sharded_extends,
            "batched_dispatches": _batched_dispatches,
        }
        if resolved is not None:
            out["data"] = resolved[1]
            out["row"] = resolved[2]
        return out


def _reset_for_tests() -> None:
    """Drop all provider state (tests only: the provider resolves once per
    process by design)."""
    global _configured, _devices, _resolved, _resolved_done
    global _fallback_k, _sharded_extends, _batched_dispatches
    with _lock:
        _configured = None
        _devices = None
        _resolved = None
        _resolved_done = False
        _fallback_k = 0
        _sharded_extends = 0
        _batched_dispatches = 0
