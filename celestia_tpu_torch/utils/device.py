"""Device resolution for the port's entry points.

Counterpart of ``celestia_tpu/utils/device.py`` (``host_regime`` :21,
``backend_available`` :66).  The JAX package falls back to its host regime
when its accelerator is absent; the port does not: an entry point given no
device runs on the card and raises when there is none.  The CPU is used
only when the caller asks for it (``device="cpu"``): the block entry
points then run the host regime (:func:`host_regime`), the JAX package's
native host legs.  JAX's ``force_host_devices_env`` (:42) sets an XLA flag
and has no counterpart: the port's mesh repeats one device instead.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is present.  There is no CPU fallback."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def host_regime(device=None) -> bool:
    """True when ``device`` resolves to the CPU: the block entry points of
    da/dah.py and ``ops/rs.py`` ``repair_square`` then run the native host
    legs (JAX :21, where the regime follows the default backend).  Nothing
    is cached: the regime is the caller's device, call by call.  Raises as
    :func:`resolve_device` does, so ``None`` without a card raises."""
    return resolve_device(device).type == "cpu"


def backend_available(timeout_s: float = 120.0, accept_cpu: bool = True) -> bool:
    """True when torch reports a device within the timeout, probed in a
    child process so that a hanging driver cannot take the caller down
    (JAX :66).  With ``accept_cpu=False`` a process with no CUDA device
    counts as unavailable."""
    code = (
        "import torch\n"
        "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
        "print('PROBE_OK', 'cuda' if n else 'cpu', n)\n"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, timeout=timeout_s
        )
    except subprocess.TimeoutExpired:
        return False
    if proc.returncode != 0:
        return False
    for line in proc.stdout.decode("utf-8", "replace").splitlines():
        if line.startswith("PROBE_OK"):
            return accept_cpu or line.split()[1] == "cuda"
    return False
