"""Device resolution for the port's entry points.

Counterpart of ``celestia_tpu/utils/device.py`` ``host_regime`` (:21).
The JAX package falls back to a host regime when its accelerator is
absent; the port does not: an entry point given no device runs on the
card and raises when there is none.  The CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is present.  There is no CPU fallback."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
