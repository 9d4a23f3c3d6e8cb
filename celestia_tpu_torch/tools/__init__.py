"""The port's tool gates: twins of the JAX package's ``tools/*_smoke.py``.

Each is ``python -m celestia_tpu_torch.tools.<name> [--device D]``.  It
runs on the card (``cuda:0``) unless given ``--device cpu`` or
``CELESTIA_TPU_TORCH_DEVICE=cpu``; without a card and without that request
it exits 1 naming the missing card.  On success it prints the JAX tool's
summary line (the same key, e.g. ``"das_smoke": "ok"``) with the device,
and exits 0; on any failure it exits 1 with the reason on stderr.  Node
processes are ``python -m celestia_tpu_torch.cli`` with
``CELESTIA_TPU_TORCH_*`` switches.

``make lint`` and the ``make *-smoke`` targets drive the JAX package only.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Callable, List, Optional

ENV_DEVICE = "CELESTIA_TPU_TORCH_DEVICE"


def parser(prog: str, doc: Optional[str] = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"python -m celestia_tpu_torch.tools.{prog}",
        description=(doc or "").strip().splitlines()[0] if doc else None,
    )
    p.add_argument(
        "--device", default=None,
        help=f"torch device (default: {ENV_DEVICE}, else cuda:0; "
        "'cpu' runs on the host)",
    )
    return p


def resolve(requested: Optional[str]):
    """The tool's device: ``--device``, else ``CELESTIA_TPU_TORCH_DEVICE``,
    else ``cuda:0``.  Raises ``SystemExit`` naming the card when a CUDA
    device is asked for and none is present (no CPU fallback)."""
    import torch

    name = requested or os.environ.get(ENV_DEVICE, "").strip() or "cuda:0"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"no CUDA card: {dev} requested but torch.cuda.is_available() is "
            "False; pass --device cpu (or CELESTIA_TPU_TORCH_DEVICE=cpu) to "
            "run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def run(prog: str, body: Callable, argv: Optional[List[str]] = None,
        doc: Optional[str] = None, configure: Optional[Callable] = None) -> int:
    """Parse ``argv``, resolve the device and run ``body(device, args)``.

    Returns 0 when the body returns normally (it prints the summary line
    itself); 1 with the reason on stderr when it raises or the device is
    missing."""
    p = parser(prog, doc)
    if configure is not None:
        configure(p)
    args = p.parse_args(argv)
    try:
        device = resolve(args.device)
    except SystemExit as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 1
    try:
        body(device, args)
    except Exception as e:  # the gate's verdict: any failure is exit 1
        traceback.print_exc()
        print(f"{prog}: FAILED on {device}: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


def device_label(device) -> str:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{0 if dev.index is None else dev.index}"
    return "cpu"


def thread_share(n_nodes: int) -> dict:
    """The environment that gives each of ``n_nodes`` node processes on
    this host its share of the cores (the native pool and torch's intra-op
    threads), as a deployment of that many nodes on one machine sets it."""
    share = max(1, (os.cpu_count() or 1) // n_nodes)
    return {"CELESTIA_TPU_TORCH_CPU_THREADS": str(share)}


def exposition_counts(text: str) -> dict:
    """From a node's Metrics exposition: its process's kernel launches, and
    the work that predicts them -- the cold extensions of its App (the
    content cache's misses, all legs), the blocks it rebuilt for serving
    and the DAS chunks it streamed (its per-lane latency histograms'
    counts): 5 launches a cold extension or rebuilt block, one K7b a
    chunk."""
    from celestia_tpu_torch.node import cluster

    out = {"launches": {}, "misses": 0, "rebuilt": 0, "chunks": 0}
    for name, labels, value in cluster.parse_exposition(text):
        if name == "celestia_tpu_kernel_launches_total":
            out["launches"][labels["kernel"]] = int(value)
        elif name.startswith("celestia_tpu_eds_cache_miss_") and name.endswith("_total"):
            out["misses"] += int(value)
        elif name.startswith("celestia_tpu_das_latency_") and name.endswith("_seconds_count"):
            out["chunks"] += int(value)
        elif name == "celestia_tpu_block_artifacts_rebuilt_total":
            out["rebuilt"] = int(value)
    return out


def readline_deadline(proc, timeout_s: float = 180.0):
    """One stdout line from a node subprocess, bounded: a node that hangs
    before printing its startup JSON fails the gate loudly instead of
    hanging it.  A daemon reader thread and a join timeout, not select() on
    the pipe: proc.stdout is a buffered text stream, and polling its fd
    after a partial read misses data already in the Python-level buffer."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout_s)
    if not out or not out[0]:
        return None
    return out[0]


def run_leg(legs: dict, name: str, label: str) -> int:
    """Leg ``name`` of a twin on the device labelled ``label`` (``cuda:0``,
    ``cpu``): it prints its summary line and returns 0, or prints its reason
    to stderr and returns 1.  Tracing is switched off and cleared after it,
    so that an in-process caller finds it as it was."""
    from celestia_tpu_torch.utils import tracing

    try:
        return legs[name](label)
    finally:
        tracing.disable()
        tracing.clear()


def run_legs(prog: str, legs: dict, argv: Optional[List[str]] = None,
             doc: Optional[str] = None) -> int:
    """:func:`run` for a twin of legs: every leg, in order, through
    :func:`run_leg`; the first that fails fails the twin."""

    def body(device, args):
        for name in legs:
            if run_leg(legs, name, device_label(device)) != 0:
                raise RuntimeError(f"leg {name} failed (reason above)")

    return run(prog, body, argv, doc)
