"""GPU time of K3, the port's NMT level reduction (``ctt_nmt_reduce_levels``),
taken from a given tree of the port, so that two trees' kernels can be
compared in one run on one card.

The cases are K3's tree sets on the main paths: the 4k trees of one leaf
grid at k = 64 and 128 (the extension), a batch of 8 grids at k = 128 (the
catch-up), and R = 1, 5 and 256 row trees at k = 128 (the row stacks of
proofs, namespace data and DAS misses).  The inputs are seeded 90-byte
digests, the cells outside Q0 of each grid carrying the parity namespace
(so IgnoreMaxNamespace is taken where the EDS takes it).  Each case's GPU
time is the median of 5 timings of 20 calls queued behind a sleep (the
host's issue time left out), and the SHA-256 of its levels' bytes is
printed, so two trees given the same seed can be checked to agree.  Only
what the trees share is used: ``ops.nmt.grid_levels`` and
``reduce_levels``, and ``kernels.build``.

    python3 tools/torch_k3_ab.py --tree path/to/parent
    python3 tools/torch_k3_ab.py

``--tree`` is the root of a checkout (default: this one).  Prints one JSON
object: the tree, the card's name and power limit from ``nvidia-smi``, the
K3 kernel's registers, stack and spill bytes, one entry an instance
(``cuobjdump -res-usage`` of the tree's built library), and by case the
GPU times (ms) and the digest.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

QUEUE_SLEEP_CYCLES = 100_000_000  # ~50 ms at 1.98 GHz: longer than the host's issue


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import celestia_tpu_torch
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.ops import nmt

    if not os.path.abspath(celestia_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"celestia_tpu_torch imported from {celestia_tpu_torch.__file__}, "
                         f"not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K3 runs only on the card")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)

    def grids(n: int, k: int) -> torch.Tensor:
        g = rng.integers(0, 256, (n, 2 * k, 2 * k, 90), dtype=np.uint8)
        g[..., :58] = np.sort(g[..., :58], axis=-1)
        g[:, k:, :, :58] = 0xFF
        g[:, :, k:, :58] = 0xFF
        return torch.from_numpy(g).to(dev)

    g64, g128, g8 = grids(1, 64)[0], grids(1, 128)[0], grids(8, 128)
    cases = {
        "grid k=64": lambda: nmt.grid_levels(g64),
        "grid k=128": lambda: nmt.grid_levels(g128),
        "batch of 8 grids k=128": lambda: nmt.grid_levels(g8),
        **{f"rows R={R} k=128": (lambda d: lambda: nmt.reduce_levels(d))(g128[:R].contiguous())
           for R in (1, 5, 256)},
    }

    def gpu_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for name, fn in cases.items():
        h = hashlib.sha256()
        for lv in fn():
            h.update(lv.cpu().numpy().tobytes())
        times = [gpu_ms(fn) for _ in range(5)]
        out[name] = {"gpu_ms": statistics.median(times), "gpu_ms_runs": times,
                     "levels_sha256": h.hexdigest()}
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    usage = subprocess.run([tool, "-res-usage", str(kernels.build())], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    resources = [{key: int(v) for key, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", b)}
                 for a, b in zip(usage, usage[1:])
                 if a.strip().startswith("Function") and "nmt_reduce_kernel" in a]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": tree, "card": smi, "k3_resources": resources, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
