"""Wall of the port's ``TestNode.produce_block`` on one device, with tracing
off (so devprof's brackets are inactive), taken from a given tree of the
port so that two trees can be compared in one run on one card.

Each height is filled by ten seeded PayForBlobs (1-3 blobs each, ~1.25x the
square's blob capacity in all) and two sends, signed by the tree's own
Signer and submitted to the node before the timer starts; the timer spans
``produce_block`` and a device synchronise.  Every height's data root is
returned with the walls, so two trees given the same seed can be checked to
have produced the same blocks.  Only what the trees share is used:
``TestNode``, ``Signer``, ``Blob``, ``PrivateKey`` and the mesh switch.

    python3 tools/torch_produce_ab.py --tree path/to/parent --heights 2,6
    python3 tools/torch_produce_ab.py --heights 2,6

``--tree`` is the root of a checkout (default: this one); ``--heights``
the heights at k = 64 and at k = 128 (the first of each size takes its first
allocations and is kept out of the medians).  Prints one JSON object:
the tree, the device, the card's name and power limit from ``nvidia-smi``,
each height's wall (ms) and data root by k, and the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PFBS = 10  # PayForBlobs a height
GENESIS_NS = 1_700_000_000 * 10**9


def pfb_blobs(rng, Blob, Namespace, k: int, n: int) -> list:
    per_blob = int(1.25 * k * k * 478 / (2 * n))
    return [tuple(Blob(Namespace.v0(b"\x01" + rng.bytes(9)),
                       rng.bytes(int(rng.integers(per_blob // 2, 3 * per_blob // 2))))
                  for _ in range(int(rng.integers(1, 4))))
            for _ in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--heights", default="2,6", help="heights at k=64 and at k=128")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import celestia_tpu_torch
    from celestia_tpu_torch.client.signer import Signer, SubmitResult
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.parallel import mesh
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils import tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    if not os.path.abspath(celestia_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"celestia_tpu_torch imported from {celestia_tpu_torch.__file__}, "
                         f"not from {tree}")

    class BroadcastOnly(Signer):
        """The Signer without its confirmation poll: this script cuts the blocks."""

        def confirm_tx(self, tx_hash, **kw):
            return SubmitResult(0, "", tx_hash)

    dev = torch.device(args.device)
    n64, n128 = (int(x) for x in args.heights.split(","))
    plan = [64] * n64 + [128] * n128
    rng = np.random.default_rng(args.seed)
    keys = [PrivateKey.from_seed(b"produce-ab-%d" % i) for i in range(PFBS * len(plan))]
    senders = [PrivateKey.from_seed(b"produce-ab-send-%d" % i) for i in range(2)]
    validator = PrivateKey.from_seed(b"produce-ab-validator")
    genesis = {
        "chain_id": "produce-ab-1", "genesis_time_ns": GENESIS_NS, "codec": "leopard-ff8",
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**13}
                     for k in keys + senders],
        "validators": [{"address": validator.public_key().address().hex(),
                        "self_delegation": 10**9}],
        "params": {"blob": {"GovMaxSquareSize": max(plan)}},
    }
    tracing.disable()
    mesh.configure("off")
    node = TestNode(chain_id="produce-ab-1", genesis=genesis, validator_key=validator,
                    device=dev, auto_produce=False)
    send_signers = [BroadcastOnly(node, k) for k in senders]
    walls, roots = {}, {}
    for i, k in enumerate(plan):
        if node.app.blob.gov_max_square_size() != k:
            node.app.params.set("blob", "GovMaxSquareSize", k)
        for key, blobs in zip(keys[i * PFBS:(i + 1) * PFBS],
                              pfb_blobs(rng, Blob, Namespace, k, PFBS)):
            res = BroadcastOnly(node, key).submit_pay_for_blob(list(blobs))
            if res.code != 0:
                raise SystemExit(f"a PayForBlobs was refused: {res.log}")
        for s in send_signers:
            res = s.submit_tx([MsgSend(s.address, rng.bytes(20), int(rng.integers(1, 10**4)))])
            if res.code != 0:
                raise SystemExit(f"a send was refused: {res.log}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        blk = node.produce_block()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.setdefault(k, []).append((time.perf_counter() - t0) * 1e3)
        roots.setdefault(k, []).append(blk.header.data_hash.hex())
        if blk.header.square_size != k:
            raise SystemExit(f"height {blk.header.height} filled to {blk.header.square_size}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() if dev.type == "cuda" else ""
    print(json.dumps({
        "tree": tree, "device": str(dev), "card": smi, "produce_ms": walls,
        "median_ms": {k: statistics.median(v[1:]) for k, v in walls.items() if len(v) > 1},
        "data_roots": roots,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
