"""das-smoke: the DA serving plane's boot gate, on the port.

Twin of ``tools/das_smoke.py``.  Drives a tiny-k node end-to-end over the
REAL gRPC boundary on the device (``cuda:0``, or ``--device cpu``):

* a funded TestNode on the device commits one blob block, a NodeServer
  serves it, and a RemoteNode client pulls a multi-cell DasSampleBatch
  (chunked, so the stream path is exercised);
* every streamed proof verifies against the block's data root AND is
  byte-identical to the per-cell prover's output for the same cell;
* a second batch over the same coordinates is served WARM: on the card
  from the block's parked device entry (K7b gathers; the device-handle
  cache reports hits), on the CPU from the das_rows cache;
* a saturated gate sheds the batch with ``retry_after_ms`` and the
  RetryPolicy-driven client resumes once capacity frees;
* the Prometheus exposition stays line-parse-valid and carries the
  serving plane's ``celestia_tpu_das_*`` counters.

The JAX tool's node takes no device; this one passes it to ``TestNode``.
The port has no plane switch and no poison to check.  Exit 0 + one
summary JSON line (``"das_smoke": "ok"``, the device, the block's data
root and a digest of the served proofs) on success; 1 with the reason on
any failure.

    python -m celestia_tpu_torch.tools.das_smoke [--device cpu]
"""

from __future__ import annotations

import hashlib
import json
import sys
import threading

from celestia_tpu_torch import tools

SEED_KEY = b"das-smoke"
BLOB_SEED = 3
NAMESPACE_ID = b"\x2a" * 10
CELLS = 12


def proofs_digest(proof_dicts) -> str:
    """sha256 of the served proofs' canonical JSON, in coordinate order."""
    return hashlib.sha256(
        json.dumps(list(proof_dicts), sort_keys=True).encode()
    ).hexdigest()


def smoke(device) -> dict:
    import numpy as np

    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.da import das as das_mod
    from celestia_tpu_torch.da import eds_cache
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.node.remote import RemoteNode
    from celestia_tpu_torch.node.server import NodeServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.utils import faults
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey
    from celestia_tpu_torch.utils.telemetry import validate_exposition

    key = PrivateKey.from_seed(SEED_KEY)
    node = TestNode(funded_accounts=[(key, 10**12)], device=device)
    signer = Signer(node, key)
    data = bytes(
        np.random.default_rng(BLOB_SEED).integers(0, 256, 4000, dtype=np.uint8)
    )
    res = signer.submit_pay_for_blob([Blob(Namespace.v0(NAMESPACE_ID), data)])
    assert res.code == 0, f"blob submit failed: {res.log}"
    height = res.height
    blk = node.block(height)
    k = blk.header.square_size
    data_root = blk.header.data_hash

    on_card = device.type == "cuda"
    das_mod.rows_cache().clear()

    def warm_hits() -> int:
        # the card serves a warm block from its parked device entry, the
        # CPU from the das_rows cache
        if on_card:
            return eds_cache.device_handle_stats(device)["hits"]
        return das_mod.rows_cache().stats()["hits"]

    server = NodeServer(node, block_interval_s=None)
    server.start()
    try:
        remote = RemoteNode(server.address, timeout_s=30.0)
        try:
            lc = das_mod.LightClient(data_root, k, seed=9)
            coords = lc.pick_coordinates(CELLS)

            # cold batch over the real RPC, chunked (chunk=5 forces >= 3
            # stream messages for 12 cells)
            out = remote.das_sample_batch(height, coords, chunk=5)
            assert len(out["proofs"]) == len(coords), "short batch"
            assert bytes.fromhex(out["data_root"]) == data_root
            art = node._block_artifacts(height)
            for (r, c), d in zip(coords, out["proofs"]):
                proof = das_mod.SampleProof.from_dict(d)
                assert (proof.row, proof.col) == (r, c), "coordinate mixup"
                assert proof.verify(data_root), f"proof ({r},{c}) invalid"
                # byte-identity with the per-cell prover for every cell
                ref = das_mod._sample_proof_uncached(art["eds"], art["dah"], r, c)
                assert proof == ref, f"proof ({r},{c}) not byte-identical"

            # warm pass
            hits_before = warm_hits()
            out2 = remote.das_sample_batch(height, coords, chunk=5)
            assert out2["proofs"] == out["proofs"], "warm pass diverged"
            warm = warm_hits() - hits_before
            assert warm > 0, "warm batch hit nothing"

            # shed + resume: hold the whole gate, watch the pushback,
            # free it from a timer and let the RetryPolicy resume
            gate = server.service.das_gate
            assert gate.try_acquire(weight=gate.max_inflight)
            released = threading.Timer(
                0.05, gate.release, kwargs={"weight": gate.max_inflight}
            )
            released.start()
            try:
                out3 = remote.das_sample_batch(
                    height, coords,
                    policy=faults.RetryPolicy(
                        attempts=10, base_s=0.01, cap_s=0.05,
                        deadline_s=20.0, seed=5,
                    ),
                )
            finally:
                released.join()
            assert len(out3["proofs"]) == len(coords), "resume lost cells"
            assert out3["proofs"] == out["proofs"], "resumed batch diverged"
            assert gate.stats()["shed"] > 0, "gate never shed"

            # the exposition parses and carries the serving counters
            text = server.service.metrics_text()
            bad = validate_exposition(text)
            assert not bad, f"malformed exposition lines: {bad[:3]}"
            for needle in (
                "celestia_tpu_das_samples_served_total",
                "celestia_tpu_das_batch_calls_total",
                "celestia_tpu_das_gate_shed_total",
                "celestia_tpu_das_rows_hit_rate",
            ):
                assert needle in text, f"exposition missing {needle}"

            return {
                "das_smoke": "ok",
                "device": tools.device_label(device),
                "k": k,
                "cells": len(coords),
                "warm_hits": warm,
                "warm_from": "device_entry" if on_card else "das_rows",
                "gate_shed": gate.stats()["shed"],
                "das_rows": das_mod.rows_cache().stats(),
                "data_root": data_root.hex(),
                "proofs_sha256": proofs_digest(out["proofs"]),
                "coords": [list(c) for c in coords],
                # the process's launches and the work that predicts them
                "node_counts": [tools.exposition_counts(server.service.metrics_text())],
            }
        finally:
            remote.close()
    finally:
        server.stop()


def main(argv=None) -> int:
    return tools.run(
        "das_smoke", lambda dev, args: print(json.dumps(smoke(dev))), argv, __doc__
    )


if __name__ == "__main__":
    sys.exit(main())
