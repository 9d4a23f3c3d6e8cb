"""device-resident-smoke: the device-resident DA plane's boot gate, on the port.

Twin of ``tools/device_resident_smoke.py``.  Drives ONE block through the
plane's lifecycle with the devprof transfer ledger armed:

* on the card (``cuda:0``): a funded TestNode on the card commits one blob
  block -- prepare AND process go through da/device_plane.py (the plane
  is how the card extends), so the committed block's entry is parked in
  da/eds_cache.py for the card;
* with ``--device cpu``: a TestNode on the CPU runs the host regime and
  parks nothing, so the twin commits the block there and then drives the
  plane directly, ``device_plane.extend_and_header(square,
  device="cpu")`` on the committed square (its data root held to the
  block's), as the tests do; the summary says so (``"plane":
  "direct"``);
* a multi-cell DAS batch is served from the parked entry as K7b gathers
  (one launch a batch on the card; the host prover is never called),
  every proof byte-identical to the host ``_sample_proof_uncached``
  reference and verifying against the root;
* the merged ledger shows NO hot-path D2H beyond the contract
  (``hot_path_d2h_legs`` within ``{data_root, roots, proof_gather}``; the
  port fetches the roots and the data root in one copy but keeps the two
  legs);
* the port's celint R7 (host-sync, re-homed for torch) passes over the
  port with ZERO allow pragmas in ``da/device_plane.py``.

The port has no plane switch and no poison, so the JAX tool's
``enabled()`` and ``poisoned()`` asserts have no counterpart.  Exit 0 +
one summary JSON line (with the device) on success; 1 with the reason on
any failure.

    python -m celestia_tpu_torch.tools.device_resident_smoke [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys

from celestia_tpu_torch import tools
from celestia_tpu_torch.tools import das_smoke

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED_KEY = b"device-resident-smoke"
BLOB_SEED = 6
NAMESPACE_ID = b"\x2b" * 10
CELLS = 12


def smoke(device) -> dict:
    import numpy as np

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.da import das as das_mod
    from celestia_tpu_torch.da import device_plane, eds_cache
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.utils import devprof
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    on_card = device.type == "cuda"
    eds_cache.clear()
    das_mod.reset_host_prover_calls()
    with devprof.collect():
        key = PrivateKey.from_seed(SEED_KEY)
        node = TestNode(funded_accounts=[(key, 10**12)], device=device)
        signer = Signer(node, key)
        data = bytes(
            np.random.default_rng(BLOB_SEED).integers(0, 256, 4000, dtype=np.uint8)
        )
        res = signer.submit_pay_for_blob([Blob(Namespace.v0(NAMESPACE_ID), data)])
        assert res.code == 0, f"blob submit failed: {res.log}"
        blk = node.block(res.height)
        k = blk.header.square_size
        data_root = blk.header.data_hash
        art = node._block_artifacts(res.height)
        if on_card:
            # prepare/process both ran through the plane: the committed
            # block's entry is parked for the card
            eds, dah = art["eds"], art["dah"]
        else:
            # the host regime parks nothing: the plane, called directly on
            # the committed square, parks the entry for the CPU
            square = np.asarray(art["square"].to_array()).reshape(k, k, -1)
            eds, dah = device_plane.extend_and_header(square, device="cpu")
            assert dah.hash == data_root, "the plane's data root differs from the block's"
        entry = eds_cache.get_device_entry(data_root, device)
        assert entry is not None, "committed block not device-warm"
        assert entry.data_root == data_root

        # the DAS batch is served as K7b gathers from the parked entry,
        # byte-identical to the host reference for EVERY cell
        lc = das_mod.LightClient(data_root, k, seed=11)
        coords = lc.pick_coordinates(CELLS)
        stats_before = eds_cache.device_handle_stats(device)
        gathers_before = kernels.launch_counts()["das_proof_gather"]
        proofs = das_mod.sample_proofs_batch(eds, dah, coords)
        gathers = kernels.launch_counts()["das_proof_gather"] - gathers_before
        for (r, c), p in zip(coords, proofs):
            assert (p.row, p.col) == (r, c), "coordinate mixup"
            assert p.verify(data_root), f"proof ({r},{c}) invalid"
            ref = das_mod._sample_proof_uncached(art["eds"], art["dah"], r, c)
            assert p == ref, f"proof ({r},{c}) not byte-identical"
        served_warm = (
            eds_cache.device_handle_stats(device)["hits"] - stats_before["hits"]
        )
        assert served_warm > 0, "batch never touched the device entry"
        assert das_mod.host_prover_calls() == 0, "the host prover served the batch"
        if on_card:
            assert gathers == 1, f"{gathers} K7b launches for one batch"

        ledger = devprof.transfer_accounting()

    # the D2H contract: nothing beyond the data root, the axis roots and
    # the batched proof-path gather crosses on the hot path
    d2h_legs = sorted(leg for leg, rec in ledger.items() if rec["d2h_events"])
    allowed = {"data_root", "roots", "proof_gather"}
    assert set(d2h_legs) <= allowed, (
        f"unexpected hot-path D2H legs: {sorted(set(d2h_legs) - allowed)}"
    )
    assert "data_root" in d2h_legs, "data-root fetch never recorded"
    assert "proof_gather" in d2h_legs, "proof gather never recorded"

    # the port's R7 over the port, and ZERO host-sync allow pragmas in the
    # device plane
    from celestia_tpu_torch.lint.engine import failing, run_lint

    findings = run_lint(None, ["r7"])
    assert not failing(findings), [
        f"{f.path}:{f.line} {f.message}" for f in failing(findings)
    ]
    with open(os.path.join(REPO, "celestia_tpu_torch", "da", "device_plane.py")) as f:
        assert "celint: allow" not in f.read(), (
            "device_plane.py grew a lint allow pragma"
        )

    return {
        "device_resident_smoke": "ok",
        "device": tools.device_label(device),
        "plane": "block path" if on_card else "direct",
        "k": k,
        "cells": len(coords),
        "data_root": data_root.hex(),
        "coords": [list(c) for c in coords],
        "proofs_sha256": das_smoke.proofs_digest(p.to_dict() for p in proofs),
        "hot_path_d2h_legs": d2h_legs,
        "d2h_bytes": {leg: ledger[leg]["d2h_bytes"] for leg in d2h_legs},
        "device_cache": eds_cache.device_handle_stats(device),
        "entry_nbytes": entry.nbytes,
        "das_batches": 1,
        "das_gathers": gathers,
        "node_counts": [dict(
            tools.exposition_counts(node.app.telemetry.export_prometheus()),
            launches=kernels.launch_counts(),
        )],
    }


def main(argv=None) -> int:
    return tools.run(
        "device_resident_smoke",
        lambda dev, args: print(json.dumps(smoke(dev))), argv, __doc__,
    )


if __name__ == "__main__":
    sys.exit(main())
