"""swarm-smoke: the serving plane's crowd gate (`make swarm-smoke`), on the port.

Twin of ``tools/swarm_smoke.py``, on the device (``cuda:0``, or ``--device
cpu``).

Points a tiny seeded swarm (~64 light clients, 8 of them hostile
over-askers) at one live QoS-enabled node over the real gRPC boundary
and asserts the fairness story end to end:

* honest light-tier requests keep a bounded p99 and a low failure rate
  while the swarm runs — lane reservation holds under crowd load;
* hostile over-askers are DEMOTED (their traffic lands in bulk/hostile
  lanes) and shed at the gate;
* per-peer + per-lane exposition lines stay parse-valid and carry the
  swarm's identities;
* an over-asker draining the idle plane collapses the Jain fairness
  index below the stock ``das_fairness_floor`` rule, and the firing
  TRANSITION trips the flight recorder into an on-disk incident bundle
  with a valid manifest.

Exit 0 + one summary JSON line (with the device) on success; 1 with the
reason on any failure.

    python -m celestia_tpu_torch.tools.swarm_smoke [--device cpu]
"""

import json
import os
import sys
import tempfile

from celestia_tpu_torch import tools


def smoke(device) -> dict:
    import numpy as np

    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.client.swarm import SwarmConfig, run_swarm
    from celestia_tpu_torch.da import das as das_mod
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.node.remote import RemoteNode
    from celestia_tpu_torch.node.server import NodeServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.utils import faults, flight as flight_mod
    from celestia_tpu_torch.utils.telemetry import validate_exposition
    from celestia_tpu_torch.utils.timeseries import DAS_FAIRNESS_FLOOR

    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    key = PrivateKey.from_seed(b"swarm-smoke")
    node = TestNode(funded_accounts=[(key, 10**12)], device=device)
    signer = Signer(node, key)
    rng = np.random.default_rng(17)
    heights = []
    for i in range(2):
        data = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
        res = signer.submit_pay_for_blob(
            [Blob(Namespace.v0(bytes([0x30 + i]) * 10), data)]
        )
        assert res.code == 0, f"blob submit failed: {res.log}"
        heights.append(res.height)
    blocks = [
        (h, node.block(h).header.square_size) for h in heights
    ]

    das_mod.rows_cache().clear()
    flight_dir = tempfile.mkdtemp(prefix="swarm-flight-")
    server = NodeServer(
        node,
        block_interval_s=None,
        das_max_inflight=4,
        das_qos=True,
        timeseries_interval_s=None,  # ticks driven explicitly below
        flight_dir=flight_dir,
    )
    # deterministic tiering for the smoke: one wide usage window covers
    # the whole run (no mid-run epoch rotation), thresholds such that a
    # hostile round-1 burst (>= 64 asked cells) demotes before round 2
    # while honest clients (<= 16 cells/round) stay light
    server.service.das_tiers = faults.TierPolicy(
        demote_rows=64, hostile_rows=512, window_s=60.0
    )
    server.start()
    try:
        # baseline tick: no identified peer served yet, so the fairness
        # metric is ABSENT (skip-absent) and the floor rule cannot fire
        # — the later firing is a real transition
        server.service.sample_timeseries()
        verdicts = server.service.alert_engine.evaluate(
            server.service.timeseries
        )
        fairness_rule = next(
            v for v in verdicts if v["name"] == "das_fairness_floor"
        )
        assert not fairness_rule["firing"], "fairness rule fired on boot"

        cfg = SwarmConfig(
            clients=64, hostile=8, rounds=3, samples_per_round=1,
            hostile_multiplier=16, batch_sizes=(4, 8, 16), churn=0.1,
            seed=7, workers=8, retry_attempts=6,
            request_deadline_s=10.0, deadline_s=120.0,
        )
        report = run_swarm(server.address, blocks, cfg)
        assert report["rounds_run"] == cfg.rounds, "swarm hit its deadline"
        light = report["groups"]["light"]
        assert light["requests"] > 0 and light["served"] > 0
        # lane reservation held: honest light traffic kept being served
        # with bounded latency while the hostile flood ran
        assert light["shed_rate"] <= 0.25, (
            f"light tier starved: {light}"
        )
        p99_light = report["latency"]["light"]["p99_ms"]
        assert 0 < p99_light < 10_000.0, f"light p99 unbounded: {p99_light}"

        gate = server.service.das_gate.stats()
        lanes = gate["lanes"]
        # hostile over-askers were demoted out of the light lane...
        demoted = (
            lanes["bulk"]["admitted"] + lanes["bulk"]["shed"]
            + lanes["hostile"]["admitted"] + lanes["hostile"]["shed"]
        )
        assert demoted > 0, f"no traffic ever left the light lane: {lanes}"
        # ...and the gate shed their flood
        assert (
            lanes["bulk"]["shed"] + lanes["hostile"]["shed"] > 0
        ), f"hostile flood never shed: {lanes}"
        assert gate["shed"] == sum(
            lst["shed"] for lst in lanes.values()
        ), "per-lane shed accounting diverged from the gate total"

        # fairness collapse: one over-asker drains the IDLE plane with
        # giant serial batches (idle-oversize admission serves them in
        # full) until its served share drags Jain below the floor
        drain = RemoteNode(server.address, timeout_s=30.0)
        try:
            fairness = server.service.das_peers.fairness_index()
            coords = [
                (int(r), int(c))
                for r in range(2 * blocks[0][1])
                for c in range(2 * blocks[0][1])
            ]
            for _ in range(40):
                if fairness is not None and fairness < DAS_FAIRNESS_FLOOR:
                    break
                out = drain.das_sample_batch(
                    blocks[0][0], coords, peer="hostile-drain-0000",
                    policy=faults.RetryPolicy(
                        attempts=10, base_s=0.01, cap_s=0.05,
                        deadline_s=20.0, seed=11,
                    ),
                )
                assert len(out["proofs"]) == len(coords)
                fairness = server.service.das_peers.fairness_index()
        finally:
            drain.close()
        assert fairness is not None and fairness < DAS_FAIRNESS_FLOOR, (
            f"fairness never collapsed: {fairness}"
        )

        # the firing transition must trip the flight recorder
        server.service.sample_timeseries()
        incidents = server.service.flight.list_incidents()
        assert incidents, "fairness collapse produced no incident bundle"
        newest = incidents[-1]
        manifest_path = os.path.join(
            flight_dir, newest["id"], "manifest.json"
        )
        with open(manifest_path, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
        problems = flight_mod.validate_manifest(manifest)
        assert not problems, f"invalid incident manifest: {problems}"
        assert "das_fairness_floor" in manifest.get("rules", []), (
            f"incident not about fairness: {manifest.get('rules')}"
        )

        # exposition: parse-valid with the swarm's identities on it
        text = server.service.metrics_text()
        bad = validate_exposition(text)
        assert not bad, f"malformed exposition lines: {bad[:3]}"
        for needle in (
            'celestia_tpu_das_lane_shed_total{lane="',
            'celestia_tpu_das_lane_inflight{lane="light"}',
            'celestia_tpu_das_peer_served_total{peer="',
            "celestia_tpu_das_fairness_index",
            "celestia_tpu_das_latency_light_seconds_bucket",
        ):
            assert needle in text, f"exposition missing {needle}"

        # the JSON probe names serving degradation without a scrape
        hz = server.service.healthz()
        assert hz["das"]["gate_shed"] >= gate["shed"], (
            "healthz das shed went backwards"
        )
        assert set(hz["das"]["lanes"]) == {"light", "bulk", "hostile"}
        assert hz["das"]["fairness_index"] < DAS_FAIRNESS_FLOOR

        return (
                {
                    "swarm_smoke": "ok",
                    "device": tools.device_label(device),
                    "clients": cfg.clients,
                    "hostile": cfg.hostile,
                    "light_p99_ms": p99_light,
                    "light_shed_rate": light["shed_rate"],
                    "lane_shed": {
                        name: lst["shed"] for name, lst in lanes.items()
                    },
                    "fairness_index": round(fairness, 4),
                    "incident": newest["id"],
                    "samples_per_s": report["samples_per_s"],
                    "data_roots": [
                        node.block(h).header.data_hash.hex() for h in heights
                    ],
                    # the process's launches and the work that predicts them
                    "node_counts": [
                        tools.exposition_counts(server.service.metrics_text())
                    ],
                }
            )
    finally:
        server.stop()


def main(argv=None) -> int:
    return tools.run(
        "swarm_smoke", lambda dev, args: print(json.dumps(smoke(dev))), argv, __doc__
    )


if __name__ == "__main__":
    sys.exit(main())
