"""critpath-smoke: the block-lifecycle critical-path acceptance gate, on
the port.

Twin of ``tools/critpath_smoke.py``.  Every node is a ``python -m
celestia_tpu_torch.cli`` process on the device (``cuda:0``, or ``--device
cpu``) under ``CELESTIA_TPU_TORCH_DEVICE``, ``CELESTIA_TPU_TORCH_TRACE``,
``CELESTIA_TPU_TORCH_NODE_ID`` and ``CELESTIA_TPU_TORCH_SLO``, each with its
share of the host's cores.

Leg 1 (mesh): spins two traced validator subprocesses, drives ONE real
block through the ProcessCoordinator, merges the dumps and gates on the
analyzer over the REAL merged doc:

* the critical path is non-empty and ends at ``rpc.cons_commit``,
* the per-hop propagation delay is strictly positive (the ``_tc`` send
  timestamp landed on the collector axis via the clock-probe offset),
* the attribution partition identity holds: self + queue_wait + flow +
  gap over the anchor root's wall sums to ``root_wall_ms`` within 1%,
* both nodes serve a ``BlockScorecard`` row for the height (proposer
  with ``prepare_ms``, validator with ``process_ms``), and
* ``mesh_waterfall`` NAMES the slowest validator, and the
  ``celestia_tpu_torch.tools.critpath_report`` CLI renders the same doc (both text and
  ``--json``) without error.

Leg 2 (SLO): one node with the flight recorder armed and a deliberately
impossible ``block_e2e_slo`` budget injected via CELESTIA_TPU_TORCH_SLO
(0.001 ms — every real block breaches).  One real block must make the
burn-rate verdict fire and transition the flight recorder: ``query
incidents`` lists a bundle whose reason names ``block_e2e_slo``, the
fetched manifest passes ``flight.validate_manifest``, the bundled
trace passes ``tracing.validate_chrome_trace`` AND contains the
offending block's ``prepare_proposal`` span, ``query block-scorecard``
serves the height's row, and ``/healthz`` answers degraded with the
SLO named and a ``block`` section carrying the height.

Exit 0 + one summary JSON line per leg (with the device and each node's
launch counts) on success; 1 with the reason on any failure.

    python -m celestia_tpu_torch.tools.critpath_smoke [--device cpu]
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from celestia_tpu_torch import tools

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# every block breaches a 0.001 ms budget; fast burn 1.0 at objective
# 0.5 means a single breach in the 60 s window fires the verdict
TIGHT_SLO = {
    "name": "block_e2e_slo",
    "metric": "block_e2e_ms",
    "budget_ms": 0.001,
    "objective": 0.5,
    "fast_window_s": 60.0,
    "slow_window_s": 600.0,
    "fast_burn": 1.0,
    "slow_burn": 1.5,
    "severity": "critical",
}




def _env(device, extra=None):
    env = {
        **os.environ,
        "CELESTIA_TPU_TORCH_DEVICE": device,
        "CELESTIA_TPU_TORCH_TRACE": "1",
    }
    env.update(extra or {})
    return env


def _cli(env, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )


def _stop_all(procs, clients):
    for c in clients:
        c.close()
    for proc in procs:
        proc.send_signal(signal.SIGINT)
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


def mesh_leg(device: str) -> int:
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.node import cluster
    from celestia_tpu_torch.node.coordinator import (
        PeerValidator,
        ProcessCoordinator,
    )
    from celestia_tpu_torch.utils import critpath, tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    base = tempfile.mkdtemp(prefix="critpath-smoke-")
    keys = [PrivateKey.from_seed(b"critpath-smoke-%d" % i) for i in range(2)]
    genesis = {
        "chain_id": "critpath-smoke",
        "genesis_time_ns": 1_700_000_000_000_000_000,
        "accounts": [
            {"address": k.public_key().address().hex(), "balance": 10**12}
            for k in keys
        ],
        "validators": [
            {
                "address": k.public_key().address().hex(),
                "self_delegation": 100_000_000,
            }
            for k in keys
        ],
    }
    shared = os.path.join(base, "genesis.json")
    with open(shared, "w") as f:
        json.dump(genesis, f)

    env = _env(device)
    procs, clients = [], []
    try:
        for i in range(2):
            home = os.path.join(base, f"val{i}")
            r = _cli(
                env, "--home", home, "init",
                "--chain-id", "critpath-smoke", "--genesis", shared,
            )
            if r.returncode != 0:
                print(f"critpath-smoke: init failed: {r.stderr}",
                      file=sys.stderr)
                return 1
            with open(
                os.path.join(home, "config", "priv_validator_key.json"), "w"
            ) as f:
                json.dump({"priv_key": f"{keys[i].d:064x}"}, f)
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "celestia_tpu_torch.cli",
                    "--home", home, "start", "--validator",
                    "--grpc-address", "127.0.0.1:0",
                    "--warm-squares", "",
                ],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, cwd=REPO,
                env={**env, "CELESTIA_TPU_TORCH_NODE_ID": f"val-{i}",
                     **tools.thread_share(2)},
            )
            line = tools.readline_deadline(proc)
            if line is None or proc.poll() is not None:
                why = "died" if proc.poll() is not None else "hung"
                proc.kill()
                print(f"critpath-smoke: validator {i} {why} at startup",
                      file=sys.stderr)
                return 1
            procs.append(proc)
            clients.append(
                RemoteNode(json.loads(line)["grpc"], timeout_s=120.0)
            )

        coord = ProcessCoordinator(
            [
                PeerValidator(name=f"val-{i}", client=c)
                for i, c in enumerate(clients)
            ]
        )
        coord.produce_block()
        height = max(c.status()["height"] for c in clients)

        merged = cluster.cluster_trace(clients)
        problems = tracing.validate_chrome_trace(merged)
        if problems:
            print(f"critpath-smoke: invalid merged trace: {problems[:5]}",
                  file=sys.stderr)
            return 1

        report = critpath.critical_path(merged)
        if not report["root"] or not report["steps"]:
            print(f"critpath-smoke: empty critical path: {report}",
                  file=sys.stderr)
            return 1
        if report["end"]["name"] not in critpath.COMMIT_SPAN_NAMES:
            print(
                "critpath-smoke: chain does not end at commit "
                f"(end={report['end']})",
                file=sys.stderr,
            )
            return 1
        delay = report["propagation_delay_ms"]
        if delay is None or delay <= 0.0:
            print(
                f"critpath-smoke: no positive propagation delay ({delay!r}; "
                f"hops={report['propagation']})",
                file=sys.stderr,
            )
            return 1
        # the acceptance identity: the anchor-root segments partition
        # the root span's wall (1% tolerance on float/round noise)
        ra = sum(report["root_attribution_ms"].values())
        wall = report["root_wall_ms"]
        if abs(ra - wall) > max(0.01 * wall, 0.01):
            print(
                f"critpath-smoke: attribution leak: sum {ra:.3f} ms vs "
                f"root wall {wall:.3f} ms",
                file=sys.stderr,
            )
            return 1

        # both nodes serve a scorecard row for the height, each with the
        # leg IT saw (proposer: prepare; validator: process + the hop)
        cards = [c.block_scorecard() for c in clients]
        by_height = [
            {r["height"]: r for r in card["rows"]} for card in cards
        ]
        rows = [bh.get(height) for bh in by_height]
        if any(r is None for r in rows):
            print(
                f"critpath-smoke: missing scorecard row for h={height}: "
                f"{cards}",
                file=sys.stderr,
            )
            return 1
        if not any(r.get("prepare_ms") for r in rows) or not any(
            r.get("process_ms") for r in rows
        ):
            print(f"critpath-smoke: scorecard legs incomplete: {rows}",
                  file=sys.stderr)
            return 1
        if all(r.get("e2e_ms", 0.0) <= 0.0 for r in rows):
            print(f"critpath-smoke: zero e2e rollup: {rows}",
                  file=sys.stderr)
            return 1

        wf = cluster.mesh_waterfall(merged)
        wf_rows = [r for r in wf["heights"] if r["height"] == height]
        if not wf_rows or not wf_rows[0].get("slowest_validator"):
            print(f"critpath-smoke: waterfall did not name a slowest "
                  f"validator: {wf}", file=sys.stderr)
            return 1
        if not wf_rows[0].get("proposer") or not wf_rows[0]["validators"]:
            print(f"critpath-smoke: waterfall row incomplete: {wf_rows[0]}",
                  file=sys.stderr)
            return 1

        # the report CLI renders the same doc from a file, both modes
        doc_path = os.path.join(base, "merged.json")
        with open(doc_path, "w") as f:
            json.dump(merged, f)
        for extra in ([], ["--json"]):
            r = subprocess.run(
                [sys.executable, "-m", "celestia_tpu_torch.tools.critpath_report",
                 "--trace", doc_path, *extra],
                capture_output=True, text=True, timeout=120,
                cwd=REPO, env=env,
            )
            if r.returncode != 0:
                print(f"critpath-smoke: report CLI failed: {r.stderr}",
                      file=sys.stderr)
                return 1
        if "critical path:" not in r.stdout.replace('"', "") and (
            not json.loads(r.stdout)["critical_path"]["steps"]
        ):
            print("critpath-smoke: report CLI emitted no critical path",
                  file=sys.stderr)
            return 1

        print(
            json.dumps(
                {
                    "critpath_smoke_mesh": "ok",
                    "device": device,
                    "height": height,
                    "trace_file": doc_path,
                    "node_counts": [
                        tools.exposition_counts(c.metrics()) for c in clients
                    ],
                    "end": report["end"]["name"],
                    "root_wall_ms": wall,
                    "attribution_ms": report["attribution_ms"],
                    "propagation_delay_ms": delay,
                    "clock_skew_clamped": report["clock_skew_clamped"],
                    "slowest_validator": wf_rows[0]["slowest_validator"],
                }
            )
        )
        return 0
    finally:
        _stop_all(procs, clients)


def slo_leg(device: str) -> int:
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.utils import flight as flight_mod
    from celestia_tpu_torch.utils import tracing

    base = tempfile.mkdtemp(prefix="critpath-smoke-slo-")
    flight_dir = os.path.join(base, "flight")
    env = _env(device, {
        "CELESTIA_TPU_TORCH_SLO": json.dumps([TIGHT_SLO]),
        "CELESTIA_TPU_TORCH_NODE_ID": "critpath-slo-node",
    })
    home = os.path.join(base, "node")
    r = _cli(env, "--home", home, "init", "--chain-id", "critpath-slo")
    if r.returncode != 0:
        print(f"critpath-smoke: slo init failed: {r.stderr}", file=sys.stderr)
        return 1
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "celestia_tpu_torch.cli",
            "--home", home, "start", "--validator",
            "--grpc-address", "127.0.0.1:0",
            "--metrics-port", "0",
            "--timeseries-interval", "0.2",
            "--warm-squares", "",
            "--flight-dir", flight_dir,
        ],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO, env=env,
    )
    try:
        line = tools.readline_deadline(proc)
        if line is None or proc.poll() is not None:
            why = "died" if proc.poll() is not None else "hung"
            print(f"critpath-smoke: slo validator {why} at startup",
                  file=sys.stderr)
            return 1
        started = json.loads(line)
        addr, http_addr = started["grpc"], started.get("metrics_http")

        remote = RemoteNode(addr, timeout_s=120.0)
        try:
            st = remote.status()
            prop = remote.cons_prepare()
            now_ns = int(
                st.get("time_ns") or st.get("genesis_time_ns") or 0
            ) + 10**9
            remote.cons_commit(
                prop["block_txs"], int(st["height"]) + 1, now_ns,
                prop["data_root"], prop["square_size"],
            )
            height = remote.status()["height"]
        finally:
            remote.close()
        if height < 1:
            print(f"critpath-smoke: no block produced (h={height})",
                  file=sys.stderr)
            return 1

        # one full block breaches the 0.001 ms budget on the first
        # sampler tick after commit; give the 0.2 s cadence a few ticks
        deadline = time.time() + 15.0
        listing = None
        while time.time() < deadline:
            inc = _cli(env, "query", "--node", addr, "incidents")
            if inc.returncode == 0:
                listing = json.loads(inc.stdout)
                if any(
                    TIGHT_SLO["name"] in i.get("reason", "")
                    for i in listing.get("incidents", [])
                ):
                    break
            # celint: allow(sanctioned-retry) — pacing a poll of the node's incident list to its 0.2 s sampler cadence; the loop waits for an expected event, it retries no failure
            time.sleep(0.3)
        hits = [
            i for i in (listing or {}).get("incidents", [])
            if TIGHT_SLO["name"] in i.get("reason", "")
        ]
        if not hits:
            print(
                f"critpath-smoke: {TIGHT_SLO['name']} never produced an "
                f"incident ({listing})",
                file=sys.stderr,
            )
            return 1
        newest = hits[-1]

        out_dir = os.path.join(base, "fetched")
        fetched = _cli(
            env, "query", "--node", addr, "incident",
            "--id", newest["id"], "--out", out_dir,
        )
        if fetched.returncode != 0:
            print(f"critpath-smoke: query incident failed: {fetched.stderr}",
                  file=sys.stderr)
            return 1
        bundle_dir = os.path.join(out_dir, newest["id"])
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            manifest = json.load(f)
        problems = flight_mod.validate_manifest(manifest)
        if problems:
            print(f"critpath-smoke: invalid manifest: {problems[:5]}",
                  file=sys.stderr)
            return 1
        with open(os.path.join(bundle_dir, "trace.json")) as f:
            trace = json.load(f)
        problems = tracing.validate_chrome_trace(trace)
        if problems:
            print(f"critpath-smoke: invalid bundle trace: {problems[:5]}",
                  file=sys.stderr)
            return 1
        # the bundle carries the OFFENDING trace: the breached block's
        # lifecycle spans are in the doc
        if not any(
            ev.get("name") == "prepare_proposal"
            for ev in trace["traceEvents"]
        ):
            print("critpath-smoke: bundle trace lacks the offending block",
                  file=sys.stderr)
            return 1

        card = _cli(env, "query", "--node", addr, "block-scorecard")
        if card.returncode != 0:
            print(f"critpath-smoke: query block-scorecard failed: "
                  f"{card.stderr}", file=sys.stderr)
            return 1
        card_doc = json.loads(card.stdout)
        row = next(
            (r for r in card_doc["rows"] if r["height"] == height), None
        )
        if row is None or row.get("e2e_ms", 0.0) <= 0.0:
            print(f"critpath-smoke: no scorecard row for h={height}: "
                  f"{card_doc}", file=sys.stderr)
            return 1

        hz_doc = json.loads(urllib.request.urlopen(
            f"http://{http_addr}/healthz", timeout=30
        ).read().decode())
        if hz_doc.get("status") != "degraded" or (
            TIGHT_SLO["name"] not in hz_doc.get("alerts_firing", [])
        ):
            print(f"critpath-smoke: healthz did not degrade on the SLO: "
                  f"{hz_doc}", file=sys.stderr)
            return 1
        if (hz_doc.get("block") or {}).get("height") != height:
            print(f"critpath-smoke: healthz block section wrong: "
                  f"{hz_doc.get('block')}", file=sys.stderr)
            return 1

        scrape = urllib.request.urlopen(
            f"http://{http_addr}/metrics", timeout=30
        ).read().decode()
        print(json.dumps({
            "critpath_smoke_slo": "ok",
            "device": device,
            "height": height,
            "node_counts": [tools.exposition_counts(scrape)],
            "incident": newest["id"],
            "reason": newest["reason"],
            "scorecard_e2e_ms": row["e2e_ms"],
            "healthz": hz_doc["status"],
        }))
        return 0
    finally:
        _stop_all([proc], [])


LEGS = {"mesh": mesh_leg, "slo": slo_leg}


def main(argv=None) -> int:
    return tools.run_legs("critpath_smoke", LEGS, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
