"""trace-smoke: the observability plane's boot gate, on the port.

Twin of ``tools/trace_smoke.py``, on the device (``cuda:0``, or
``--device cpu``): the node of leg 1 and the two validator processes of
leg 2 (``python -m celestia_tpu_torch.cli`` under
``CELESTIA_TPU_TORCH_DEVICE``, ``CELESTIA_TPU_TORCH_TRACE`` and
``CELESTIA_TPU_TORCH_NODE_ID``) run there.

Leg 1 (single node): runs ONE tiny-k testnode block with tracing
enabled and asserts:

* the ring holds a prepare + process trace for the block,
* the prepare tree contains square_build and an extend phase with a
  roots child (the acceptance shape; on the card the plane's
  ``extend.device_plane`` span and its ``device.extend_levels`` dispatch,
  which makes the roots),
* the Chrome trace document is schema-valid (validate_chrome_trace) and
  JSON-serializable — i.e. it opens in Perfetto as-is,
* the Prometheus exposition of the same run parses line by line.

Leg 2 (two nodes): spins TWO traced validator processes sharing a
genesis, drives one block through the process coordinator, fans
TraceDump + clock probes out, merges the dumps (node/cluster.py) and
asserts the merged document is schema-valid with both node tracks and a
non-empty cross-node parent/flow link between the proposer's prepare
and the validator's process spans.

Exit 0 + one summary JSON line per leg (with the device) on success; 1
with the reason on any failure.

    python -m celestia_tpu_torch.tools.trace_smoke [--device cpu]
"""

import json
import os
import signal
import subprocess
import sys
import tempfile

from celestia_tpu_torch import tools

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def leg1(device: str) -> int:
    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.da import eds_cache
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils import tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    tracing.enable(4)
    eds_cache.clear()
    key = PrivateKey.from_seed(b"trace-smoke")
    node = TestNode(
        funded_accounts=[(key, 10**12)], auto_produce=False, device=device
    )
    signer = Signer(node, key)
    res = signer._broadcast(
        lambda: signer.sign_tx(
            [MsgSend(signer.address, b"\x11" * 20, 1000)]
        ).marshal()
    )
    if res.code != 0:
        print(f"trace-smoke: broadcast failed: {res.log}", file=sys.stderr)
        return 1
    node.produce_block()

    traces = tracing.block_traces()
    names = {tr.name for tr in traces}
    if not {"prepare_proposal", "process_proposal"} <= names:
        print(f"trace-smoke: missing block traces, got {names}", file=sys.stderr)
        return 1
    prep = [t for t in traces if t.name == "prepare_proposal"][-1]
    if not prep.spans:
        print("trace-smoke: prepare trace has no spans", file=sys.stderr)
        return 1

    def flat(node):
        out = {node["name"]}
        for c in node["children"]:
            out |= flat(c)
        return out

    tree_names = flat(prep.tree())
    # the host regime (the CPU) hashes the roots in a span of their own;
    # on the card the plane's one dispatch makes them (its span and the
    # dispatch's device track)
    on_card = device.startswith("cuda")
    want = ("extend.device_plane", "device.extend_levels") if on_card else ("roots",)
    for required in ("square_build", "extend", *want):
        if required not in tree_names:
            print(
                f"trace-smoke: span {required!r} missing from the prepare "
                f"tree {sorted(tree_names)}",
                file=sys.stderr,
            )
            return 1

    dump = tracing.trace_dump()
    problems = tracing.validate_chrome_trace(dump)
    if problems:
        print(f"trace-smoke: invalid trace JSON: {problems}", file=sys.stderr)
        return 1
    encoded = json.dumps(dump)  # must serialize for Perfetto

    # the metrics side of the plane: every exposition line must parse
    # (ONE validator, shared with tests/test_tracing.py)
    from celestia_tpu_torch.utils.telemetry import validate_exposition

    bad = validate_exposition(node.app.telemetry.export_prometheus())
    if bad:
        print(
            f"trace-smoke: malformed exposition lines: {bad[:3]!r}",
            file=sys.stderr,
        )
        return 1

    print(
        json.dumps(
            {
                "trace_smoke": "ok",
                "device": device,
                "height": node.height,
                "blocks_traced": len(traces),
                "prepare_spans": len(prep.spans),
                "trace_bytes": len(encoded),
                "prepare_breakdown": tracing.TRACER.phase_breakdown(prep),
            }
        )
    )
    return 0




def two_node_leg(device: str) -> int:
    """Spin two traced validator processes, drive one block, merge the
    dumps and gate on the cross-node link."""
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.node import cluster
    from celestia_tpu_torch.node.coordinator import (
        PeerValidator,
        ProcessCoordinator,
    )
    from celestia_tpu_torch.utils import tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    base = tempfile.mkdtemp(prefix="trace-smoke-2node-")
    keys = [PrivateKey.from_seed(b"trace-smoke-val-%d" % i) for i in range(2)]
    genesis = {
        "chain_id": "trace-smoke-2",
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

    env = {
        **os.environ,
        "CELESTIA_TPU_TORCH_DEVICE": device,
        "CELESTIA_TPU_TORCH_TRACE": "1",
    }
    procs, clients = [], []
    try:
        for i in range(2):
            home = os.path.join(base, f"val{i}")
            r = subprocess.run(
                [
                    sys.executable, "-m", "celestia_tpu_torch.cli",
                    "--home", home, "init",
                    "--chain-id", "trace-smoke-2", "--genesis", shared,
                ],
                capture_output=True, text=True, timeout=120,
                cwd=REPO, env=env,
            )
            if r.returncode != 0:
                print(f"trace-smoke-2node: init failed: {r.stderr}",
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
                print(
                    f"trace-smoke-2node: validator {i} {why} at startup",
                    file=sys.stderr,
                )
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

        merged = cluster.cluster_trace(clients)
        problems = tracing.validate_chrome_trace(merged)
        if problems:
            print(f"trace-smoke-2node: invalid merged trace: {problems[:5]}",
                  file=sys.stderr)
            return 1
        node_ids = {n["node_id"] for n in merged["otherData"]["nodes"]}
        if node_ids != {"val-0", "val-1"}:
            print(f"trace-smoke-2node: wrong node tracks: {node_ids}",
                  file=sys.stderr)
            return 1
        flows = merged["otherData"]["cross_node_flows"]
        if flows < 1:
            print("trace-smoke-2node: no cross-node flow links in the merge",
                  file=sys.stderr)
            return 1
        by_pid = {}
        for ev in merged["traceEvents"]:
            if ev.get("ph") == "X":
                by_pid.setdefault(ev["pid"], set()).add(ev["name"])
        prep_pids = {p for p, names in by_pid.items()
                     if "prepare_proposal" in names}
        proc_pids = {p for p, names in by_pid.items()
                     if "process_proposal" in names}
        if not prep_pids or not (proc_pids - prep_pids):
            print(
                "trace-smoke-2node: prepare/process spans not on separate "
                f"node tracks (prepare pids {prep_pids}, process pids "
                f"{proc_pids})",
                file=sys.stderr,
            )
            return 1
        print(
            json.dumps(
                {
                    "trace_smoke_2node": "ok",
                    "device": device,
                    "nodes": sorted(node_ids),
                    # each node's launches and the work that predicts them
                    "node_counts": [
                        tools.exposition_counts(c.metrics()) for c in clients
                    ],
                    "cross_node_flows": flows,
                    "events": len(merged["traceEvents"]),
                }
            )
        )
        return 0
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            proc.send_signal(signal.SIGINT)
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


LEGS = {"node": leg1, "cluster": two_node_leg}


def main(argv=None) -> int:
    return tools.run_legs("trace_smoke", LEGS, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
