"""ingress-smoke: the batched tx-admission plane's gate (`make ingress-smoke`), on the port.

Twin of ``tools/ingress_smoke.py``, on the device (``cuda:0``, or ``--device
cpu``).

Floods one live node with signed sends over the real gRPC TxPush
boundary and asserts the batched admission story end to end:

* a gossip txpush flood drains through ``check_txs_batch`` — one
  ``verify_batch`` pass per chunk — and every well-formed tx is
  admitted while a mid-flood forged signature and a garbage blob are
  rejected without poisoning their neighbours;
* replaying the same flood admits nothing (the gossip seen-set plus
  receiver-side dedup hold);
* block production routes FilterTxs through the signer-grouped
  ``hostpool.run_sharded`` parallel leg (cpu_threads pinned >1 for the
  smoke) and the produced block keeps every admitted tx;
* the ``BroadcastBatch`` RPC admits a follow-up batch with per-tx
  results over the wire;
* ``ingress.batch`` and ``ante.parallel`` spans land in the tracer's
  per-span aggregates, and the ``celestia_tpu_ingress_*`` counters ride
  a parse-valid exposition.

Exit 0 + one summary JSON line (with the device) on success; 1 with the
reason on any failure.

    python -m celestia_tpu_torch.tools.ingress_smoke [--device cpu]
"""

import json
import sys

from celestia_tpu_torch import tools

N_KEYS = 8
SEQS_ROUND1 = 12
SEQS_ROUND2 = 4
SINK = b"\x5a" * 20


def smoke(device) -> dict:
    from celestia_tpu_torch.node.gossip import GossipEngine
    from celestia_tpu_torch.node.remote import RemoteNode
    from celestia_tpu_torch.node.server import NodeServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.state.tx import Fee, MsgSend, Tx
    from celestia_tpu_torch.utils import hostpool, tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey
    from celestia_tpu_torch.utils.telemetry import validate_exposition

    keys = [PrivateKey.from_seed(b"ingress-smoke-%d" % i) for i in range(N_KEYS)]
    node = TestNode(
        funded_accounts=[(k, 10**12) for k in keys], auto_produce=False,
        device=device,
    )
    app = node.app

    def send(key, seq, amount=1):
        addr = key.public_key().address()
        tx = Tx(
            (MsgSend(addr, SINK, amount),),
            Fee(200_000, 100_000),
            key.public_key().compressed(),
            sequence=seq,
            account_number=app.accounts.peek(addr).account_number,
        )
        return tx.signed(key, app.chain_id).marshal()

    def flood(seq0, rounds):
        return [
            send(k, seq0 + s, amount=1 + s)
            for s in range(rounds)
            for k in keys
        ]

    tracing.enable()
    GossipEngine(node, [])  # attaches itself as node.gossip_engine
    server = NodeServer(node, block_interval_s=None)
    server.start()
    client = RemoteNode(server.address, timeout_s=30.0)
    try:
        # round 1: a txpush flood with a forged signature and a garbage
        # blob buried mid-stream — the batch must reject exactly those
        good = flood(0, SEQS_ROUND1)
        forged = send(keys[0], SEQS_ROUND1)
        forged = forged[:-1] + bytes([forged[-1] ^ 1])
        raws = list(good)
        raws.insert(len(raws) // 2, forged)
        raws.insert(len(raws) // 3, b"\x99ingress-smoke-garbage")
        admitted = client.tx_push(raws)
        assert admitted == len(good), (
            f"txpush flood admitted {admitted}, wanted {len(good)}"
        )
        assert len(node.mempool) == len(good), "mempool disagrees with push"

        # replay: every good tx is already seen, the bad two still fail
        assert client.tx_push(raws) == 0, "replayed flood re-admitted txs"

        counters = app.telemetry.counters
        assert counters.get("ingress_batch_calls", 0) >= 1, (
            "flood never reached check_txs_batch"
        )
        assert counters.get("ingress_batch_txs", 0) >= len(raws), (
            "batch tx counter under-counts the flood"
        )
        assert counters.get("ingress_batch_verified", 0) >= len(good), (
            "flood signatures were not batch-verified"
        )

        # block production: pin >1 host threads so FilterTxs takes the
        # signer-grouped run_sharded leg (1-core boxes inline otherwise)
        hostpool.set_cpu_threads(4)
        try:
            block = node.produce_block()
        finally:
            hostpool.set_cpu_threads(None)
        assert len(block.txs) == len(good), (
            f"block kept {len(block.txs)} txs, wanted {len(good)}"
        )
        assert len(node.mempool) == 0, "mempool not drained by the block"
        assert counters.get("ingress_parallel_groups", 0) >= N_KEYS, (
            "FilterTxs never took the parallel leg"
        )

        # round 2: batched submission over the BroadcastBatch RPC
        batch2 = flood(SEQS_ROUND1, SEQS_ROUND2)
        results = client.broadcast_txs_batch(batch2)
        assert [r.code for r in results] == [0] * len(batch2), (
            "BroadcastBatch rejected a valid tx"
        )
        block2 = node.produce_block()
        assert len(block2.txs) == len(batch2), "round-2 txs missing"

        summary = tracing.span_summary()
        for span in ("ingress.batch", "ante.parallel"):
            assert span in summary and summary[span]["count"] >= 1, (
                f"span {span} never recorded"
            )

        text = server.service.metrics_text()
        bad = validate_exposition(text)
        assert not bad, f"malformed exposition lines: {bad[:3]}"
        for needle in (
            "celestia_tpu_ingress_batch_calls_total",
            "celestia_tpu_ingress_batch_txs_total",
            "celestia_tpu_ingress_batch_verified_total",
            "celestia_tpu_ingress_parallel_groups_total",
        ):
            assert needle in text, f"exposition missing {needle}"

        return (
                {
                    "ingress_smoke": "ok",
                    "device": tools.device_label(device),
                    "flood": len(raws),
                    "admitted": admitted,
                    "blocks": [len(block.txs), len(block2.txs)],
                    "data_roots": [
                        block.header.data_hash.hex(), block2.header.data_hash.hex()
                    ],
                    # the process's launches and the work that predicts them
                    "node_counts": [
                        tools.exposition_counts(server.service.metrics_text())
                    ],
                    "batch_calls": counters.get("ingress_batch_calls", 0),
                    "batch_verified": counters.get(
                        "ingress_batch_verified", 0
                    ),
                    "parallel_groups": counters.get(
                        "ingress_parallel_groups", 0
                    ),
                    "ingress_batch_p50_ms": summary["ingress.batch"][
                        "p50_ms"
                    ],
                }
            )
    finally:
        client.close()
        server.stop()
        tracing.disable()
        tracing.clear()


def main(argv=None) -> int:
    return tools.run(
        "ingress_smoke", lambda dev, args: print(json.dumps(smoke(dev))), argv, __doc__
    )


if __name__ == "__main__":
    sys.exit(main())
