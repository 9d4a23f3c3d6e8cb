"""The port's ingress-smoke twin (celestia_tpu_torch/tools/ingress_smoke.py)
in process on the CPU; its first block (the flood's 96 admitted sends) is
held to the JAX package's block of the same signed txs (its data root)."""

import json

import pytest

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch.tools import ingress_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def jax_flood_block_root():
    from celestia_tpu.node.testnode import TestNode
    from celestia_tpu.state.tx import Fee, MsgSend, Tx
    from celestia_tpu.utils.secp256k1 import PrivateKey

    keys = [PrivateKey.from_seed(b"ingress-smoke-%d" % i)
            for i in range(ingress_smoke.N_KEYS)]
    node = TestNode(funded_accounts=[(k, 10**12) for k in keys], auto_produce=False)
    app = node.app
    for s in range(ingress_smoke.SEQS_ROUND1):
        for k in keys:
            addr = k.public_key().address()
            tx = Tx((MsgSend(addr, ingress_smoke.SINK, 1 + s),), Fee(200_000, 100_000),
                    k.public_key().compressed(), sequence=s,
                    account_number=app.accounts.peek(addr).account_number)
            assert node.broadcast_tx(tx.signed(k, app.chain_id).marshal()).code == 0
    block = node.produce_block()
    return len(block.txs), block.header.data_hash.hex()


def test_ingress_smoke_twin_on_the_cpu_matches_jax(capsys):
    assert ingress_smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ingress_smoke"] == "ok" and out["device"] == "cpu"
    assert out["admitted"] == 96 and out["blocks"] == [96, 32]
    n, root = jax_flood_block_root()
    assert (n, root) == (out["blocks"][0], out["data_roots"][0])
