"""The port's multichip-smoke twin (celestia_tpu_torch/tools/
multichip_smoke.py) in process on the CPU: a 1x2 mesh over ["cpu"] * 2,
one block through the sharded path; the block's EDS and data root are
held to the JAX package's block on the same seed (JAX's sharded and
single-device extensions give the same bytes, tests/test_torch_sharded.py
holds the port's sharded path to JAX's shard_map)."""

import hashlib
import json

import pytest

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch.parallel import mesh as mesh_mod
from celestia_tpu_torch.tools import multichip_smoke as smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def jax_block():
    from celestia_tpu.client.signer import Signer
    from celestia_tpu.da.blob import Blob, BlobTx
    from celestia_tpu.da.inclusion import create_commitment
    from celestia_tpu.da.namespace import Namespace
    from celestia_tpu.node.testnode import TestNode
    from celestia_tpu.state.tx import MsgPayForBlobs
    from celestia_tpu.utils.secp256k1 import PrivateKey

    key = PrivateKey.from_seed(smoke.SEED_KEY)
    node = TestNode(funded_accounts=[(key, 10**12)], auto_produce=False)
    signer = Signer(node, key)
    ns = Namespace.v0(smoke.NAMESPACE_ID)
    blob = Blob(ns, smoke.BLOB)
    msg = MsgPayForBlobs(signer=signer.address, namespaces=(ns.raw,),
                         blob_sizes=(len(blob.data),),
                         share_commitments=(create_commitment(blob),),
                         share_versions=(0,))
    tx = signer.sign_tx([msg], gas_limit=2_000_000, sequence=0)
    assert node.broadcast_tx(BlobTx(tx.marshal(), [blob]).marshal()).code == 0
    node.produce_block()
    eds = node._block_artifacts(node.height)["eds"]
    return (node.block(node.height).header.data_hash.hex(),
            hashlib.sha256(bytes(eds.shares.tobytes())).hexdigest())


def test_multichip_twin_on_a_repeated_cpu_mesh_matches_jax(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["multichip_smoke"] == "ok" and out["mesh_devices"] == ["cpu", "cpu"]
    assert out["mesh"]["row"] == 2 and out["mesh"]["sharded_extends"] >= 1
    assert out["track_check"] == "one track: the mesh repeats one device"
    assert mesh_mod.stats()["configured"] is None  # the twin leaves no mesh behind
    assert (out["data_root"], out["eds_sha256"]) == jax_block()
