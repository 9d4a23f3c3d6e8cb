"""The port's swarm-smoke twin (celestia_tpu_torch/tools/swarm_smoke.py)
in process on the CPU; the two blocks it serves are held to the JAX
package's blocks on the same seed (their data roots)."""

import json

import pytest

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch.tools import swarm_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def jax_data_roots():
    import numpy as np

    from celestia_tpu.client.signer import Signer
    from celestia_tpu.da.blob import Blob
    from celestia_tpu.da.namespace import Namespace
    from celestia_tpu.node.testnode import TestNode
    from celestia_tpu.utils.secp256k1 import PrivateKey

    key = PrivateKey.from_seed(b"swarm-smoke")
    node = TestNode(funded_accounts=[(key, 10**12)])
    signer = Signer(node, key)
    rng = np.random.default_rng(17)
    roots = []
    for i in range(2):
        data = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
        res = signer.submit_pay_for_blob([Blob(Namespace.v0(bytes([0x30 + i]) * 10), data)])
        assert res.code == 0, res.log
        roots.append(node.block(res.height).header.data_hash.hex())
    return roots


def test_swarm_smoke_twin_on_the_cpu_matches_jax(capsys):
    assert swarm_smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["swarm_smoke"] == "ok" and out["device"] == "cpu"
    assert out["fairness_index"] < 0.5 and out["incident"]
    assert out["data_roots"] == jax_data_roots()
