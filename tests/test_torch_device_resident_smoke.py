"""The port's device-resident-smoke twin
(celestia_tpu_torch/tools/device_resident_smoke.py) in process on the CPU:
the committed block, the plane driven directly on its square (a TestNode
on the CPU runs the host regime and parks nothing), the DAS batch served
from the parked entry, the D2H contract and the port's R7 with no pragma
in da/device_plane.py; the block's data root and the served proofs' bytes
are held to the JAX package's on the same seed."""

import json

import pytest

from _torch_common import fresh_port_faults, jax_block_and_proofs  # noqa: F401 (fixture)
from celestia_tpu_torch.tools import das_smoke, device_resident_smoke as smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def test_device_resident_twin_on_the_cpu_matches_jax(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device_resident_smoke"] == "ok" and out["plane"] == "direct"
    assert set(out["hot_path_d2h_legs"]) == {"data_root", "roots", "proof_gather"}
    assert out["device_cache"]["hits"] > 0
    data_root, proofs = jax_block_and_proofs(
        smoke.SEED_KEY, smoke.BLOB_SEED, smoke.NAMESPACE_ID,
        [tuple(c) for c in out["coords"]])
    assert out["data_root"] == data_root.hex()
    assert out["proofs_sha256"] == das_smoke.proofs_digest(proofs)
