"""The port's das-smoke twin (celestia_tpu_torch/tools/das_smoke.py) in
process on the CPU, held to the JAX package on the same seed: the
committed block's data root and the bytes of every served proof."""

import json

import pytest

from _torch_common import fresh_port_faults, jax_block_and_proofs  # noqa: F401 (fixture)
from celestia_tpu_torch.tools import das_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def test_das_smoke_twin_on_the_cpu_matches_jax(capsys):
    assert das_smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["das_smoke"] == "ok" and out["device"] == "cpu"
    assert out["warm_hits"] > 0 and out["gate_shed"] > 0
    data_root, proofs = jax_block_and_proofs(
        das_smoke.SEED_KEY, das_smoke.BLOB_SEED, das_smoke.NAMESPACE_ID,
        [tuple(c) for c in out["coords"]])
    assert out["data_root"] == data_root.hex()
    assert out["proofs_sha256"] == das_smoke.proofs_digest(proofs)
