"""``chip_smoke.py``'s ``PlainRowStacks`` on the CPU: inside it, the port's
plain namespace data and share proofs of a block are the bytes the calls
give without it (the row level stacks hashed once for the block, then
sliced), a call on other rows or another EDS runs as it is, and
``nmt.row_level_stack`` is restored on exit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from celestia_tpu_torch.da import dah, namespace_data, proof
from celestia_tpu_torch.da import square as square_mod
from celestia_tpu_torch.da.blob import Blob, BlobTx
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.da.shares import sparse_shares_needed
from celestia_tpu_torch.ops import nmt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

K = 8


def seeded_block(seed: int):
    rng = np.random.default_rng(seed)
    txs = [BlobTx(rng.bytes(300), tuple(
        Blob(Namespace.v0(b"\x01" + rng.bytes(9)), rng.bytes(int(rng.integers(478, 3000))))
        for _ in range(int(rng.integers(1, 4))))).marshal() for _ in range(4)]
    sq, _, _ = square_mod.build(txs, max_square_size=K)
    eds, hdr = dah.extend_block(sq, device="cpu")
    ranges, i = [], 0
    while i < len(sq.shares):
        sh = sq.shares[i]
        if sh.namespace.is_reserved() or not sh.is_sequence_start or not sh.sequence_len():
            i += 1
            continue
        n = sparse_shares_needed(sh.sequence_len())
        ranges.append((sh.namespace.raw, i, i + n))
        i += n
    return eds, hdr, ranges


def answers(eds, hdr, ranges, stacks=None):
    out = []
    for ns in sorted({r[0] for r in ranges}):
        if stacks is None:
            out.append(namespace_data.get_shares_by_namespace(eds, hdr, ns).to_dict())
        else:
            with stacks:
                out.append(namespace_data.get_shares_by_namespace(eds, hdr, ns).to_dict())
    for _, start, end in ranges:
        if stacks is None:
            out.append(proof.new_share_inclusion_proof(eds, hdr, start, end).to_dict())
        else:
            with stacks:
                out.append(proof.new_share_inclusion_proof(eds, hdr, start, end).to_dict())
    return out


def test_plain_row_stacks_give_the_calls_own_answers():
    eds, hdr, ranges = seeded_block(3)
    assert len(ranges) >= 3
    ranges = ranges[:3]
    real = nmt.row_level_stack
    stacks = chip_smoke.PlainRowStacks(eds)
    assert answers(eds, hdr, ranges, stacks) == answers(eds, hdr, ranges)
    assert stacks._levels is not None and stacks._checked
    assert nmt.row_level_stack is real
    # another block's EDS inside the first block's stacks: its own answers
    other, other_hdr, other_ranges = seeded_block(4)
    other_ranges = other_ranges[:1]
    assert answers(other, other_hdr, other_ranges, stacks) == answers(other, other_hdr,
                                                                      other_ranges)
    assert nmt.row_level_stack is real


def test_host_phase_rehearses_on_the_cpu():
    """Phase 4k's control flow on the CPU at tiny sizes (the host regime
    against the plane's plain twins, the memo in its child under
    lagrange-gf256, the two TestNodes): every check of the phase holds."""
    out = chip_smoke.host_phase("cpu", [2, 1], 4, 3, counted=False)
    assert set(out["host_ms"]) == set(out["card_ms"]) == {1, 2}
    assert out["memo"]["memo"]["assembled"] == 1 and out["memo"]["memo"]["reuse_pct"] == 37.5
    assert out["memo"]["codec"] == "lagrange-gf256"
    assert out["repair_ms"]["k"] == 2 and len(out["repair_ms"]["host"]) == chip_smoke.HOST_RUNS
    assert all(set(c.values()) == {0} for c in out["launches"].values())


def test_tools_phase_arithmetic_and_summary_parsing():
    """Phase 4l's prediction on summaries of the twins' shape: 5 launches a
    cold extension or rebuilt block, one K7b a chunk and a direct batch, the
    sharded extension's on the repeated-device mesh; a missing or failed
    leg line fails the phase."""
    node = {"launches": {"rs_extend": 4, "nmt_leaf_digests": 2, "nmt_combine_level": 2,
                         "rfc6962_root": 2, "das_proof_gather": 10},
            "misses": 1, "rebuilt": 1, "chunks": 9}
    stdout = "\n".join(["build noise", json.dumps({"das_smoke": "ok", "node_counts": [node],
                                                   "das_batches": 1})])
    summaries = chip_smoke.twin_summaries("das_smoke", stdout)
    [(what, got, want)] = chip_smoke.twin_predictions("das_smoke", summaries)
    assert got == want == {**chip_smoke.block_launches(2), "das_proof_gather": 10}
    assert "1 cold extensions, 1 rebuilt, 9 chunks" in what
    sharded = {"multichip_smoke": "ok", "k": 2, "mesh_devices": ["cuda:0"] * 2,
               "launches": chip_smoke.sharded_launches_per_call(2, 2)}
    [(_, got, want)] = chip_smoke.twin_predictions(
        "multichip_smoke", chip_smoke.twin_summaries("multichip_smoke", json.dumps(sharded)))
    assert got == want and want["xor_reduce_slabs"] == 1 and want["rs_extend"] == 2
    with pytest.raises(AssertionError, match="trace_smoke_2node"):
        chip_smoke.twin_summaries("trace_smoke", json.dumps({"trace_smoke": "ok"}))
    with pytest.raises(AssertionError, match="das_smoke"):
        chip_smoke.twin_summaries("das_smoke", json.dumps({"das_smoke": "failed"}))


def test_tools_phase_rehearses_on_the_cpu():
    """Phase 4l's control flow on the CPU with two twins run at once (each a
    process of its own, its summary parsed, its prediction computed;
    nothing launches on the CPU, so the predictions are not held)."""
    out = chip_smoke.tools_phase("cpu", ["das_smoke", "multichip_smoke"], counted=False)
    t = out["twins"]["das_smoke"]
    assert t["summaries"]["das_smoke"]["device"] == "cpu" and t["wall_s"] > 0
    [(_, got, want)] = t["predictions"]
    assert set(got.values()) == {0} and want["das_proof_gather"] == 9
    assert want["rs_extend"] == 2 * t["summaries"]["das_smoke"]["node_counts"][0]["misses"]
    [(_, got, want)] = out["twins"]["multichip_smoke"]["predictions"]
    assert set(got.values()) == {0} and want == chip_smoke.sharded_launches_per_call(2, 2)
    assert set(out["launches"].values()) == {0}
