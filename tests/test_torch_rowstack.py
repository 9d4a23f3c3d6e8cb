"""K2's row-set mode (csrc/nmt.cu ``ctt_nmt_leaf_digests_rows``) and the row
level stacks built on it (ops/nmt.py ``row_level_stack``,
``eds_row_level_stack``), run on the host through the g++ CPU twin
(csrc/cpu_twin.cpp) with the wrappers' CUDA branches, against the JAX
package's ``nmt_level_stack`` over its own prefixed leaves, byte for byte.

The row trees of proofs, namespace data, BEFPs and DAS misses are hashed
straight from the EDS rows, read in place or from a gathered block (a
transposed view's rows), with the Q0 prefix rule read at the rows' EDS ids:
no prefixed-leaf tensor and no K1 launch.  The kernel runs only on a card
(chip_smoke.py holds it against the plain version there at k = 1..128);
this file checks its index maps, its refusals and the Python around it.
"""

import numpy as np
import pytest
import torch

import jax

from celestia_tpu.da import fraud as jfraud
from celestia_tpu.ops import nmt as jnmt
from _torch_common import route_launches_to_twin, sha_scan_unrolled_once
from _torch_common import torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import fraud
from celestia_tpu_torch.ops import nmt, rs

_D = 90


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _random_eds(rng, k: int) -> np.ndarray:
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    # some real namespaces, and a parity-namespace cell inside Q0
    sq[..., :18] = 0
    sq[0, -1, :29] = 0xFF
    return rs.extend_square(torch.from_numpy(sq)).numpy()


@pytest.fixture(scope="module")
def jax_axis_stacks():
    """JAX's ``nmt_level_stack`` over its own ``eds_prefixed_leaves`` of an
    EDS: [(2, 2k, 2k, 90), (2, 2k, k, 90), ...] (row trees, then column
    trees), compiled once per k at LLVM optimisation level 0 with SHA-256's
    scans unrolled once (the same bytes)."""
    compiled = {}

    def levels(eds: np.ndarray) -> list:
        n2 = eds.shape[0]
        if n2 not in compiled:
            fn = jax.jit(lambda e: jnmt.nmt_level_stack(jnmt.eds_prefixed_leaves(e)))
            with sha_scan_unrolled_once():
                compiled[n2] = fn.lower(eds).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
        return [np.asarray(lv) for lv in compiled[n2](eds)]

    return levels


def _row_sets(rng, n2: int) -> dict:
    """The row sets a caller gives: a contiguous run, a scattered set, one
    row, all 2k rows, and rows out of order."""
    return {
        "run": list(range(n2 // 4, n2 // 4 + max(1, n2 // 2))),
        "scattered": sorted(rng.choice(n2, max(1, n2 // 3), replace=False).tolist()),
        "single": [int(rng.integers(n2))],
        "all": list(range(n2)),
        "unsorted": rng.permutation(n2)[: max(2, 3 * n2 // 4)].tolist() if n2 > 1 else [0],
    }


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_twin_row_set_stacks_match_jax_level_stack(twin, monkeypatch, jax_axis_stacks, k):
    """Every row set through the card path on the twin, in place from the
    EDS and gathered from its transposed view (whose rows are the column
    trees: the Q0 rule is symmetric): one K2 launch in the row-set mode and
    one K3 launch a stack, no K1, no gather for the EDS read in place, and
    every level byte-equal to JAX's and to the plain twin's."""
    rng = np.random.default_rng(2000 + k)
    eds_np = _random_eds(rng, k)
    n2 = 2 * k
    want = jax_axis_stacks(eds_np)
    eds = torch.from_numpy(eds_np)
    sets = _row_sets(rng, n2)
    plain = {name: (nmt.eds_row_level_stack_plain(eds, rows),
                    nmt.eds_row_level_stack_plain(eds.transpose(0, 1), rows))
             for name, rows in sets.items()}
    gathers = []
    real_eds_rows = nmt.eds_rows
    monkeypatch.setattr(nmt, "eds_rows", lambda *a: gathers.append(1) or real_eds_rows(*a))
    launched = route_launches_to_twin(monkeypatch, twin)
    for name, rows in sets.items():
        for axis, view in ((0, eds), (1, eds.transpose(0, 1))):
            launched.clear()
            gathers.clear()
            got = nmt.eds_row_level_stack(view, rows)
            assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1}, (name, axis)
            assert len(gathers) == axis, (name, axis)  # in place unless transposed
            assert len(got) == len(want) == n2.bit_length()
            for j, (g, w, p) in enumerate(zip(got, want, plain[name][axis])):
                what = f"{name} rows {rows}, axis {axis}, level {j}"
                np.testing.assert_array_equal(g.numpy(), w[axis][rows], err_msg=what)
                np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=what)


@pytest.mark.parametrize("k", [2, 8])
def test_twin_row_set_from_a_gathered_block(twin, monkeypatch, jax_axis_stacks, k):
    """A proof's block (da/proof.py: the rows gathered once, K7b reads the
    shares from it): ``row_level_stack(block, rows)`` reads tree i from the
    block's row i with EDS row id rows[i], equal to JAX's row trees; the
    leaf pass alone equals K2's window over the same rows."""
    rng = np.random.default_rng(2100 + k)
    eds_np = _random_eds(rng, k)
    n2 = 2 * k
    want = jax_axis_stacks(eds_np)
    rows = rng.permutation(n2)[: k + 1].tolist()
    block = torch.from_numpy(np.ascontiguousarray(eds_np[rows]))
    window = torch.from_numpy(np.ascontiguousarray(eds_np[1 : 1 + k]))
    plain = nmt.row_level_stack_plain(block, rows)
    launched = route_launches_to_twin(monkeypatch, twin)
    got = nmt.row_level_stack(block, rows)
    assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1}
    for j, (g, w, p) in enumerate(zip(got, want, plain)):
        np.testing.assert_array_equal(g.numpy(), w[0][rows], err_msg=f"level {j}")
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=f"level {j}")
    np.testing.assert_array_equal(nmt.row_leaf_digests(window, range(1, 1 + k)).numpy(),
                                  nmt.leaf_digests_window(window, 1).numpy())


def test_twin_befp_through_the_card_path_matches_jax(twin, monkeypatch):
    """fraud.build_befp on the card path (the twin): a row axis proves from
    the transposed view's gathered rows, a column axis from the EDS's rows;
    both BEFPs byte-equal to the plain path's and to JAX's, with K2's
    row-set mode and no K1."""
    k = 4
    rng = np.random.default_rng(2200)
    bad = _random_eds(rng, k)
    bad[1, k + 2, 100] ^= 0x5A
    cases = [(fraud.AXIS_ROW, 1, None), (fraud.AXIS_COL, 2, tuple(range(k, 2 * k)))]
    want = []
    for axis, idx, pos in cases:
        jb = jfraud.build_befp(bad, axis, idx, positions=pos)
        pb = fraud.build_befp(bad, axis, idx, positions=pos, device="cpu")
        assert pb.to_dict() == jb.to_dict()
        want.append(jb.to_dict())
    launched = route_launches_to_twin(monkeypatch, twin)
    for (axis, idx, pos), w in zip(cases, want):
        launched.clear()
        got = fraud.build_befp(bad, axis, idx, positions=pos, device="cpu")
        assert got.to_dict() == w
        assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1,
                            "das_proof_gather": 1}, axis


def test_twin_row_set_refuses_what_it_cannot_take(twin):
    """The C entry refuses more than 2k trees, an id at or past 2k, a source
    off a 16-byte boundary, an odd output address and an EDS wider than 256
    rows; nothing is written then."""
    n2 = 8
    src = np.zeros(n2 * n2 * 512 + 32, dtype=np.uint8)
    base = _ptr(src) + (-_ptr(src)) % 16
    out = np.zeros(n2 * n2 * _D + 2, dtype=np.uint8)
    ids = np.arange(2 * n2, dtype=np.uint16)
    assert twin.twin_nmt_leaf_digests_rows(base, _ptr(out), n2, n2, _ptr(ids), 1) == 0
    out[:] = 0
    bad_ids = ids.copy()
    bad_ids[3] = n2
    bad = [
        (base, _ptr(out), n2, n2 + 1, _ptr(ids), 1),        # more than 2k trees
        (base, _ptr(out), n2, 0, _ptr(ids), 1),             # no tree
        (base, _ptr(out), n2, n2, _ptr(bad_ids), 1),        # an id at 2k
        (base + 8, _ptr(out), n2, n2, _ptr(ids), 0),        # unaligned source
        (base, _ptr(out) + 1, n2, n2, _ptr(ids), 1),        # odd output
        (base, _ptr(out), 512, 1, _ptr(ids), 1),            # 2k above 256
        (base, _ptr(out), 6, 2, _ptr(ids), 1),              # 2k not a power of two
    ]
    for args in bad:
        assert twin.twin_nmt_leaf_digests_rows(*args) == 1, args
    assert not out.any()


def test_row_set_wrappers_refuse_before_launching(twin, monkeypatch):
    """The wrappers raise before any launch on what K2's row-set mode does
    not take: more ids than 2k, an id out of range, a source off a 16-byte
    boundary, a block whose row count is not the ids'; none falls back."""
    k = 2
    n2 = 2 * k
    flat = torch.zeros(n2 * n2 * 512 + 16, dtype=torch.uint8)
    off = (-flat.data_ptr()) % 16
    eds = flat[off : off + n2 * n2 * 512].view(n2, n2, 512)
    launched = route_launches_to_twin(monkeypatch, twin)
    with pytest.raises(ValueError, match="1 to 4 EDS row ids"):
        nmt.row_leaf_digests(eds, [0, 1, 2, 3, 0], in_place=True)
    with pytest.raises(ValueError, match="1 to 4 EDS row ids"):
        nmt.row_level_stack(eds, [n2], in_place=True)
    with pytest.raises(ValueError, match="1 to 4 EDS row ids"):
        nmt.row_level_stack(eds[:0], [], in_place=False)
    with pytest.raises(ValueError, match="gathered rows"):
        nmt.row_level_stack(eds[:2], [0, 1, 2])
    shifted = flat[off + 8 : off + 8 + n2 * 512].view(1, n2, 512)
    with pytest.raises(ValueError, match="16-byte boundary"):
        nmt.row_leaf_digests(shifted, [3])
    assert launched == {}
    nmt.row_leaf_digests(eds, [3, 0], in_place=True)
    assert launched == {"nmt_leaf_digests": 1}
