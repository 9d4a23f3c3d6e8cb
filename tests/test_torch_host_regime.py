"""The port's host regime (``device="cpu"`` at the block entry points)
against the JAX package's host regime, on the CPU, byte for byte.

Tests run with ``JAX_PLATFORMS=cpu``, where the JAX package's entry points
take its host regime: the native library's fused extension, the row memo
under ``lagrange-gf256``, the native root pass and the native host repair.
The port's ``da/dah.py`` entries and ``ops/rs.py`` ``repair_square`` run
the same legs on the port's own build of the library when the caller asks
for the CPU.  Seeded numpy inputs, both codecs; bytes must be equal, and
the exceptions of a repair that fails must have JAX's type and message.
The port's departures are pinned too: no device without a card raises,
no library raises, a native fault raises without poisoning the library,
and nothing is launched or dispatched.
"""

import hashlib

import numpy as np
import pytest
import torch

from celestia_tpu.da import dah as jdah
from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from celestia_tpu.ops import sha256 as jsha
from _torch_common import sha_scan_unrolled_once
from _torch_common import codec_pair, jitted_jax_level_stack, torch_one_thread  # noqa: F401
from celestia_tpu_torch import kernels
from celestia_tpu_torch.da import das, dah, device_plane, eds_cache, golden
from celestia_tpu_torch.ops import gf256, rs
from celestia_tpu_torch.ops import nmt as pnmt
from celestia_tpu_torch.ops import sha256 as psha
from celestia_tpu_torch.utils import devprof, native
from celestia_tpu_torch.utils.device import backend_available, host_regime

CODECS = gf256.CODECS


@pytest.fixture(autouse=True)
def fresh_memos():
    """Both packages' row memos empty before and after each test."""
    jdah.clear_row_memo()
    dah.clear_row_memo()
    yield
    jdah.clear_row_memo()
    dah.clear_row_memo()


def _square(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    # sorted version-0 namespaces, as a real square has
    ns = np.sort(rng.integers(0, 256, (k * k, 10), dtype=np.uint8).view("S10").ravel())
    sq.reshape(k * k, 512)[:, :19] = 0
    sq.reshape(k * k, 512)[:, 19:29] = np.frombuffer(ns.tobytes(), np.uint8).reshape(-1, 10)
    return sq


def _same(hdr, hdr_j) -> bool:
    return (hdr.row_roots, hdr.col_roots, hdr.hash) == (hdr_j.row_roots, hdr_j.col_roots, hdr_j.hash)


def test_the_regime_is_the_resolved_device():
    assert host_regime("cpu") and host_regime(torch.device("cpu"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_regime()


def test_backend_probe_runs_in_a_child():
    assert backend_available(timeout_s=120.0)  # the CPU counts by default
    assert backend_available(timeout_s=120.0, accept_cpu=False) == torch.cuda.is_available()
    assert not backend_available(timeout_s=1e-3)  # a probe past its time is no backend


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_host_extend_matches_jax_host_regime(codec_pair, k):
    sq = _square(1000 + k, k)
    eds_j, hdr_j = jdah.extend_and_header(sq)  # JAX's host regime (CPU backend)
    eds, hdr = dah.extend_and_header(sq, device="cpu")
    np.testing.assert_array_equal(eds.shares, eds_j.shares)
    assert _same(hdr, hdr_j)
    hdr.validate_basic()
    # the port's plane on the CPU (the plain twins) gives the same bytes
    eds_p, hdr_p = device_plane.extend_and_header(sq, device="cpu")
    np.testing.assert_array_equal(eds_p.shares, eds.shares)
    assert hdr_p == hdr


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_host_regime_gives_the_go_pinned_hashes(codec_pair):
    assert dah.min_data_availability_header(device="cpu").hash == golden.MIN_DAH_HASH
    _, hdr = dah.extend_and_header(golden.fixture_shares(4).reshape(2, 2, 512), device="cpu")
    assert hdr.hash == golden.DAH_2X2_HASH
    square = golden.fixture_shares(128 * 128).reshape(128, 128, 512)
    eds, hdr = dah.extend_and_header(square, device="cpu")
    assert hdr.hash == golden.DAH_128_HASH
    assert dah.new_data_availability_header(eds, device="cpu").hash == golden.DAH_128_HASH


def test_extend_block_and_min_dah_match_jax_host_regime():
    from celestia_tpu.da.square import build as jbuild
    from celestia_tpu_torch.da.square import build

    txs = [bytes([i]) * (300 + 37 * i) for i in range(40)]
    _, hdr_j = jdah.extend_block(jbuild(txs)[0])
    eds, hdr = dah.extend_block(build(txs)[0], device="cpu")
    assert _same(hdr, hdr_j) and eds.tensor.device.type == "cpu"
    assert dah.min_data_availability_header(device="cpu").hash == (
        jdah.min_data_availability_header().hash
    )


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
@pytest.mark.parametrize("k", [1, 4, 16])
def test_roots_and_new_dah_match_jax_host_regime(codec_pair, k):
    eds_j, _ = jdah.extend_and_header(_square(2000 + k, k))
    shares = np.asarray(eds_j.shares)
    for nthreads in (None, 1, 3):
        np.testing.assert_array_equal(
            pnmt.eds_nmt_roots_host(shares, nthreads=nthreads),
            jnmt.eds_nmt_roots_host(shares, nthreads=nthreads),
        )
    hdr_j = jdah.new_data_availability_header(jdah.ExtendedDataSquare(shares))
    hdr = dah.new_data_availability_header(dah.ExtendedDataSquare(shares), device="cpu")
    assert _same(hdr, hdr_j)


@pytest.mark.parametrize("shape", [(7, 91), (3, 5, 65), (4, 0)])
def test_sha256_np_matches_jax_and_hashlib(shape):
    msgs = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = psha.sha256_np(msgs, device="cpu")
    with sha_scan_unrolled_once():
        want = jsha.sha256_np(msgs)
    np.testing.assert_array_equal(got, want)
    flat = msgs.reshape(int(np.prod(shape[:-1])), shape[-1])
    assert [r.tobytes() for r in got.reshape(-1, 32)] == [
        hashlib.sha256(m.tobytes()).digest() for m in flat
    ]


def _memo_run(extend, stats, squares):
    """The EDS bytes and DAHs of ``squares`` in turn, then the memo's stats."""
    out = [extend(sq) for sq in squares]
    return [(np.asarray(e.shares), h) for e, h in out], stats()


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_row_memo_matches_jax(codec_pair):
    """A square, then one that shares 3/4 of its rows: under lagrange-gf256
    the second is assembled from the memo in both packages, with equal
    stats and the cold path's bytes; under leopard-ff8 neither memo is
    touched."""
    k = 16
    first = _square(3000, k)
    second = first.copy()
    second[k * 3 // 4 :] = _square(3001, k)[k * 3 // 4 :]
    got, stats = _memo_run(lambda s: dah.extend_and_header(s, device="cpu"),
                           dah.row_memo_stats, [first, second])
    want, stats_j = _memo_run(jdah.extend_and_header, jdah.row_memo_stats, [first, second])
    assert stats == stats_j
    for (eds, hdr), (eds_j, hdr_j) in zip(got, want):
        np.testing.assert_array_equal(eds, eds_j)
        assert _same(hdr, hdr_j)
    cold_eds, cold_hdr = dah._extend_and_header_host(second)
    np.testing.assert_array_equal(got[1][0], cold_eds.shares)
    assert got[1][1] == cold_hdr
    if codec_pair == gf256.CODEC_LAGRANGE:
        assert stats["assembled"] == 1 and stats["hits"] == k * 3 // 4
        assert stats["inserted"] == k + k // 4
        assert stats["reuse_pct"] == 100.0 * (k * 3 // 4) / (2 * k)
    else:
        assert stats == {"entries": 0, "lookups": 0, "hits": 0, "inserted": 0,
                         "assembled": 0, "reuse_pct": 0.0, "approx_bytes": 0}


def _eds(seed: int, k: int, B: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    square = rng.integers(0, 256, (k, k, B), dtype=np.uint8)
    return np.asarray(jrs.extend_square(square))


def _outcome(fn, *args, **kwargs):
    """("ok", bytes) of what ``fn`` returns, or (exception type name, message)."""
    try:
        return "ok", np.asarray(fn(*args, **kwargs)).tobytes()
    except Exception as e:  # the comparison is of whatever either raises
        return type(e).__name__, str(e)


def _repair_cases():
    """(name, eds, avail, roots or None) for the masks of
    tests/test_torch_repair.py, the damaged cells filled with garbage."""
    from test_torch_repair import _deep_peel_mask

    cases = []
    k = 8
    rng = np.random.default_rng(k * 13)
    eds = _eds(k * 13, k, 32)
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    avail[rng.choice(2 * k, k, replace=False), :] = False
    avail[:, rng.choice(2 * k, k, replace=False)] = False
    cases.append(("rows_and_cols", eds, avail, None))
    k = 4
    rng = np.random.default_rng(31)
    eds = _eds(31, k, 512)
    roots = np.asarray(jnmt.eds_nmt_roots_host(eds))
    avail = rng.random((2 * k, 2 * k)) < 0.7
    for r in range(2 * k):
        if avail[r].sum() < k:
            avail[r, rng.choice(2 * k, k, replace=False)] = True
    cases.append(("random_with_roots", eds, avail, roots))
    rng = np.random.default_rng(43)
    cases.append(("random_25pct", _eds(43, 4, 512), rng.random((8, 8)) >= 0.25, None))
    eds = _eds(33, 4, 16)
    avail = np.ones((8, 8), dtype=bool)
    avail[0, :4] = False
    bad = eds.copy()
    bad[0, 4] ^= 1  # a provided Q1 cell off the codeword
    cases.append(("inconsistent_codeword", bad, avail, None))
    eds = _eds(34, 2, 512)
    avail = np.ones((4, 4), dtype=bool)
    avail[1, 0] = False
    cases.append(("wrong_roots", eds, avail, np.zeros((2, 4, 90), dtype=np.uint8)))
    avail = np.zeros((4, 4), dtype=bool)
    avail[0, 0] = True
    cases.append(("stalled", _eds(0, 2, 8), avail, None))
    eds = _eds(41, 4, 16)
    avail = np.ones((8, 8), dtype=bool)
    avail[0, :3] = False
    bad = eds.copy()
    bad[0, 7] ^= 0x04  # a provided cell that a matrix decode overwrites
    cases.append(("flipped_provided_cell", bad, avail, None))
    cases.append(("deep_peel", _eds(47, 8, 32), _deep_peel_mask(), None))
    cases.append(("nothing_missing", _eds(35, 2, 8), np.ones((4, 4), dtype=bool), None))
    return cases


REPAIR_CASES = [c[0] for c in _repair_cases()]


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
@pytest.mark.parametrize("case", REPAIR_CASES)
def test_host_repair_matches_jax_host_repair(codec_pair, case):
    name, eds, avail, roots = next(c for c in _repair_cases() if c[0] == case)
    damaged = eds.copy()
    damaged[~avail] = 0xA5
    row_roots, col_roots = (None, None) if roots is None else (roots[0], roots[1])
    for nthreads in (1, 4):
        got = _outcome(rs.repair_square, damaged, avail, row_roots, col_roots, nthreads=nthreads)
        want = _outcome(jrs.repair_square, damaged, avail, row_roots, col_roots,
                        nthreads=nthreads)
        assert got == want, (name, nthreads)
    assert (damaged[~avail] == 0xA5).all()  # the caller's array is not written
    if name in ("rows_and_cols", "random_with_roots", "random_25pct", "deep_peel",
                "nothing_missing"):
        assert got == ("ok", eds.tobytes())
    if name == "flipped_provided_cell":
        # the Leopard decoder writes only erased cells, so the flip shows as
        # a codeword off its Q0; the Lagrange matrices overwrite the axis
        which = ("inconsistent erasure coding" if codec_pair == gf256.CODEC_LEOPARD
                 else "provided shares disagree")
        assert got[0] == "ByzantineError" and which in got[1]


def test_device_none_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    square = golden.fixture_shares(4).reshape(2, 2, 512)
    for call in (lambda: dah.extend_and_header(square),
                 lambda: dah.extend_and_header_breakdown(square),
                 lambda: dah.new_data_availability_header(dah.ExtendedDataSquare(
                     np.zeros((4, 4, 512), dtype=np.uint8)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_without_the_native_library_a_cpu_entry_raises(monkeypatch):
    from celestia_tpu_torch.da.square import build

    square = _square(5, 2)
    eds, hdr = dah.extend_and_header(square, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(dah, "_min_dah", {})
    calls = {
        "extend_and_header": lambda: dah.extend_and_header(square, device="cpu"),
        "extend_block": lambda: dah.extend_block(build([])[0], device="cpu"),
        "min_dah": lambda: dah.min_data_availability_header(device="cpu"),
        "new_dah": lambda: dah.new_data_availability_header(eds, device="cpu"),
        "breakdown": lambda: dah.extend_and_header_breakdown(square, device="cpu"),
        "repair": lambda: rs.repair_square(eds.shares, np.ones((4, 4), dtype=bool)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="native library is unavailable"):
            call()
    # the plane on the CPU, which tests call directly, does not need it
    assert device_plane.extend_and_header(square, device="cpu")[1] == hdr


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_a_native_fault_raises_and_poisons_nothing(codec_pair, monkeypatch):
    square = _square(6, 4)
    want = dah.extend_and_header(square, device="cpu")[1]

    def fault(*args, **kwargs):
        raise OSError("injected native fault")

    leg = ("extend_block_leopard_cpu" if codec_pair == gf256.CODEC_LEOPARD
           else "extend_block_cpu")
    with monkeypatch.context() as mp:
        mp.setattr(native, leg, fault)
        with pytest.raises(OSError, match="injected native fault"):
            dah.extend_and_header(_square(7, 4), device="cpu")
        with pytest.raises(OSError, match="injected native fault"):
            dah.extend_and_header_breakdown(square, device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(native, "eds_nmt_roots", fault)
        with pytest.raises(OSError, match="injected native fault"):
            dah.new_data_availability_header(dah.ExtendedDataSquare(np.zeros(
                (8, 8, 512), dtype=np.uint8)), device="cpu")
    assert native.poisoned() is None and native.available()
    assert dah.extend_and_header(square, device="cpu")[1] == want


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_the_host_regime_launches_and_dispatches_nothing(codec_pair):
    k = 4
    square = _square(8, k)
    kernels.reset_launch_counts()
    eds_cache.clear()
    with devprof.collect():
        eds, hdr = dah.extend_and_header(square, device="cpu")
        dah.new_data_availability_header(eds, device="cpu")
        dah.extend_and_header_breakdown(square, device="cpu")
        rs.repair_square(eds.shares, np.ones((2 * k, 2 * k), dtype=bool))
        calls = das.host_prover_calls()
        proofs = das.sample_proofs_batch(eds, hdr, [(0, 0), (2 * k - 1, 3)])
        assert all(p.verify(hdr.hash) for p in proofs)
        assert devprof.device_profile()["dispatches"] == {}
        # the plane on the CPU, for contrast, is a dispatch
        device_plane.extend_and_header(square, device="cpu")
        assert devprof.device_profile()["dispatches"] == {"extend_levels": 1}
    assert set(kernels.launch_counts().values()) == {0}
    # no entry was parked by the host regime: the host prover served DAS
    assert das.host_prover_calls() == calls + 1
    eds_cache.clear()


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_breakdown_splits_the_host_leg(codec_pair):
    square = _square(9, 8)
    eds, hdr, split = dah.extend_and_header_breakdown(square, device="cpu")
    eds_w, hdr_w = dah.extend_and_header(square, device="cpu")
    np.testing.assert_array_equal(eds.shares, eds_w.shares)
    assert hdr == hdr_w
    assert set(split) == {"upload_ms", "compute_ms", "fetch_ms"}
    assert all(v >= 0.0 for v in split.values())


def test_a_testnode_on_the_cpu_matches_jax_at_k16(jitted_jax_level_stack):
    """One seeded stream through the JAX TestNode and the port's
    ``TestNode(device="cpu")`` at GovMaxSquareSize 16: equal data roots and
    proof answers; the port's blocks were extended by the host regime
    (no device entry parked) and DAS is served by its host prover."""
    import test_torch_node as tn

    saved = (jgf256.active_codec(), gf256.active_codec())
    try:
        ref = tn.Chain(tn.JAX, gf256.CODEC_LEOPARD, 16)
        port = tn.Chain(tn.PORT, gf256.CODEC_LEOPARD, 16)
        rng = np.random.default_rng(216)
        blocks = tn.run_height(ref, port, tn.stream(rng, "overfill", 16), "produce")[1]
        assert [b.header.square_size for b in blocks] == [16]
        calls = das.host_prover_calls()
        for blk in blocks:
            assert blk.header.data_hash == ref.node.block(blk.header.height).header.data_hash
            assert eds_cache.get_device_entry(blk.header.data_hash, "cpu") is None
            for route in tn.ROUTES:
                if route == "custom/proof/tx" and not blk.txs:
                    continue
                assert tn.answer(port.node, route, blk) == tn.answer(ref.node, route, blk)
        assert das.host_prover_calls() > calls
    finally:
        jgf256.set_active_codec(saved[0], force=True)
        gf256.set_active_codec(saved[1], force=True)
        jax_eds_cache.clear()
        eds_cache.clear()
