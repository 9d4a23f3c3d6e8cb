"""The port's device-resident DA plane (celestia_tpu_torch.da.device_plane)
against the JAX package's, on the CPU (``device="cpu"``: the plain PyTorch
twins of K1-K5 and K7b).  The bar is byte equality: the EDS, every NMT
level, every root-tree level and the DAH against JAX ``_extend_levels_fn``,
and DAS proofs for every cell against JAX ``device_plane.sample_proofs_batch``
and the JAX host prover.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.da import dah as jdah
from celestia_tpu.da import das as jdas
from celestia_tpu.da import device_plane as jdp
from _torch_common import sha_scan_unrolled_once
from _torch_common import route_launches_to_twin
from _torch_common import codec_pair, torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import dah, das, device_plane, eds_cache
from celestia_tpu_torch.ops import gf256


def _square(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    sq[..., :29] = 0
    sq[..., 28] = np.sort(rng.integers(1, 200, k * k)).reshape(k, k)
    return sq


@lru_cache(maxsize=None)
def _jax_plane(k: int, codec: str):
    """JAX ``_extend_levels_fn(k, codec)`` on ``_square(k, k)``, traced with
    SHA-256's scans unrolled once and compiled at LLVM optimisation level 0
    (the same integer results, a shorter compile): (eds, levels,
    root_levels) as numpy arrays."""
    sq = _square(k, k)
    with sha_scan_unrolled_once():
        lowered = jdp._extend_levels_fn(k, codec, False).lower(sq)
    run = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})
    eds, levels, root_levels = run(sq)
    return (
        np.asarray(eds),
        tuple(np.asarray(lv) for lv in levels),
        tuple(np.asarray(lv) for lv in root_levels),
    )


def _jax_dah(levels, root_levels) -> jdah.DataAvailabilityHeader:
    roots = levels[-1][:, :, 0, :]
    return jdah.DataAvailabilityHeader(
        tuple(r.tobytes() for r in roots[0]),
        tuple(c.tobytes() for c in roots[1]),
        root_levels[-1][0].tobytes(),
    )


@pytest.fixture(autouse=True)
def _clean_cache():
    eds_cache.clear()
    yield
    eds_cache.clear()


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("k", [2, 4])
def test_extend_levels_matches_jax(codec_pair, k):
    eds_j, levels_j, roots_j = _jax_plane(k, codec_pair)
    eds, hdr = device_plane.extend_and_header(_square(k, k), device="cpu")
    entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    assert entry is not None and entry.device == torch.device("cpu")
    np.testing.assert_array_equal(eds.shares, eds_j)
    assert entry.n_levels == len(levels_j)
    for j, lv in enumerate(levels_j):
        # row trees, and the column trees through the transpose view
        np.testing.assert_array_equal(entry.level(j).numpy(), lv)
    got_roots = entry.root_levels()
    assert len(got_roots) == len(roots_j)
    for got, want in zip(got_roots, roots_j):
        np.testing.assert_array_equal(got.numpy(), want)
    hdr_j = _jax_dah(levels_j, roots_j)
    assert (hdr.row_roots, hdr.col_roots, hdr.hash) == (hdr_j.row_roots, hdr_j.col_roots, hdr_j.hash)
    hdr.validate_basic()
    assert entry.nbytes == (
        eds_j.nbytes + levels_j[0][0].nbytes + sum(lv.nbytes for lv in levels_j[1:])
        + sum(r.nbytes for r in roots_j)
    )


def _all_cells(k: int):
    return [(r, c) for r in range(2 * k) for c in range(2 * k)]


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
def test_every_cell_proof_matches_jax(codec_pair):
    k = 4
    eds_j, levels_j, roots_j = _jax_plane(k, codec_pair)
    eds, hdr = dah.extend_and_header(_square(k, k), device="cpu")
    coords = _all_cells(k)
    calls = das.host_prover_calls()
    proofs = das.sample_proofs_batch(eds, hdr, coords)
    assert das.host_prover_calls() == calls  # served by the gather
    hdr_j = _jax_dah(levels_j, roots_j)
    entry_j = jdp.DevicePlaneEntry(
        k, hdr_j.hash, jnp.asarray(eds_j), [jnp.asarray(lv) for lv in levels_j],
        [jnp.asarray(r) for r in roots_j],
    )
    with jdp.forced("on"):
        from_jax_plane = jdp.sample_proofs_batch(entry_j, hdr_j, coords)
    eds_host_j = jdah.ExtendedDataSquare(eds_j)
    for (r, c), p, pj in zip(coords, proofs, from_jax_plane):
        want = jdas._sample_proof_uncached(eds_host_j, hdr_j, r, c).to_dict()
        assert p.to_dict() == pj.to_dict() == want, (r, c)
        assert p.verify(hdr.hash)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_served_proofs_match_jax_sample_proofs_batch(twin, monkeypatch, k):
    """Every cell's proof as the port serves it -- on the plain path, and
    on the card path with each launch sent to the g++ twin (K7b's cell
    mode from the entry; from the EDS with no entry, K1 + K3 over the
    touched rows and K4 for the root tree first) -- against JAX's
    ``sample_proofs_batch`` on JAX's own plane, in the assembled form."""
    codec = gf256.active_codec()
    eds_j, levels_j, roots_j = _jax_plane(k, codec)
    hdr_j = _jax_dah(levels_j, roots_j)
    entry_j = jdp.DevicePlaneEntry(
        k, hdr_j.hash, jnp.asarray(eds_j), [jnp.asarray(lv) for lv in levels_j],
        [jnp.asarray(r) for r in roots_j],
    )
    coords = _all_cells(k)
    with jdp.forced("on"):
        want = [p.to_dict() for p in jdp.sample_proofs_batch(entry_j, hdr_j, coords)]
    eds, hdr = device_plane.extend_and_header(_square(k, k), device="cpu")
    entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    assert [p.to_dict() for p in device_plane.sample_proofs_batch(entry, hdr, coords)] == want
    launched = route_launches_to_twin(monkeypatch, twin)
    assert [p.to_dict() for p in device_plane.sample_proofs_batch(entry, hdr, coords)] == want
    assert launched == {"das_proof_gather": 1}
    assert eds_cache.drop_device_entry(hdr.hash)
    got = device_plane.sample_proofs_from_eds(eds.tensor, hdr, coords[::3])
    assert [p.to_dict() for p in got] == want[::3]
    assert launched["das_proof_gather"] == 2 and launched["rfc6962_root"] == 1


def test_entry_from_jax_arrays_serves_the_same_proofs():
    k = 4
    codec = gf256.active_codec()
    eds_j, levels_j, roots_j = _jax_plane(k, codec)
    hdr_j = _jax_dah(levels_j, roots_j)
    entry = device_plane.entry_from_arrays(k, hdr_j.hash, eds_j, levels_j, roots_j, device="cpu")
    eds = dah.ExtendedDataSquare(eds_j)
    hdr = dah.DataAvailabilityHeader(hdr_j.row_roots, hdr_j.col_roots, hdr_j.hash)
    coords = _all_cells(k)
    got = device_plane.sample_proofs_batch(entry, hdr, coords)
    eds_host_j = jdah.ExtendedDataSquare(eds_j)
    for (r, c), p in zip(coords, got):
        assert p.to_dict() == jdas._sample_proof_uncached(eds_host_j, hdr_j, r, c).to_dict()
    # parked under the data root, the entry serves das.sample_proofs_batch
    eds_cache.put_device_entry(hdr.hash, entry)
    calls = das.host_prover_calls()
    assert [p.to_dict() for p in das.sample_proofs_batch(eds, hdr, coords)] == [
        p.to_dict() for p in got
    ]
    assert das.host_prover_calls() == calls


def test_entry_from_arrays_rejects_a_foreign_layout():
    k = 2
    eds_j, levels_j, roots_j = _jax_plane(k, gf256.active_codec())
    bad = list(levels_j)
    bad[0] = bad[0].copy()
    bad[0][1, 0, 1, 0] ^= 1  # column leaves no longer the transpose
    with pytest.raises(ValueError, match="transpose"):
        device_plane.entry_from_arrays(k, b"\0" * 32, eds_j, bad, roots_j, device="cpu")
    with pytest.raises(ValueError, match="malformed"):
        device_plane.entry_from_arrays(k, b"\0" * 32, eds_j, levels_j, roots_j[1:], device="cpu")


def test_eviction_serves_the_same_bytes_from_the_host_prover():
    k = 4
    eds, hdr = dah.extend_and_header(_square(k, 31), device="cpu")
    coords = [(0, 0), (1, 5), (7, 2), (4, 4), (2, 7), (6, 6)]
    first = das.sample_proofs_batch(eds, hdr, coords)
    calls = das.host_prover_calls()
    assert eds_cache.drop_device_entry(hdr.hash)
    assert eds_cache.get_device_entry(hdr.hash, "cpu") is None
    second = das.sample_proofs_batch(eds, hdr, coords)
    assert das.host_prover_calls() == calls + 1
    assert [p.to_dict() for p in first] == [p.to_dict() for p in second]
    for (r, c), p in zip(coords, second):
        assert p == das._sample_proof_uncached(eds, hdr, r, c)
        assert p.verify(hdr.hash)


def test_device_handle_budget_evicts_lru():
    max_entries = eds_cache.device_cache("cpu").max_entries
    roots = []
    for i in range(max_entries + 1):
        _, hdr = dah.extend_and_header(_square(2, 100 + i), device="cpu")
        roots.append(hdr.hash)
    assert eds_cache.get_device_entry(roots[0], "cpu") is None  # LRU evicted
    for root in roots[1:]:
        assert eds_cache.get_device_entry(root, "cpu") is not None
    stats = eds_cache.device_handle_stats("cpu")
    assert stats["evictions"] == 1
    assert stats["entries"] == max_entries
    assert stats["approx_bytes"] == max_entries * eds_cache.get_device_entry(roots[-1], "cpu").nbytes


@pytest.mark.parametrize("fault", ["shape", "device"])
def test_malformed_entry_raises_and_is_not_served_by_the_host(fault):
    k = 2
    eds, hdr = dah.extend_and_header(_square(k, 41), device="cpu")
    entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    levels = list(entry.levels)
    if fault == "shape":
        levels[0] = levels[0][:, :1].contiguous()
    else:  # a tensor on another device than the rest of the entry
        levels[0] = torch.empty(levels[0].shape, dtype=torch.uint8, device="meta")
    bad = device_plane.DevicePlaneEntry(k, hdr.hash, entry.eds, entry.grid, levels, entry.root_tree)
    eds_cache.put_device_entry(hdr.hash, bad)
    calls = das.host_prover_calls()
    with pytest.raises(ValueError, match="malformed|spans"):
        das.sample_proofs_batch(eds, hdr, [(0, 0), (3, 1)])
    assert das.host_prover_calls() == calls


def test_extend_block_parks_the_entry_and_matches_jax():
    from celestia_tpu.da.square import build as jbuild
    from celestia_tpu_torch.da.square import build

    txs = [bytes([i]) * (300 + 37 * i) for i in range(30)]
    _, hdr_j = jdah.extend_block(jbuild(txs)[0])
    sq, _, _ = build(txs)
    eds, hdr = dah.extend_block(sq, device="cpu")
    assert hdr.hash == hdr_j.hash
    entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    assert entry.k == sq.size and entry.eds is eds.tensor


def test_entry_of_another_device_is_not_served_nor_displaced():
    k = 4
    sq = _square(k, 51)
    eds, hdr = dah.extend_and_header(sq, device="cpu")
    coords = [(0, 3), (5, 0), (7, 7), (2, 6)]
    cpu_entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    # the same block's entry, parked on another device
    other = device_plane.DevicePlaneEntry(
        k, hdr.hash,
        *(torch.empty_like(t, device="meta") for t in (cpu_entry.eds, cpu_entry.grid)),
        [torch.empty_like(t, device="meta") for t in cpu_entry.levels],
        torch.empty_like(cpu_entry.root_tree, device="meta"),
    )
    eds_cache.put_device_entry(hdr.hash, other)
    assert eds_cache.drop_device_entry(hdr.hash, "cpu")
    assert eds_cache.get_device_entry(hdr.hash, "meta") is other
    calls = das.host_prover_calls()
    got = das.sample_proofs_batch(eds, hdr, coords)  # a miss for the CPU EDS
    assert das.host_prover_calls() == calls + 1
    assert got == [das._sample_proof_uncached(eds, hdr, r, c) for r, c in coords]
    # a plain-path extend of the same block parks its own entry beside it
    eds2, hdr2 = dah.extend_and_header(sq, device="cpu")
    assert hdr2.hash == hdr.hash
    assert eds_cache.get_device_entry(hdr.hash, "meta") is other
    assert eds_cache.get_device_entry(hdr.hash, "cpu").eds is eds2.tensor
    assert das.sample_proofs_batch(eds2, hdr2, coords) == got
    assert das.host_prover_calls() == calls + 1
    assert eds_cache.drop_device_entry(hdr.hash)  # every device
    assert eds_cache.get_device_entry(hdr.hash, "meta") is None
    assert eds_cache.get_device_entry(hdr.hash, "cpu") is None


@pytest.mark.parametrize("entry_cached", [True, False])
def test_proofs_from_the_eds_match_the_host_prover(entry_cached):
    """The card's miss path (touched rows' level stacks, root tree and one
    gather on the EDS's device), here on the plain twins."""
    k = 4
    eds, hdr = dah.extend_and_header(_square(k, 61), device="cpu")
    if not entry_cached:  # the root tree is then rebuilt from the DAH
        assert eds_cache.drop_device_entry(hdr.hash)
    coords = [(7, 1), (0, 0), (7, 7), (3, 5), (0, 0), (4, 2)]  # unsorted, repeated
    calls = das.host_prover_calls()
    got = device_plane.sample_proofs_from_eds(eds.tensor, hdr, coords)
    assert das.host_prover_calls() == calls
    eds_host_j = jdah.ExtendedDataSquare(eds.shares.copy())
    hdr_j = jdah.DataAvailabilityHeader(hdr.row_roots, hdr.col_roots, hdr.hash)
    for (r, c), p in zip(coords, got):
        assert p == das._sample_proof_uncached(eds, hdr, r, c)
        assert p.to_dict() == jdas._sample_proof_uncached(eds_host_j, hdr_j, r, c).to_dict()
        assert p.verify(hdr.hash)
