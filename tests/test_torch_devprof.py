"""The port's device observability (``celestia_tpu_torch/utils/devprof.py``)
against the JAX package's.

The same seeded extend, serve, repair, batched, root, hash and sharded
calls go through both packages, each under its own ``devprof.collect()``
window (the JAX package with its device-resident plane forced on, as its
own tests force it); the dispatch names and counts and the transfer legs
with their bytes and events must be equal.  One difference is pinned, not
hidden: a served proof's record in the port's K7b gather is padded to 16
bytes, so the ``proof_gather`` leg carries each cell's proof bytes rounded
up to 16.  Then the port's own contract on the CPU: inactive, a bracket is
the shared no-op; a traced run's document validates with device spans
parented under host spans; the cost table's bytes and operations are the
formulas ``chip_smoke.py`` imports; the memory watermark, the profiler
capture, the exposition, and a CUDA error inside a bracket raising.  JAX
cost compiles (``note_compile``) are switched off: the port has no XLA
cost table to compare them with.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from celestia_tpu.da import dah as jax_dah
from celestia_tpu.da import das as jax_das
from celestia_tpu.da import device_plane as jax_plane
from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.ops import nmt as jax_nmt
from celestia_tpu.ops import rs as jax_rs
from celestia_tpu.ops import sha256 as jax_sha
from celestia_tpu.parallel import sharded as jax_sharded
from celestia_tpu.utils import devprof as jax_devprof
from celestia_tpu.utils import tracing as jax_tracing
from _torch_common import sha_scan_unrolled_once, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.da import dah, das, device_plane, eds_cache
from celestia_tpu_torch.ops import nmt, rs, sha256
from celestia_tpu_torch.parallel import sharded
from celestia_tpu_torch.utils import devprof, tracing
from celestia_tpu_torch.utils.telemetry import validate_exposition

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the formulas it imports from the port)

K = 2


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Both packages' devprof and tracing reset, their EDS caches cleared,
    and the JAX cost compiles switched off."""
    monkeypatch.setattr(jax_devprof, "note_compile", lambda *a, **kw: None)
    for mod in (jax_devprof, devprof):
        mod.reset()
    yield
    for mod in (jax_devprof, devprof):
        mod.reset()
    for tr in (jax_tracing, tracing):
        tr.disable()
        tr.clear()
    jax_eds_cache.clear()
    eds_cache.clear()


def square(seed: int, k: int = K) -> np.ndarray:
    sq = np.random.default_rng(seed).integers(0, 256, (k, k, 512), dtype=np.uint8)
    sq[..., :29] = 0  # one namespace: the NMT orders the leaves
    return sq


def ledger(mod) -> tuple:
    """The window's dispatch counts and its transfer legs without their ms."""
    legs = {leg: {k: v for k, v in rec.items() if not k.endswith("_ms")}
            for leg, rec in mod.transfer_accounting().items()}
    return mod.device_profile()["dispatches"], legs


def cells(k: int):
    return [(r, c) for r in range(2 * k) for c in range(2 * k)][::3]


def _jax_extend():
    with jax_plane.forced("on"), sha_scan_unrolled_once():
        jax_dah.extend_and_header(square(1))


def _port_extend():
    # the port's plane, called directly: dah's CPU entry runs the host regime
    device_plane.extend_and_header(square(1), device="cpu")


def _serve_setup(side):
    if side == "jax":
        with jax_plane.forced("on"), sha_scan_unrolled_once():
            return jax_dah.extend_and_header(square(2))
    return device_plane.extend_and_header(square(2), device="cpu")


def _jax_serve(setup):
    with jax_plane.forced("on"):
        jax_das.sample_proofs_batch(*setup, cells(K))


def _port_serve(setup):
    das.sample_proofs_batch(*setup, cells(K))


def _repair_setup(side):
    eds, hdr = dah.extend_and_header(square(3), device="cpu")
    avail = np.ones((2 * K, 2 * K), dtype=bool)
    avail[:K, :K] = False  # Q0 withheld: one phase of rows
    roots = [np.frombuffer(b"".join(r), dtype=np.uint8).reshape(2 * K, 90)
             for r in (hdr.row_roots, hdr.col_roots)]
    return eds.shares, avail, roots


def _jax_repair(setup):
    shares, avail, roots = setup
    with sha_scan_unrolled_once():
        jax_rs.repair_square_device(shares, avail, *roots)


def _port_repair(setup):
    shares, avail, roots = setup
    rs.repair_square_device(shares, avail, *roots, device="cpu")


def _jax_batched():
    np.asarray(jax_rs.extend_squares_batched(np.stack([square(4), square(5)])))


def _port_batched():
    dah.data_roots_batched(np.stack([square(4), square(5)]), device="cpu")


def _roots_setup(side):
    return dah.extend_and_header(square(6), device="cpu")[0].shares


def _jax_roots(shares):
    # the JAX header's device leg (its host regime takes the native one)
    with sha_scan_unrolled_once():
        jax_nmt.eds_nmt_roots_device(shares)


def _port_roots(shares):
    # the port's bracketed device leg (its host regime takes the native one)
    nmt.eds_nmt_roots_device(torch.from_numpy(shares.copy()))


MSGS = np.random.default_rng(7).integers(0, 256, (6, 91), dtype=np.uint8)


def _jax_sha():
    with sha_scan_unrolled_once():
        jax_sha.sha256_np(MSGS)


def _port_sha():
    sha256.sha256(torch.from_numpy(MSGS.copy()))


class _ShardedOutputs:
    """Stands in for the JAX package's ``shard_map`` program (``_sharded_fn``,
    ~20 s of compile a mesh on the CPU) with its outputs, taken from the
    port's run of the same squares (tests/test_torch_sharded.py holds the
    two byte-equal): the JAX module's upload, dispatch bracket and fetches
    around the program run as they are."""

    def __init__(self, batched: bool):
        self.batched = batched

    def __call__(self, mesh, k, batched, codec):
        def run(x):
            squares = np.asarray(x) if self.batched else np.asarray(x)[None]
            got = sharded.extend_and_roots_sharded_batch(squares, sharded.make_mesh(["cpu"]))
            eds, rr, cc, dr = (np.asarray(a) for a in got)
            n2 = eds.shape[1]
            # the program's row-shard layout: (n, k, 2, 2k, B), top rows then bottom
            local = np.stack([eds[:, : n2 // 2], eds[:, n2 // 2:]], axis=2)
            out = (local, rr, cc, dr) if self.batched else (local[0], rr[0], cc[0], dr[0])
            return tuple(jax.numpy.asarray(a) for a in out)

        return run


def _jax_sharded():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded, "_sharded_fn", _ShardedOutputs(batched=False))
        jax_sharded.extend_and_header_sharded(
            square(8), jax_sharded.make_mesh(jax.devices()[:2], data=1, row=2))


def _port_sharded():
    sharded.extend_and_header_sharded(square(8), sharded.make_mesh(["cpu"] * 2))


def _jax_sharded_batch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded, "_sharded_fn", _ShardedOutputs(batched=True))
        jax_sharded.extend_and_headers_sharded_batch(
            np.stack([square(9), square(10)]),
            jax_sharded.make_mesh(jax.devices()[:4], data=2, row=2))


def _port_sharded_batch():
    sharded.extend_and_headers_sharded_batch(
        np.stack([square(9), square(10)]), sharded.make_mesh(["cpu"] * 4, data=2, row=2))


CALLS = {
    "extend": (None, _jax_extend, _port_extend),
    "batched": (None, _jax_batched, _port_batched),
    "roots": (_roots_setup, _jax_roots, _port_roots),
    "sha256": (None, _jax_sha, _port_sha),
    "repair": (_repair_setup, _jax_repair, _port_repair),
    "sharded": (None, _jax_sharded, _port_sharded),
    "sharded_batch": (None, _jax_sharded_batch, _port_sharded_batch),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_dispatches_and_transfer_legs_match_jax(call):
    setup, jax_call, port_call = CALLS[call]
    got = {}
    for side, mod, fn in (("jax", jax_devprof, jax_call), ("port", devprof, port_call)):
        arg = setup(side) if setup else None
        with mod.collect():
            fn(arg) if setup else fn()
            got[side] = ledger(mod)
    assert got["port"] == got["jax"]
    assert got["port"][0], "the call recorded no dispatch"


def test_serving_dispatch_and_legs_match_jax_with_padded_records():
    got = {}
    for side, mod, fn in (("jax", jax_devprof, _jax_serve), ("port", devprof, _port_serve)):
        setup = _serve_setup(side)
        with mod.collect():
            fn(setup)
            got[side] = ledger(mod)
    (jd, jl), (pd, pl) = got["jax"], got["port"]
    assert pd == jd == {"das_proof_gather": 1}
    assert set(pl) == set(jl) == {"proof_gather"}
    n = len(cells(K))
    per_cell = jl["proof_gather"]["d2h_bytes"] // n
    assert per_cell * n == jl["proof_gather"]["d2h_bytes"]
    # the port's record: the same proof bytes, zeros up to 16
    assert pl["proof_gather"] == dict(jl["proof_gather"], d2h_bytes=n * (-(-per_cell // 16) * 16))


def test_inactive_dispatch_is_the_shared_noop(monkeypatch):
    assert not devprof.active()

    def no_events(*a, **kw):
        raise AssertionError("an inactive bracket recorded an event")

    monkeypatch.setattr(torch.cuda, "Event", no_events)
    d = devprof.dispatch("anything", torch.device("cuda:0"), k=1)
    assert d is devprof.NULL_DISPATCH
    sentinel = object()
    assert d.done(sentinel) is sentinel
    devprof.record_transfer("leg", "h2d", 10)
    t = torch.arange(4)
    assert torch.equal(devprof.fetch("leg", t), t)
    assert devprof.transfer_accounting() == {}
    assert devprof.device_profile()["dispatches"] == {}


def test_traced_run_validates_with_device_spans_under_host_spans():
    tracing.enable(4)
    with tracing.block_span("prepare_proposal", height=3):
        eds, hdr = device_plane.extend_and_header(square(11), device="cpu")
        das.sample_proofs_batch(eds, hdr, cells(K))
    doc = tracing.trace_dump()
    assert tracing.validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_id = {e["args"]["span_id"]: e for e in spans}
    parents = {"device.extend_levels": "extend.device_plane",
               "device.das_proof_gather": "das.device_gather"}
    device = [e for e in spans if e["cat"] == "device"]
    assert sorted(e["name"] for e in device) == sorted(parents)
    for e in device:
        assert by_id[e["args"]["parent_id"]]["name"] == parents[e["name"]]
        assert e["tid"] == devprof.DEVICE_TID_BASE
        assert e["args"]["device"] == "cpu:0" and e["args"]["enqueue_ms"] >= 0
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[devprof.DEVICE_TID_BASE] == "device:cpu:0"
    # profiling never changes bytes
    tracing.disable()
    assert device_plane.extend_and_header(square(11), device="cpu")[1].hash == hdr.hash


def test_cost_table_equals_the_formulas_chip_smoke_imports():
    for name in ("compressions", "leopard_extend_ops", "leopard_decode_ops", "leopard_partial_ops",
                 "decode_matrix_ops", "bit_gemm_ops", "bound", "SHA_OPS_PER_COMPRESSION",
                 "INT32_OPS_PER_S"):
        assert getattr(chip_smoke, name) is getattr(devprof, name), name
    c, sha = devprof.compressions, devprof.SHA_OPS_PER_COMPRESSION
    k, n2 = K, 2 * K
    hash_ops = (n2 * n2 * c(542) + 2 * n2 * (n2 - 1) * c(181)) * sha
    tree_ops = (4 * k * c(91) + (4 * k - 1) * c(65)) * sha
    with devprof.collect():
        eds, hdr = device_plane.extend_and_header(square(12), device="cpu")
        das.sample_proofs_batch(eds, hdr, cells(K))
        setup = _repair_setup("port")
        _port_repair(setup)
        _port_batched()
        _port_sha()
        _port_sharded()
        nmt.eds_nmt_roots_device(eds.tensor)
        table = devprof.device_profile()["kernels"]
    n_cells = len(cells(K))
    payload = 512 + 32 * 3 + 90 * 2  # share, log2(4k) aunts, log2(2k) siblings
    want = {
        "extend_levels": (k * k * 512 + n2 * n2 * 512 + n2 * n2 * 90 + 2 * n2 * (n2 - 1) * 90
                          + (8 * k - 1) * 32,
                          devprof.leopard_extend_ops(k) + hash_ops + tree_ops),
        "das_proof_gather": (n_cells * payload + n_cells * 800 + 12 * n_cells, 0),
        "rs_repair_verify": (2 * n2 * n2 * 512 + 3 * n2 * n2 + 2 * n2 * 90,
                             devprof.decode_matrix_ops(k, k) + devprof.leopard_decode_ops(k, k)
                             + devprof.leopard_extend_ops(k) + hash_ops),
        "rs_extend_batched": (2 * (k * k * 512 + n2 * n2 * 512), 2 * devprof.leopard_extend_ops(k)),
        "sha256_batch": (6 * (91 + 32), 6 * c(91) * sha),
        "extend_sharded": (k * k * 512 + n2 * n2 * 512 + 2 * n2 * 90 + 32,
                           devprof.leopard_extend_ops(k) + hash_ops + tree_ops),
        "eds_nmt_roots": (n2 * n2 * 512 + 2 * n2 * 90, hash_ops),
    }
    assert set(table) == set(want)
    for name, (nbytes, ops) in want.items():
        row = table[name]
        assert (row["bytes"], row["ops"]) == (nbytes, ops), name
        assert (row["bound_ms"], row["bound_by"]) == devprof.bound(
            nbytes, ops, devprof.INT32_OPS_PER_S), name


def test_memory_sampling_on_the_cpu_is_a_note():
    assert devprof.sample_memory("cpu") is None
    assert devprof.device_profile()["notes"]["memory_stats"]["count"] == 1
    assert devprof.device_profile()["mem"] == {"available": False}


def test_memory_sampling_folds_the_cuda_allocator_stats(monkeypatch):
    stats = {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 900,
             "reserved_bytes.all.current": 1024}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 1000})())
    out = devprof.sample_memory("cuda:0")
    assert out == {"bytes_in_use": 100, "peak_bytes_in_use": 900, "bytes_reserved": 1024,
                   "bytes_limit": 1000, "frac": 0.1, "peak_frac": 0.9}
    lines = devprof.exposition_lines()
    assert "celestia_tpu_device_mem_bytes_in_use 100" in lines
    assert "celestia_tpu_device_mem_peak_frac 0.9" in lines


class _FailingEvent:
    """A CUDA event whose synchronise reports an asynchronous launch error."""

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_a_cuda_error_inside_a_bracket_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FailingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    with devprof.collect():
        d = devprof.dispatch("extend_levels", torch.device("cuda:0"), k=K, codec="x")
        with pytest.raises(RuntimeError, match="illegal memory access"):
            d.done(None)
        assert devprof.device_profile()["dispatches"] == {}


def test_profiler_capture_writes_a_chrome_trace(tmp_path):
    assert devprof.start_profiler(str(tmp_path))
    assert devprof.profiler_dir() == str(tmp_path)
    dah.extend_and_header(square(13), device="cpu")
    path = devprof.stop_profiler()
    assert path == str(tmp_path / devprof.PROFILE_TRACE_FILE)
    assert json.loads(Path(path).read_text())["traceEvents"]
    assert devprof.stop_profiler() is None


def test_exposition_and_profile_after_a_window():
    with devprof.collect():
        eds, hdr = device_plane.extend_and_header(square(14), device="cpu")
        das.sample_proofs_batch(eds, hdr, cells(K))
        prof = devprof.device_profile()
        lines = devprof.exposition_lines()
    assert validate_exposition("\n".join(lines) + "\n") == []
    assert prof["platform"] == "cpu" and prof["num_devices"] == 0
    assert prof["dispatches"] == {"extend_levels": 1, "das_proof_gather": 1}
    assert set(prof["device_busy_ms"]) == {"cpu:0"}
    for name in prof["dispatches"]:
        for field in ("bytes", "ops", "bound_ms"):
            assert any(line.startswith(f'celestia_tpu_kernel_{field}{{kernel="{name}"}}')
                       for line in lines)
    assert any(line.startswith('celestia_tpu_device_busy_ms{device="cpu:0"}') for line in lines)
    assert set(devprof.dispatch_summary()) == {"extend_levels", "das_proof_gather"}
    assert devprof.occupancy_probe() is None  # the first probe has no interval
