"""The port's sharded block extension (celestia_tpu_torch.parallel) on
meshes of repeated CPU devices, against the JAX package: its single-device
extension and roots, its bit-lift partial and its ``shard_map`` program,
and the port's own single-device path.  The bar is byte equality
(tolerance 0): one differing bit forks consensus.
"""

import os
import subprocess
import sys
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celestia_tpu.da import dah as jdah
from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from _torch_common import codec_pair, pinned_codec, torch_one_thread  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import dah
from celestia_tpu_torch.ops import gf256, rs
from celestia_tpu_torch.parallel import collectives, mesh as mesh_mod, sharded

ROOT = Path(__file__).resolve().parents[1]


def _square(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    # real namespaces, and a parity-namespace cell inside Q0
    sq[..., :19] = 0
    sq[0, -1, :29] = 0xFF
    return sq


@lru_cache(maxsize=None)
def _jax_reference(seed: int, k: int, codec: str):
    """JAX single device: (eds, row roots, col roots, data root) of
    ``_square(seed, k)`` with ``codec`` (the caller pins it)."""
    assert jgf256.active_codec() == codec
    eds = np.asarray(jrs.extend_square(_square(seed, k)))
    roots = jnmt.eds_nmt_roots_host(eds)
    data_root = jdah.DataAvailabilityHeader.compute_hash(
        [r.tobytes() for r in roots[0]], [c.tobytes() for c in roots[1]]
    )
    return eds, roots[0], roots[1], data_root


def _jax_shard_layout(eds: np.ndarray, R: int, d: int) -> np.ndarray:
    """Shard d's rows of an EDS in JAX's per-shard layout (k/R, 2, 2k, 512)."""
    k = eds.shape[0] // 2
    rows = k // R
    return np.stack([eds[d * rows : (d + 1) * rows], eds[k + d * rows : k + (d + 1) * rows]],
                    axis=1)


CASES = [(k, R) for k in (4, 8) for R in (1, 2, 4, 8) if R <= k]


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("k,R", CASES)
def test_sharded_matches_jax_and_the_single_device_path(codec_pair, k, R):
    sq = _square(k + R, k)
    eds_j, rr_j, cc_j, root_j = _jax_reference(k + R, k, codec_pair)
    mesh = sharded.make_mesh(["cpu"] * R, row=R)
    eds, rr, cc, root = sharded.extend_and_roots_sharded(sq, mesh)
    np.testing.assert_array_equal(eds, eds_j)
    np.testing.assert_array_equal(rr, rr_j)
    np.testing.assert_array_equal(cc, cc_j)
    assert root.tobytes() == root_j
    # the port's single-device path gives the same bytes
    eds_1, hdr_1 = dah.extend_and_header(sq, device="cpu")
    np.testing.assert_array_equal(eds, eds_1.shares)
    assert hdr_1.hash == root_j
    # shard by shard, in JAX's layout; every shard holds the same roots
    run = sharded._extend_and_roots_sharded_device(sq, mesh, record_stats=False)
    for d in range(R):
        np.testing.assert_array_equal(run.shard_eds(0, d)[0].numpy(),
                                      _jax_shard_layout(eds_j, R, d))
        np.testing.assert_array_equal(run.shard_row_roots[0][d][0].numpy(), rr_j)
        np.testing.assert_array_equal(run.shard_col_roots[0][d][0].numpy(), cc_j)


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("R", [2, 4, 8])
def test_col_parity_partial_matches_the_jax_bit_lift(codec_pair, R):
    """K9a's plain version against JAX's partial, the expression of
    celestia_tpu/parallel/sharded.py:78-87 (not shard_map): the int32 bit
    sums, & 1, packed.  The partials XOR to the EDS's parity rows."""
    k = 8
    rows = k // R
    eds_j = _jax_reference(3, k, codec_pair)[0]
    G = jnp.asarray(jgf256.encode_matrix_bits(k, codec_pair))
    acc = np.zeros((k, 2 * k, 512), dtype=np.uint8)
    for d in range(R):
        top = eds_j[d * rows : (d + 1) * rows]  # (k/R, 2k, 512): Q0 | Q1 rows
        bits_local = jrs.unpack_bits(jnp.asarray(top).transpose(1, 0, 2))
        g_cols = jax.lax.dynamic_slice_in_dim(G, d * (8 * rows), 8 * rows, axis=1)
        partial = jnp.matmul(g_cols, bits_local, preferred_element_type=jnp.int32)
        want = np.asarray(jrs.pack_bits((partial & 1).astype(jnp.int8))).transpose(1, 0, 2)
        (g_port,) = rs.partial_coefficients(k, d * rows, rows, codec_pair, "cpu")
        got = rs.col_parity_partial(torch.from_numpy(top.copy())[None], (g_port,))
        np.testing.assert_array_equal(got[0].numpy(), want)
        acc ^= want
    np.testing.assert_array_equal(acc, eds_j[k:])


@pytest.mark.parametrize("R", [1, 2, 3, 8])
def test_xor_reduce_slabs_plain_matches_numpy(R):
    rng = np.random.default_rng(R)
    staged = rng.integers(0, 256, (R, 2, 16, 512), dtype=np.uint8)
    got = rs.xor_reduce_slabs_plain(torch.from_numpy(staged))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_xor.reduce(staged, axis=0))


def test_collectives_on_repeated_cpu_devices():
    rng = np.random.default_rng(11)
    R = 4
    parts = [rng.integers(0, 256, (2, 3, 5), dtype=np.uint8) for _ in range(R)]
    tparts = [torch.from_numpy(p) for p in parts]
    for got in collectives.all_gather(tparts, axis=1, tiled=True):
        np.testing.assert_array_equal(got.numpy(), np.concatenate(parts, axis=1))
    for got in collectives.all_gather(tparts, axis=1):
        np.testing.assert_array_equal(got.numpy(), np.stack(parts, axis=1))
    np.testing.assert_array_equal(collectives.gather_to(tparts, "cpu", axis=2).numpy(),
                                  np.concatenate(parts, axis=2))
    partials = [rng.integers(0, 256, (3, 4 * R, 16), dtype=np.uint8) for _ in range(R)]
    full = np.bitwise_xor.reduce(np.stack(partials), axis=0)
    got = collectives.reduce_scatter_xor([torch.from_numpy(p) for p in partials], axis=1)
    for d, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), full[:, 4 * d : 4 * (d + 1)])
    with pytest.raises(ValueError, match="does not split"):
        collectives.reduce_scatter_xor([torch.from_numpy(p[:, :-1]) for p in partials], axis=1)
    with pytest.raises(ValueError, match="disagree"):
        collectives.all_gather([tparts[0], tparts[1][:1]])


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_reduce_scatter_stages_nothing_on_one_device(R):
    """On a mesh that repeats one device the reduce-scatter reads every
    peer's slab where it lies: no byte is staged.  Three batches along the
    leading axis make each slab non-contiguous."""
    rng = np.random.default_rng(30 + R)
    partials = [rng.integers(0, 256, (3, 2 * R, 32), dtype=np.uint8) for _ in range(R)]
    full = np.bitwise_xor.reduce(np.stack(partials), axis=0)
    outs = [torch.zeros((3, 2, 32), dtype=torch.uint8) for _ in range(R)]
    collectives.reset_staged_bytes()
    got = collectives.reduce_scatter_xor([torch.from_numpy(p) for p in partials], axis=1,
                                         outs=outs)
    assert collectives.staged_bytes() == 0
    for d, g in enumerate(got):
        assert g is outs[d]
        np.testing.assert_array_equal(g.numpy(), full[:, 2 * d : 2 * (d + 1)])


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
def test_batched_data_axis(codec_pair):
    mesh_mod._reset_for_tests()
    mesh = sharded.make_mesh(["cpu"] * 8, data=2, row=4)
    assert mesh.shape == {"data": 2, "row": 4}
    k = 8
    squares = np.stack([_square(40 + i, k) for i in range(4)])
    eds_b, rr_b, cc_b, dr_b = sharded.extend_and_roots_sharded_batch(squares, mesh)
    headers = sharded.extend_and_headers_sharded_batch(squares, mesh, count_squares=3)
    for i in range(4):
        eds_j, rr_j, cc_j, root_j = _jax_reference(40 + i, k, codec_pair)
        np.testing.assert_array_equal(eds_b[i], eds_j)
        np.testing.assert_array_equal(rr_b[i], rr_j)
        np.testing.assert_array_equal(cc_b[i], cc_j)
        assert dr_b[i].tobytes() == root_j
        eds_i, hdr_i = headers[i]
        np.testing.assert_array_equal(eds_i.shares, eds_j)
        assert hdr_i.hash == root_j
        hdr_i.validate_basic()
    stats = mesh_mod.stats()
    assert (stats["sharded_extends"], stats["batched_dispatches"]) == (4 + 3, 2)
    with pytest.raises(ValueError, match="data groups"):
        sharded.extend_and_roots_sharded_batch(squares[:3], mesh)
    mesh_mod._reset_for_tests()


def test_extend_block_sharded_matches_dah_and_jax():
    from celestia_tpu.da import blob as jblob
    from celestia_tpu.da import square as jsquare
    from celestia_tpu.da.namespace import Namespace as JNamespace
    from celestia_tpu_torch.da import blob, square
    from celestia_tpu_torch.da.namespace import Namespace

    rng = np.random.default_rng(21)
    ours, theirs = [], []
    for _ in range(12):
        inner = rng.bytes(int(rng.integers(250, 401)))
        specs = [(b"\x01" + rng.bytes(9), rng.bytes(int(rng.integers(478, 4000))))
                 for _ in range(int(rng.integers(1, 4)))]
        ours.append(blob.BlobTx(inner, tuple(blob.Blob(Namespace.v0(ns), d)
                                             for ns, d in specs)).marshal())
        theirs.append(jblob.BlobTx(inner, tuple(jblob.Blob(JNamespace.v0(ns), d)
                                                for ns, d in specs)).marshal())
    sq, _, _ = square.build(ours, max_square_size=8)
    jsq, _, _ = jsquare.build(theirs, max_square_size=8)
    assert sq.size == 8
    eds, hdr = sharded.extend_block_sharded(sq, sharded.make_mesh(["cpu"] * 4))
    eds_1, hdr_1 = dah.extend_block(sq, device="cpu")
    eds_j, hdr_j = jdah.extend_block(jsq)
    np.testing.assert_array_equal(eds.shares, eds_1.shares)
    np.testing.assert_array_equal(eds.shares, np.asarray(eds_j.shares))
    assert hdr == hdr_1
    assert (hdr.row_roots, hdr.col_roots, hdr.hash) == (hdr_j.row_roots, hdr_j.col_roots,
                                                        hdr_j.hash)


def test_sharded_entry_points_refuse_what_does_not_split():
    mesh = sharded.make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="divisible"):
        sharded.extend_and_roots_sharded(_square(1, 4), mesh)
    with pytest.raises(ValueError, match="power of two"):
        sharded.extend_and_roots_sharded(np.zeros((12, 12, 512), np.uint8), mesh)


def test_make_mesh():
    mesh = sharded.make_mesh(["cpu"] * 8, data=2)
    assert mesh.shape == {"data": 2, "row": 4}
    assert mesh.first_device == torch.device("cpu")
    assert sharded.make_mesh(["cpu"] * 8) == sharded.make_mesh([torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="device count"):
        sharded.make_mesh(["cpu"] * 8, data=3, row=4)
    with pytest.raises(ValueError, match="device count"):
        sharded.make_mesh(["cpu"] * 8, data=3)


def test_make_mesh_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(["cuda:0"] * 2)


# ---------------------------------------------------------------------------
# the mesh provider
# ---------------------------------------------------------------------------


@pytest.fixture
def provider(monkeypatch):
    monkeypatch.delenv(mesh_mod.ENV_MESH, raising=False)
    mesh_mod._reset_for_tests()
    yield mesh_mod
    mesh_mod._reset_for_tests()


@pytest.mark.parametrize("spec,want", [
    ("2x4", (2, 4)), (" 1X8 ", (1, 8)), ("auto", None), ("", None), ("on", None),
    ("off", (0, 0)), ("none", (0, 0)), ("single", (0, 0)),
])
def test_parse_spec(spec, want):
    assert mesh_mod.parse_spec(spec) == want


@pytest.mark.parametrize("spec", ["2x", "x4", "2x4x1", "0x4", "2x0", "two", "-1x2"])
def test_malformed_spec_raises(provider, monkeypatch, spec):
    with pytest.raises(ValueError):
        provider.parse_spec(spec)
    with pytest.raises(ValueError):
        provider.configure(spec)
    monkeypatch.setenv(provider.ENV_MESH, spec)
    provider.configure(None)
    with pytest.raises(ValueError):
        provider.device_mesh()


def test_mesh_for_square_routing_and_counter(provider):
    provider.configure("1x4", devices=["cpu"] * 8)
    mesh = provider.device_mesh()
    assert mesh.shape == {"data": 1, "row": 4}
    assert provider.mesh_shape() == (1, 4)
    assert provider.mesh_for_square(8) is mesh
    assert provider.mesh_for_square(4) is mesh
    assert provider.mesh_for_square(2) is None  # k < R
    assert provider.mesh_for_square(1) is None
    assert provider.mesh_for_batch(8, 0) is None
    assert provider.mesh_for_batch(2, 3) is None  # a group probe, not counted
    assert provider.stats()["fallback_squares"] == 2
    sharded.extend_and_header_sharded(_square(5, 4), mesh)
    st = provider.stats()
    assert (st["active"], st["data"], st["row"], st["sharded_extends"]) == (True, 1, 4, 1)
    provider.configure("2x2", devices=["cpu"] * 4)
    assert provider.mesh_shape() == (2, 2)
    provider.configure("off", devices=["cpu"] * 8)
    assert provider.device_mesh() is None and provider.mesh_for_square(8) is None


def test_env_spec(provider, monkeypatch):
    monkeypatch.setenv(provider.ENV_MESH, "2x4")
    provider.configure(None, devices=["cpu"] * 8)
    assert provider.mesh_shape() == (2, 4)
    assert provider.stats()["env"] == "2x4"


def test_too_few_devices_raises(provider):
    provider.configure("2x4", devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 8 devices, 4 given"):
        provider.device_mesh()
    assert not provider.stats()["resolved"]


def test_auto_without_cards_is_off(provider):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two or more cards are present")
    for spec in ("auto", None):
        provider.configure(spec, devices=["cpu"] * 8)
        assert provider.device_mesh() is None
        assert provider.mesh_for_square(8) is None
        assert provider.stats()["resolved"] and not provider.stats()["active"]
    if not torch.cuda.is_available():
        provider.configure("1x2")  # an explicit spec over the (no) visible cards
        with pytest.raises(ValueError, match="needs 2 devices, 0 given"):
            provider.device_mesh()


# ---------------------------------------------------------------------------
# against JAX's shard_map itself, in a child interpreter
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import celestia_tpu.ops.sha256 as jsha
from celestia_tpu.ops import gf256
from celestia_tpu.parallel import sharded

# SHA-256's scans unrolled once, not 8 times: the same results, and a third
# of XLA's compile time for the shard_map program (~16 s, not ~45 s)
jsha._SCAN_UNROLL = 1

root, codec = sys.argv[1], sys.argv[2]
gf256.set_active_codec(codec, force=True)
for R in map(int, sys.argv[3:]):  # one R after another, each marked done
    out = os.path.join(root, f"R{R}")
    sq = np.load(os.path.join(out, "square.npy"))
    k = sq.shape[0]
    mesh = sharded.make_mesh(jax.devices()[:R], data=1, row=R)
    x = jax.device_put(sq, NamedSharding(mesh, P("row", None, None)))
    fn = sharded._sharded_fn(mesh, k, False, codec).lower(x).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for name, a in zip(("eds_local", "row_roots", "col_roots", "data_root"), fn(x)):
        np.save(os.path.join(out, name + ".npy"), np.asarray(a))
    open(os.path.join(out, "done"), "w").close()
"""


_CHILD_RS = (2, 4, 8)
_CHILD_K, _CHILD_CODEC = 8, gf256.CODEC_LEOPARD


# xdist schedules under which one process runs every selected test of a
# module ("no": no workers)
_WHOLE_MODULE_SCHEDULES = ("no", "loadfile", "loadscope", "each")


def _schedule(config) -> str:
    """xdist's schedule of this run, "no" without workers.  A worker resets
    its own ``dist`` option to "no", so it reads its controller's
    arguments; ``-n`` alone is "load"."""
    if not hasattr(config, "workerinput"):
        return getattr(config.option, "dist", "no")
    args = list(config.invocation_params.args)
    for i, a in enumerate(args):
        if a == "--dist" and i + 1 < len(args):
            return args[i + 1]
        if a.startswith("--dist="):
            return a.split("=", 1)[1]
    return "load"


class _ShardMapChildren:
    """Child interpreters that compile and run JAX's ``shard_map`` program
    at k = 8, one R after another each (one ``jax`` import a child), R's
    arrays in ``root/R<R>`` followed by a ``done`` file."""

    def __init__(self, root: Path):
        self.root = root
        self.procs = []  # (process, stderr file)
        self.proc_of = {}  # R -> index into procs

    def start(self, rs) -> None:
        rs = [R for R in rs if R not in self.proc_of]
        if not rs:
            return
        for R in rs:
            (self.root / f"R{R}").mkdir()
            np.save(self.root / f"R{R}" / "square.npy", _square(60 + R, _CHILD_K))
            self.proc_of[R] = len(self.procs)
        env = dict(os.environ, PYTHONPATH=str(ROOT), TF_CPP_MIN_LOG_LEVEL="3")
        stderr = self.root / f"stderr{len(self.procs)}.txt"
        with open(stderr, "wb") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(self.root), _CHILD_CODEC, *map(str, rs)],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        self.procs.append((proc, stderr))

    def result(self, R) -> Path:
        """R's directory once its arrays are written (starting a child for R
        alone if none has it)."""
        self.start([R])
        proc, stderr = self.procs[self.proc_of[R]]
        out = self.root / f"R{R}"
        deadline = time.monotonic() + 600
        while not (out / "done").exists():
            assert proc.poll() is None or (out / "done").exists(), stderr.read_text()[-3000:]
            assert time.monotonic() < deadline, f"the shard_map child gave no result for R={R}"
            time.sleep(0.1)
        return out

    def close(self) -> None:
        for proc, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def shard_map_children(tmp_path_factory):
    children = _ShardMapChildren(tmp_path_factory.mktemp("shard_map"))
    try:
        yield children
    finally:
        children.close()


@pytest.fixture(scope="module", autouse=True)
def _shard_map_children_early(request):
    """Start one child for every R when this module's first test runs, so
    that its three compiles (most of its ~75 s) overlap the module's other
    tests and each child test waits only for its own R -- but only where
    this process runs every selected test of the module (serially, or under
    xdist's loadfile, loadscope or each) and a child test is selected.
    Under other schedules each child test starts a child for its own R
    (~30 s), so no worker compiles an R it does not test."""
    selected = any(item.module is request.module
                   and item.originalname == "test_matches_jax_shard_map_in_a_child"
                   for item in request.session.items)
    if selected and _schedule(request.config) in _WHOLE_MODULE_SCHEDULES:
        request.getfixturevalue("shard_map_children").start(_CHILD_RS)


@pytest.mark.parametrize("R", _CHILD_RS)
def test_matches_jax_shard_map_in_a_child(shard_map_children, R):
    """JAX's ``shard_map`` program at k = 8 in a fresh interpreter (the
    late-compile jaxlib crash of tests/test_sharded.py), its per-shard EDS
    rows and replicated roots held against the port's."""
    k, codec = _CHILD_K, _CHILD_CODEC
    tmp_path = shard_map_children.result(R)
    sq = np.load(tmp_path / "square.npy")
    with pinned_codec(codec):
        run = sharded._extend_and_roots_sharded_device(
            sq, sharded.make_mesh(["cpu"] * R), record_stats=False
        )
    eds_local = np.load(tmp_path / "eds_local.npy")  # (k, 2, 2k, 512): shards in order
    rows = k // R
    for d in range(R):
        np.testing.assert_array_equal(run.shard_eds(0, d)[0].numpy(),
                                      eds_local[d * rows : (d + 1) * rows])
    np.testing.assert_array_equal(run.row_roots[0].numpy(), np.load(tmp_path / "row_roots.npy"))
    np.testing.assert_array_equal(run.col_roots[0].numpy(), np.load(tmp_path / "col_roots.npy"))
    np.testing.assert_array_equal(run.data_roots[0].numpy(), np.load(tmp_path / "data_root.npy"))
