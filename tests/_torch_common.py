"""Fixtures shared by the tests/test_torch_*.py files (import them by name
into a test module; pytest picks fixtures up from the module namespace),
and the CPU twin of the CUDA kernels with its launch router."""

import ctypes
import os
import shutil
import socket
import subprocess
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import sha256 as jsha
from celestia_tpu_torch.ops import gf256


def build_jax_native_once() -> None:
    """Build the JAX package's native library (native/celestia_native.so)
    once per checkout, under a file lock, into a temporary name that is
    then renamed into place.

    The JAX loader (celestia_tpu/utils/native.py ``_load``) builds the
    library in place at first use when it is missing; in a fresh checkout
    the parallel workers of one run each find it missing, and a worker that
    loads the half-written file of another finds no native library for the
    rest of its life, so its host-regime comparisons take JAX's numpy legs.
    Every worker imports this module while it collects, before any test
    runs, so the library is whole before the first load."""
    import fcntl

    from celestia_tpu.utils import native as jax_native

    src, so = jax_native._SRC, jax_native._SO
    if jax_native._SO_OVERRIDE or not src.exists():
        return  # an override owns its build; no source, nothing to build
    lock_dir = Path(__file__).resolve().parents[1] / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / ".jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
            return
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        # the JAX package's own build, pointed at the temporary name
        jax_native._SO = tmp
        try:
            if jax_native._build():
                os.replace(tmp, so)
            # else the loader finds no library and says so, as it would
        finally:
            jax_native._SO = so
            if tmp.exists():
                tmp.unlink()


build_jax_native_once()


def jax_block_and_proofs(seed_key, blob_seed: int, namespace_id: bytes, coords):
    """The JAX package's node with one funded key (``seed_key``) that
    commits one 4,000-byte blob (bytes from ``blob_seed``) in namespace
    ``namespace_id``: the block's data root and the batch proofs of
    ``coords``, as dicts."""
    from celestia_tpu.client.signer import Signer
    from celestia_tpu.da import das
    from celestia_tpu.da.blob import Blob
    from celestia_tpu.da.namespace import Namespace
    from celestia_tpu.node.testnode import TestNode
    from celestia_tpu.utils.secp256k1 import PrivateKey

    key = PrivateKey.from_seed(seed_key)
    node = TestNode(funded_accounts=[(key, 10**12)])
    data = bytes(np.random.default_rng(blob_seed).integers(0, 256, 4000, dtype=np.uint8))
    res = Signer(node, key).submit_pay_for_blob([Blob(Namespace.v0(namespace_id), data)])
    assert res.code == 0, res.log
    art = node._block_artifacts(res.height)
    proofs = das.sample_proofs_batch(art["eds"], art["dah"], coords)
    return node.block(res.height).header.data_hash, [p.to_dict() for p in proofs]


@contextmanager
def pinned_codec(codec: str):
    """Pin both packages to one codec; restore both afterwards."""
    saved = (jgf256.active_codec(), gf256.active_codec())
    jgf256.set_active_codec(codec, force=True)
    gf256.set_active_codec(codec, force=True)
    try:
        yield codec
    finally:
        jgf256.set_active_codec(saved[0], force=True)
        gf256.set_active_codec(saved[1], force=True)


@contextmanager
def sha_scan_unrolled_once():
    """Trace the JAX package's SHA-256 with its round scans unrolled once
    (``_SCAN_UNROLL = 1``, not 8): the same integer results, and a several
    times shorter XLA compile for a test's reference program."""
    saved, jsha._SCAN_UNROLL = jsha._SCAN_UNROLL, 1
    try:
        yield
    finally:
        jsha._SCAN_UNROLL = saved


@pytest.fixture
def codec_pair(request):
    """Pin both packages to one codec; restore both afterwards."""
    with pinned_codec(request.param) as codec:
        yield codec


@pytest.fixture(scope="module")
def jitted_jax_level_stack():
    """JAX ``nmt_level_stack`` under ``jax.jit``, traced with SHA-256's scans
    unrolled once and compiled once per shape at LLVM optimisation level 0,
    for the JAX package's share, tx and namespace proofs, which call it
    eagerly (9-19 s a call on a CPU; the integer results are the same, only
    the compile is shorter).  Restored afterwards."""
    import jax

    from celestia_tpu.ops import nmt as jnmt

    eager = jnmt.nmt_level_stack
    compiled = {}

    def run(leaves):
        key = tuple(leaves.shape)
        if key not in compiled:
            with sha_scan_unrolled_once():
                lowered = jax.jit(eager).lower(leaves)
            compiled[key] = lowered.compile(
                compiler_options={"xla_backend_optimization_level": 0}
            )
        return compiled[key](leaves)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnmt, "nmt_level_stack", run)
        yield


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One intra-op thread for torch: the suite runs several test workers
    at once, and torch's default of one thread per core in each of them
    oversubscribes the host and slows every other test."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# the g++ CPU twin of the CUDA kernels (celestia_tpu_torch/csrc/cpu_twin.cpp)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "celestia_tpu_torch" / "csrc"
_P = ctypes.c_void_p


TWIN_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas")


def build_twin(gxx: str) -> Path:
    """The twin library, built by g++ once per checkout and source digest
    (cpu_twin.cpp, the headers, the flags) under a file lock, into a
    temporary name that is then renamed into place: the parallel workers
    of one run, and each of their modules, load the one build."""
    import fcntl
    import hashlib

    h = hashlib.sha256(" ".join(TWIN_FLAGS).encode())
    for src in [CSRC / "cpu_twin.cpp", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = Path(__file__).resolve().parents[1] / "build" / "torch_twin"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libtwin-{h.hexdigest()[:16]}.so"
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
            try:
                subprocess.run([gxx, *TWIN_FLAGS, str(CSRC / "cpu_twin.cpp"), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
    return lib


@pytest.fixture(scope="module")
def twin():
    """The twin library (:func:`build_twin`), loaded once a module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CPU twin")
    t = ctypes.CDLL(str(build_twin(gxx)))
    LL, I = ctypes.c_longlong, ctypes.c_int
    t.twin_sha256_batch.argtypes = [_P, _P, LL, I, I]
    t.twin_nmt_leaf_digests.argtypes = [_P, _P, I]
    t.twin_nmt_combine_level.argtypes = [_P, _P, LL, I, LL, LL, LL, LL, LL]
    t.twin_rfc6962_root.argtypes = [_P, _P, I, I, I, I]
    t.twin_rfc6962_levels.argtypes = [_P, _P, I, I, I, I]
    t.twin_rs_extend.argtypes = [_P, _P, _P, _P, _P, I]
    t.twin_das_proof_gather.argtypes = [_P, I, _P, I, _P]
    t.twin_das_cell_gather.argtypes = [_P, I, I, I, I, I, I, _P, I, _P]
    t.twin_das_cell_siblings.argtypes = [I, I, _P]
    t.twin_nmt_leaf_digests_batched.argtypes = [_P, _P, I, I]
    t.twin_nmt_combine_level_batched.argtypes = [_P, _P, LL, I, LL, LL, LL, LL, LL, LL, LL]
    t.twin_nmt_reduce_levels.argtypes = [_P, _P, LL, I, I, LL, LL, LL, LL, LL, LL, LL]
    t.twin_rs_extend_batched.argtypes = [_P, _P, _P, _P, _P, I, I]
    t.twin_rs_decode_matrices.argtypes = [_P, _P, _P, _P, I, I, I]
    t.twin_rs_decode_matrices_grouped.argtypes = [_P, _P, _P, _P, I, I, I, I]
    t.twin_rs_decode_axes.argtypes = [_P, _P, _P, _P, _P, _P, I, I, I]
    t.twin_rs_decode_axes_grouped.argtypes = [_P, _P, _P, _P, _P, _P, I, I, I, I]
    t.twin_rs_repair_verdicts.argtypes = [_P, _P, _P, _P, _P, _P, I]
    t.twin_nmt_leaf_digests_window.argtypes = [_P, _P, I, I, I, I]
    t.twin_nmt_leaf_digests_rows.argtypes = [_P, _P, I, I, _P, I]
    t.twin_rs_extend_rows.argtypes = [_P, _P, _P, _P, _P, I, I]
    t.twin_rs_col_parity_partial.argtypes = [_P, _P, _P, _P, _P, I, I, I]
    t.twin_xor_reduce_scatter.argtypes = [_P, I, _P, _P, I, LL, I, LL]
    t.twin_rs_leopard_tables.argtypes = [_P, _P, I, _P, LL]
    t.twin_rs_leopard_extend.argtypes = [_P, _P, _P, I]
    t.twin_rs_leopard_extend_batched.argtypes = [_P, _P, _P, I, I]
    t.twin_rs_leopard_extend_rows.argtypes = [_P, _P, _P, I, I]
    t.twin_rs_leopard_decode_tables.argtypes = [_P, _P, I, _P, LL]
    t.twin_rs_leopard_decode_axes.argtypes = [_P, _P, _P, _P, _P, _P, I, I, I]
    t.twin_rs_leopard_partial_tables.argtypes = [_P, _P, I, I, I, _P, LL]
    t.twin_rs_leopard_col_parity_partial.argtypes = [_P, _P, _P, I, I, I, I]
    return t


# C entry -> its twin where the names differ (same arguments, no stream)
_TWIN_OF = {"ctt_nmt_leaf_digests": "twin_nmt_leaf_digests_window",
            "ctt_rfc6962_root": "twin_rfc6962_levels"}
# twins that return the C entry's verdict on its arguments (0: launched)
_CHECKED_TWINS = ("twin_nmt_leaf_digests_window", "twin_nmt_leaf_digests_rows",
                  "twin_nmt_reduce_levels", "twin_rfc6962_levels", "twin_rs_decode_matrices",
                  "twin_das_proof_gather", "twin_das_cell_gather", "twin_xor_reduce_scatter",
                  "twin_rs_leopard_decode_axes", "twin_rs_leopard_col_parity_partial")


class _Launched(dict):
    """Launch counts by kernel name; ``entries``: by C entry."""

    def __init__(self):
        super().__init__()
        self.entries = {}


def route_launches_to_twin(monkeypatch, twin) -> dict:
    """Run the wrappers' CUDA branches on CPU tensors: ops/nmt.py and
    ops/gather.py take them as the card's, and every ``kernels.launch``
    (and ``kernels.host_call``) goes to the g++ twin of its C entry
    (raising where the entry would refuse).  Returns the launch counts,
    kept as ``kernels.launch`` keeps them, and by C entry in their
    ``entries`` attribute."""
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.ops import gather, nmt

    launched = _Launched()

    def launch(kernel, device, *args, launches=1, entry=None):
        c_entry = entry or kernels.KERNELS[kernel]
        name = _TWIN_OF.get(c_entry, c_entry.replace("ctt_", "twin_"))
        fn = getattr(twin, name)
        fn.argtypes = list(kernels._SIGNATURES[c_entry][:-1])  # no stream
        rc = fn(*args)
        if name in _CHECKED_TWINS and rc != 0:
            raise RuntimeError(f"{c_entry} refused its arguments")
        launched[kernel] = launched.get(kernel, 0) + launches
        launched.entries[c_entry] = launched.entries.get(c_entry, 0) + launches

    def host_call(entry, *args):
        fn = getattr(twin, entry.replace("ctt_", "twin_"))
        fn.argtypes = list(kernels._SIGNATURES[entry])
        if fn(*args) != 0:
            raise RuntimeError(f"{entry} refused its arguments")

    def check_tensor(t, name, shape=None):
        assert t.dtype == torch.uint8 and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "host_call", host_call)
    monkeypatch.setattr(kernels, "check_cuda_tensor", check_tensor)
    monkeypatch.setattr(nmt, "_is_cpu", lambda t: False)
    monkeypatch.setattr(gather, "_is_cpu", lambda t: False)
    return launched


class ReservedAddrs:
    """``n`` loopback addresses held until the node processes bind them.

    A port picked by binding port 0 and closing the socket is free for
    anyone until the node that is told it binds it, which for a ``cli
    start`` child is seconds later (an ``init``, the child's imports).  In a
    parallel run another test's server or client can take it meanwhile,
    and a gRPC server binds with ``SO_REUSEPORT``, so the child then shares
    the port with a stranger without an error and the stranger answers
    part of the calls.  Each port here stays bound by a placeholder with
    ``SO_REUSEPORT`` (the kernel hands it to no ``bind(0)`` or ``connect``)
    and never listens; the gRPC server of the child joins it, and
    :meth:`release` closes the placeholders once the children have bound."""

    def __init__(self, n: int):
        self._socks = []
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind(("127.0.0.1", 0))
            self._socks.append(s)
        self.addrs = ["127.0.0.1:%d" % s.getsockname()[1] for s in self._socks]

    def release(self) -> None:
        for s in self._socks:
            s.close()
        self._socks = []


def node_env(n_nodes: int, **extra) -> dict:
    """The environment of one of ``n_nodes`` CPU node processes on this
    host: the CPU device, and a share of the cores as the node's host
    thread budget (the native pool and torch's intra-op threads), as a
    deployment of ``n_nodes`` validators on one machine would set it."""
    from celestia_tpu_torch import tools

    return {**os.environ, "CELESTIA_TPU_TORCH_DEVICE": "cpu",
            **tools.thread_share(n_nodes), **extra}


@pytest.fixture(autouse=False)
def fresh_port_faults():
    """The port's fault stats (degradations, notes) empty before and after
    a test: a twin that trips an alert on purpose (profile-smoke's
    deliberate degradation) leaves it in the process, and the next twin
    in that worker would see its stock ``degradations`` rule fire."""
    from celestia_tpu_torch.utils import faults

    faults.reset_stats()
    yield
    faults.reset_stats()
