"""Fixtures shared by the tests/test_torch_*.py files (import them by name
into a test module; pytest picks fixtures up from the module namespace),
and the CPU twin of the CUDA kernels with its launch router."""

import ctypes
import shutil
import subprocess
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import sha256 as jsha
from celestia_tpu_torch.ops import gf256


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


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The twin library, built by g++ once a module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CPU twin")
    lib = tmp_path_factory.mktemp("twin") / "libtwin.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         str(CSRC / "cpu_twin.cpp"), "-o", str(lib)],
        check=True, capture_output=True,
    )
    t = ctypes.CDLL(str(lib))
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
    return t


# C entry -> its twin where the names differ (same arguments, no stream)
_TWIN_OF = {"ctt_nmt_leaf_digests": "twin_nmt_leaf_digests_window",
            "ctt_rfc6962_root": "twin_rfc6962_levels"}
# twins that return the C entry's verdict on its arguments (0: launched)
_CHECKED_TWINS = ("twin_nmt_leaf_digests_window", "twin_nmt_leaf_digests_rows",
                  "twin_nmt_reduce_levels", "twin_rfc6962_levels", "twin_rs_decode_matrices",
                  "twin_das_proof_gather", "twin_das_cell_gather", "twin_xor_reduce_scatter")


def route_launches_to_twin(monkeypatch, twin) -> dict:
    """Run the wrappers' CUDA branches on CPU tensors: ops/nmt.py and
    ops/gather.py take them as the card's, and every ``kernels.launch``
    goes to the g++ twin of its C entry (raising where the entry would
    refuse).  Returns the launch counts, kept as ``kernels.launch`` keeps
    them."""
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.ops import gather, nmt

    launched = {}

    def launch(kernel, device, *args, launches=1, entry=None):
        c_entry = entry or kernels.KERNELS[kernel]
        name = _TWIN_OF.get(c_entry, c_entry.replace("ctt_", "twin_"))
        fn = getattr(twin, name)
        fn.argtypes = list(kernels._SIGNATURES[c_entry][:-1])  # no stream
        rc = fn(*args)
        if name in _CHECKED_TWINS and rc != 0:
            raise RuntimeError(f"{c_entry} refused its arguments")
        launched[kernel] = launched.get(kernel, 0) + launches

    def check_tensor(t, name, shape=None):
        assert t.dtype == torch.uint8 and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "check_cuda_tensor", check_tensor)
    monkeypatch.setattr(nmt, "_is_cpu", lambda t: False)
    monkeypatch.setattr(gather, "_is_cpu", lambda t: False)
    return launched
