"""Fixtures shared by the tests/test_torch_*.py files (import them by name
into a test module; pytest picks fixtures up from the module namespace)."""

from contextlib import contextmanager

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
