"""Fixtures shared by the tests/test_torch_*.py files (import them by name
into a test module; pytest picks fixtures up from the module namespace)."""

import pytest
import torch

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu_torch.ops import gf256


@pytest.fixture
def codec_pair(request):
    """Pin both packages to one codec; restore both afterwards."""
    codec = request.param
    saved = (jgf256.active_codec(), gf256.active_codec())
    jgf256.set_active_codec(codec, force=True)
    gf256.set_active_codec(codec, force=True)
    yield codec
    jgf256.set_active_codec(saved[0], force=True)
    gf256.set_active_codec(saved[1], force=True)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One intra-op thread for torch: the suite runs several test workers
    at once, and torch's default of one thread per core in each of them
    oversubscribes the host and slows every other test."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
