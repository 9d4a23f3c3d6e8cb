"""K7b ``das_proof_gather``: proof paths copied out of device-resident tensors.

Counterpart of the eager gathers of ``celestia_tpu/da/device_plane.py``
``sample_proofs_batch`` (:318-334), which index every NMT level, every
root-tree level and the EDS separately and fetch the results as a tuple.
Here the host works out every item a batch of proofs needs as one int32
table of ``(source, row, idx, offset)``; :func:`das_proof_gather` uploads
it once and, on a CUDA tensor, one launch of ``csrc/das_gather.cu`` copies
each item's bytes into one packed uint8 output, which the caller fetches
with one copy.  On CPU tensors the plain twin does the same copy with torch
indexing.

A source is a contiguous uint8 tensor of fixed-width items laid out in
rows: item ``(row, idx)`` is the ``width`` bytes at byte ``offset + row *
row_stride + idx * item_stride`` of the tensor.  Every item is checked
against its source's size and the output's on the host before anything is
launched, so a malformed table raises instead of reading out of bounds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from celestia_tpu_torch import kernels

MAX_SOURCES = 32  # ctt::kMaxGatherSrcs


class GatherSource(NamedTuple):
    tensor: torch.Tensor
    offset: int  # bytes to item (0, 0)
    row_stride: int  # bytes
    item_stride: int  # bytes
    width: int  # bytes copied per item


def check_items(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.device:
    """Raise unless every item lies inside its source and the output; return
    the sources' (common) device."""
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"between 1 and {MAX_SOURCES} sources, got {len(sources)}")
    if items.dtype != np.int32 or items.ndim != 2 or items.shape[1] != 4:
        raise ValueError(f"items must be int32[n, 4], got {items.dtype}{list(items.shape)}")
    device = sources[0].tensor.device
    for i, s in enumerate(sources):
        t = s.tensor
        if t.device != device:
            raise ValueError(f"source {i} lies on {t.device}, source 0 on {device}")
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"source {i} must be a contiguous uint8 tensor")
    if not len(items):
        return device
    src, row, idx, off = (items[:, j].astype(np.int64) for j in range(4))
    if src.min() < 0 or src.max() >= len(sources):
        raise ValueError("item names a source that does not exist")
    if row.min() < 0 or idx.min() < 0 or off.min() < 0:
        raise ValueError("negative row, index or offset in the gather table")
    meta = np.array(
        [(s.offset, s.row_stride, s.item_stride, s.width, s.tensor.numel()) for s in sources],
        dtype=np.int64,
    )
    m = meta[src]
    if np.any(m[:, 0] + row * m[:, 1] + idx * m[:, 2] + m[:, 3] > m[:, 4]):
        raise ValueError("gather item past the end of its source")
    if np.any(off + m[:, 3] > out_bytes):
        raise ValueError("gather item past the end of the output")
    return device


def das_proof_gather_plain(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.Tensor:
    """Plain twin of K7b on any device: the same copy by torch indexing."""
    device = check_items(sources, items, out_bytes)
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=device)
    table = torch.from_numpy(np.ascontiguousarray(items, dtype=np.int32)).to(device).long()
    for i, s in enumerate(sources):
        it = table[table[:, 0] == i]
        if not len(it):
            continue
        span = torch.arange(s.width, device=device)
        start = s.offset + it[:, 1] * s.row_stride + it[:, 2] * s.item_stride
        out[it[:, 3, None] + span] = s.tensor.reshape(-1)[start[:, None] + span]
    return out


def launch_gather(
    sources: Sequence[GatherSource], items_dev: torch.Tensor, out: torch.Tensor
) -> None:
    """Launch K7b on an index table already on the card (checked by the
    caller, as :func:`das_proof_gather` does)."""
    table = np.array(
        [(s.tensor.data_ptr() + s.offset, s.row_stride, s.item_stride, s.width) for s in sources],
        dtype=np.int64,
    )
    kernels.launch(
        "das_proof_gather", out.device, table.ctypes.data_as(ctypes.c_void_p), len(sources),
        items_dev.data_ptr(), items_dev.shape[0], out.data_ptr(),
    )


def das_proof_gather(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.Tensor:
    """Copy every item of ``items`` (int32[n, 4]: source, row, idx, output
    offset) into one packed uint8[out_bytes] tensor on the sources' device.

    On the card: one upload of the table, one launch of K7b; the caller
    fetches the result with one copy.  On the CPU: the plain twin."""
    device = check_items(sources, items, out_bytes)
    if device.type == "cpu":
        return das_proof_gather_plain(sources, items, out_bytes)
    for i, s in enumerate(sources):
        kernels.check_cuda_tensor(s.tensor, f"source {i}")
    out = torch.empty(out_bytes, dtype=torch.uint8, device=device)
    if len(items):
        items_dev = torch.from_numpy(np.ascontiguousarray(items)).to(device)
        launch_gather(sources, items_dev, out)
    return out
