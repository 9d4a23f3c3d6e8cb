"""The collectives of the sharded extension, over one controller's shards.

Counterpart of the ``jax.lax`` collectives that K9 uses
(``celestia_tpu/parallel/sharded.py``: ``all_gather`` :121-122 and
:144-145, ``psum_scatter`` :89, the device-side concatenate :253-255).  One
process drives every shard, as ``shard_map`` does: a function takes the
per-shard tensors (one per shard, each on its shard's device, in shard
order) and returns the per-shard results.  A collective is a set of
``Tensor.copy_`` calls between the shards' devices:

* between two cards a copy runs peer to peer on the source card's current
  stream, behind a two-way event barrier with the destination's current
  stream (PyTorch's cross-device ``copy_``), so it is ordered after the
  kernels that wrote the source and before those that read the result,
  with no host round trip;
* shards that share a device (a mesh with repeated devices, how one card
  runs an R-shard mesh) share its current stream, so their copies and
  launches run in the order they were enqueued;
* the reduce-scatter copies nothing between shards of one device: its
  kernel reads their partials in place.

Shards on one device get one result, shared between them: the values every
shard would hold are the same, so they are gathered once per device.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import torch

from celestia_tpu_torch.ops import rs

_lock = threading.Lock()
_staged = [0]  # bytes reduce_scatter_xor copied between devices


def _check_parts(parts: Sequence[torch.Tensor]) -> None:
    if not parts:
        raise ValueError("a collective needs at least one shard")
    shape, dtype = tuple(parts[0].shape), parts[0].dtype
    for p in parts:
        if tuple(p.shape) != shape or p.dtype != dtype:
            raise ValueError(
                f"shards disagree: {tuple(p.shape)} {p.dtype} against {shape} {dtype}"
            )


def gather_to(parts: Sequence[torch.Tensor], device, axis: int = 0,
              out: torch.Tensor = None) -> torch.Tensor:
    """The shards' parts concatenated along ``axis`` on ``device`` (into
    ``out`` when given): the counterpart of the device-side concatenate that
    reassembles the sharded EDS (sharded.py:253-255)."""
    _check_parts(parts)
    device = torch.device(device)
    R = len(parts)
    shape = list(parts[0].shape)
    m = shape[axis]
    shape[axis] = R * m
    if out is None:
        out = torch.empty(shape, dtype=parts[0].dtype, device=device)
    elif list(out.shape) != shape or out.device != device:
        raise ValueError(f"out must be {tuple(shape)} on {device}, got {tuple(out.shape)} "
                         f"on {out.device}")
    for d, part in enumerate(parts):
        out.narrow(axis, d * m, m).copy_(part, non_blocking=True)
    return out


def all_gather(parts: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = False) -> List[torch.Tensor]:
    """``jax.lax.all_gather`` over the shards: every shard gets all parts on
    its own device, stacked along a new ``axis`` (``tiled=False``) or
    concatenated along ``axis`` (``tiled=True``)."""
    _check_parts(parts)
    src = list(parts) if tiled else [p.unsqueeze(axis) for p in parts]
    by_device = {}
    for p in parts:
        if p.device not in by_device:
            by_device[p.device] = gather_to(src, p.device, axis)
    return [by_device[p.device] for p in parts]


def staged_bytes() -> int:
    """Bytes :func:`reduce_scatter_xor` has copied between devices since the
    last :func:`reset_staged_bytes` (0 on a mesh of one device)."""
    with _lock:
        return _staged[0]


def reset_staged_bytes() -> None:
    with _lock:
        _staged[0] = 0


def reduce_scatter_xor(partials: Sequence[torch.Tensor], axis: int = 0,
                       outs: Sequence[torch.Tensor] = None) -> List[torch.Tensor]:
    """``psum_scatter(...) & 1`` of packed bit planes: shard d gets slab d
    (along ``axis``) of the XOR of every shard's partial, into ``outs[d]``
    when given.

    One K9b launch per device (``rs.xor_reduce_scatter``) serves every
    destination shard on it, reading each peer's partial in place when the
    peer lies on that device.  A peer on another device first has its slabs
    for this device's shards copied over (peer to peer, into a buffer laid
    out as the partial; counted by :func:`staged_bytes`): the transport
    between cards.  On a mesh that repeats one device nothing is copied.
    The packed partials move 1/8 of the bytes of JAX's 0/1 bit planes and
    1/32 of an int32 sum of them."""
    _check_parts(partials)
    R = len(partials)
    size = partials[0].shape[axis]
    if size % R:
        raise ValueError(f"axis {axis} of length {size} does not split over {R} shards")
    m = size // R
    slab_shape = list(partials[0].shape)
    slab_shape[axis] = m
    results: List[torch.Tensor] = [None] * R
    by_device = {}
    for d, mine in enumerate(partials):
        by_device.setdefault(mine.device, []).append(d)
    for device, dests in by_device.items():
        peers = []
        for peer in partials:
            if peer.device != device:
                staged = torch.empty(peer.shape, dtype=peer.dtype, device=device)
                for d in dests:
                    staged.narrow(axis, d * m, m).copy_(peer.narrow(axis, d * m, m),
                                                        non_blocking=True)
                with _lock:
                    _staged[0] += len(dests) * peer.numel() // R * peer.element_size()
                peer = staged
            peers.append(peer)
        for d in dests:
            results[d] = (torch.empty(slab_shape, dtype=partials[d].dtype, device=device)
                          if outs is None else outs[d])
        rs.xor_reduce_scatter(peers, dests, [results[d] for d in dests], axis)
    return results
