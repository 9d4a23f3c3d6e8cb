#!/usr/bin/env python3
"""Drive the celestia_tpu_torch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results/chip_smoke.json] [--phases 1,4h]

Phases (any failure raises and the script exits non-zero).  ``--phases``
runs a subset (1 and 5 always run; 3 to 4f share the seeded blocks and run
together; without 2 the kernels line carries only the launches); the
default runs every phase and every check:

1. device: the card's name and power limit, and the nvcc build of
   ``celestia_tpu_torch/csrc/*.cu``;
2. every CUDA kernel against its plain PyTorch twin on the card, at the
   main path's shapes, byte for byte (K4 from the leaves at n = 4k for k =
   1..128, at batch 8 and over given hashes; K8a at k = 1..128 for both
   codecs and the 25 % mask's 256 axes; K7b ``das_proof_gather`` in its
   cell mode and its table mode on 1,024 cells at every k = 1..128 (the
   corners, each cell's tree its own row and another row), K9a and K9b
   (in place, one launch) on every shard of a k = 128 square over 8
   shards, K2 on their row windows, K9b in place at k = 64, 128 x R = 1,
   2, 4, 8 over batches of 2); K2 and every level of K3 (one launch) at
   every k = 1..128 and on the 8-EDS catch-up batch; K2's row-set mode and
   K3 at every k on a scattered set of rows read in place and gathered
   from the transposed view; the row level stacks at R = 1, 5 and 256 rows
   of a k = 128 EDS against the K1 path they replace, timed beside it step
   by step (gather, prefix build, K1, digest cat, K3) with their
   dependency floor; K3's column subtrees and finishing levels of K9 at
   k/R = 8/8, 32/4, 128/8; K5 (its kernel by codec: Leopard's FFT under
   leopard-ff8, the tensor-core bit-GEMM under lagrange-gf256) at every k =
   1..128 and K5's row pass and K9a (n_in = k/R down to 1) for both
   codecs; under leopard-ff8 the FFT kernel of K5, K5b (3 squares) and
   the row pass (k + 3 rows) at every k = 1..128 against the plain path and
   against the bit-GEMM kernel given leopard's encode matrix; K9a's
   Leopard form (the pruned encode) at every k = 1..128 and every R = 1..k
   on each shard of a batch of 2 against its plain version and the
   bit-GEMM, the R partials' XOR against the parity rows, and under both
   codecs through the sharded path's dispatch (the codec's C entry alone
   launched); K8b's
   bit-GEMM (K8a's matrices) at every k = 1..128 for both codecs and,
   under leopard-ff8, its Leopard decode against its plain version and the
   bit-GEMM, on k + 3, 20 and 2 axes a k (its three launch shapes), rows
   and columns, the unknown cells garbage; each kernel's
   time as the host issues it and its GPU time (queued behind a sleep)
   beside its bound, plain and library times, K5's, K5b's, K8b's and K9a's
   two kernels timed in turns (K9a over 8 shards at k = 64 and 128), the
   bit-GEMM kernels' share of their tensor-core floor, the FFT kernel's,
   the Leopard decode's and K9a's Leopard kernel's registers, spills and
   SASS opcode mix (more than 128 registers or a spill in K9a's k = 128
   instances fails the phase); K4's per-level latency, the slope of its GPU
   time at batch 1 over n = 2..1024 leaves and over n = 2..32 (warp 0
   alone: half of it is one compression's latency in the kernel), and K3's
   and K4's dependency floor (their levels' chain of compressions at that
   latency), beside the same chain at K1's time per block on one long
   message (a compression fed from L2); the SASS opcode mix of K4; K3's
   level floor (each level the longer of its compressions at the int32
   rate and three at that latency) beside its GPU time at k = 64 and 128,
   on the catch-up batch and on the row stacks' levels, and its registers,
   spills and SASS opcode mix, one instance a tile size (more than 128
   registers or a spill fails the phase: 512 threads fill an SM's
   registers); K7b's
   table mode beside its cell mode, and its latency floor (the GPU time of
   a launch with one load its store waits on, and of an empty launch);
3. the Go-pinned DAH hashes (``da/golden.py``) through the port's entry
   points on the card;
4. the extension path: seeded BlobTx streams, proposer ``square.build`` ->
   ``dah.extend_block`` on the card (through the device-resident plane),
   validator ``square.construct`` -> ``extend_block`` again, 4 blocks at
   max square size 64 and 4 at 128; the two data roots must agree with each
   other and with the port's plain path (``device="cpu"``); the launches
   exactly 5 a block (K5 2, K2, K3, K4 one each);
4b. the serving path on the same 8 blocks, each extended through the plane
   on the card: 64 seeded light clients x 16 samples as one
   ``das.sample_proofs_batch`` of 1,024 cells served by the K7b gather
   (cell mode: only the cells' (row, tree_row, col) go to the card),
   every proof verified against the data root; namespace data for every
   blob namespace and a share proof for every blob, each verified and equal
   to the plain path's (its row level stacks hashed once a block); the
   same cells after the card's entry is dropped, served from
   the EDS on the card (K2's row-set mode + K3 over the touched rows, K4
   for the root tree, one K7b gather: each launched), and by the host
   prover from the plain path's EDS, all with equal bytes.  K1 is launched
   on no serving, miss or fraud path.  Serving a block on the card
   must make no host-prover call and no whole-EDS fetch.  Each path's
   launch counts are reset just before it and read just after; each kernel
   of the path must be > 0.  The warm k = 128 calls again, phase by phase
   (index build, upload, gather, fetch, assembly), in the cell mode and in
   the table mode over the same cells;
4c. repair (``rs.repair_square_device``, BASELINE config 4) of the same
   blocks' EDSs on the card at k = 64 and 128, with the DAH's roots and
   ``return_device=True``, under three masks: 25 % of cells withheld at
   random, k rows and k columns withheld, and the deep-peel chain mask of
   tests/test_torch_repair.py built at k (P = k phases); the result must be
   the plane's EDS, with no repair on the host and, under leopard-ff8, no
   K8a launch (K8b is Leopard's decode).  Medians of 5 warm calls per
   mask at k = 128 (wall, breakdown, kernels by CUDA events).  The
   byzantine cases (a provided cell the decode overwrites, a Q1 cell off
   the codeword, zeroed roots, too few cells) raise on the card with the
   messages of the ``device="cpu"`` path at k = 32;
4d. fraud: a Q1 cell of a k = 128 block flipped and its DAH recommitted on
   the card; ``fraud.detect_bad_encoding`` finds the row, the BEFP built on
   the card verifies against the bad DAH and not the honest one (no K8a
   launch); at k = 32 the card's BEFP equals the ``device="cpu"`` path's;
4e. catch-up (BASELINE config 5): the 8 blocks grouped by size through
   ``dah.data_roots_batched`` (K5b, batched K2/K3, one K4 for the batch),
   each data root equal to the block's DAH hash, the launches exactly 5 a
   batch (K5b 2, K2, K3, K4 one each); then one batch of 8 k = 128 squares
   (the 4 seeded ones and 4 more from the seeded tx stream), timed;
4f. the sharded extension (K9, ``parallel/sharded.py``) on meshes that
   repeat the card R times (``make_mesh([cuda:0] * R)``, R = 1, 2, 4, 8) at
   k = 64 and 128, the 8 seeded blocks at R = 4 and the catch-up batch of 8
   on a 2 x 4 mesh: every EDS and DAH equal to ``extend_and_header``'s on
   the card and to the golden hash; each call's launches exactly those of
   its shards (K9b once a group; counts set to 0 just before it and read
   just after, the single-device references computed outside) and no byte
   staged by its reduce-scatter;
   with two cards or more, a mesh over distinct cards too.  Medians of 5
   warm calls per (k, R), wall and phases (row pass, K9a, reduce-scatter,
   hashing, gathers, finish);
4g. the App on the card (``state/app.py``, ``app_phase``): a proposer App
   and a validator App on ``cuda:0`` from one seeded genesis, 2 heights at
   GovMaxSquareSize 64 and 2 at 128 from seeded PayForBlobs streams that
   overfill the square; CheckTx, prepare, process on the proposer (an
   EDS-cache hit) and on the validator (cold), finalize on both.  Every
   honest block accepted, equal app hashes, every data root equal to the
   plain path's, no panic reject, the launches exactly 5 a cold extension.
   Then a third App replays the heights over a 1 x 4 mesh that repeats the
   card: process_proposal through the sharded leg and
   validate_blocks_batched through the batched leg, every verdict accept,
   each leg's launches exactly its shards'.  Medians of the prepare wall
   (filter, build, extend) and of the process_proposal wall per k;
4h. the devnet on the card (``devnet_phase``): ``TestNode(device=cuda:0)``
   runs 3 heights at GovMaxSquareSize 64 and 1 at 128 from seeded
   PayForBlobs and sends submitted through the port's Signer, each block
   cut by ``produce_block`` (prepare, process as an EDS-cache hit,
   finalize); every data root equal to the plain path's; ``abci_query``
   answers 1,024 DAS cells, namespace data, a share proof and two tx
   proofs a height, every proof verified against the data root, and at one
   height a k the answers equal the plain functions' on a CPU copy of the
   EDS; the first height, aged out of the node's one-block EDS cache, is
   rebuilt on the card.  Then ``ValidatorNetwork(n_validators=4,
   device=cuda:0, malicious={1: "out_of_order"})`` runs 4 heights at k =
   64: validator 1's block rejected 3 to 1 and the next proposer's
   committed, one app hash on every validator, data roots equal to the
   plain path's; ``join_validator`` catches up through
   ``dah.data_roots_batched`` and lands on the network's app hash.  Each
   leg's launches (produce, queries, rebuild, network, join) are read just
   after it with the counts set to 0 just before it, and held to their
   prediction; walls of ``produce_block``, each query, the rebuild, each
   network height and the join;
4i. the node as users start it (``service_phase``): ``NodeService`` over
   ``TestNode(device=cuda:0)`` with tracing and devprof on, 3 heights at k
   = 64 and 4 at 128 (one untraced, one under ``torch.profiler``), clients
   through RemoteNode's request bytes to the service's handlers; data roots
   equal to the plain path's, every served DAS, share and tx proof
   verified; ``/healthz`` and ``/metrics`` over 127.0.0.1 with the dispatch
   counts held to the launch counters, busy time, memory gauges and the
   cost table; the TraceDump's device track under the host spans; the
   card's busy and idle share of each ``produce_block``; then the CLI:
   ``keys add``, ``init``, ``validate-genesis`` as subprocesses, ``start``
   on the card serving gRPC as a subprocess, a client's ``tx
   pay-for-blob`` and verified ``query share-proof`` and ``das-sample``,
   SIGTERM and exit 0;
4j. the network stack on the card (``network_phase``): a gossip mesh of 4
   ``cli start --bft-valset --peers`` processes on the card at
   GovMaxSquareSize 64 (one seed each, PEX, tracing on); a ``cli
   bft-relay`` observer over the first filled height, then killed; 4 heights
   filled to k = 64 by seeded PayForBlobs sent to one validator each
   (want/have gossip carries them); validator 3 stopped by SIGTERM after
   the second and restarted from its home after the fourth, caught up by
   the certificate-verified catch-up on the card (``bft_catchup_batch``;
   one card has no mesh, so it adopts block by block, each block's
   extension cold: K5, K2, K3, K4); every process on
   one data root and app hash at every height, each data root the plain
   path's; ``cli query cluster-health`` and ``cluster-trace``, ``cli
   txsim``, the DAS swarm (``SwarmConfig()``) with its served cells
   verified; each process's launches from its Metrics exposition beside
   the prediction; then a ``ProcessCoordinator`` over 3 ``NodeServer``s
   of ``TestNode(device=cuda:0)`` for 2 heights at k = 64, data roots the
   plain path's;
4k. the host regime (``host_phase``): ``dah.extend_and_header(sq,
   device="cpu")``, the native library's legs the port runs when the
   caller asks for the CPU, on 4 seeded squares at k = 64 and 4 at 128
   against the card's ``extend_and_header``: equal EDS bytes, 4k axis roots
   and data roots, no launch counted across the host calls; walls of both
   beside the host CPU's model, ``hostpool.cpu_threads()`` and
   ``torch.get_num_threads()``; ``extend_and_header_breakdown`` on the card
   and on the CPU (upload, compute, fetch: medians of 5); at k = 128 a 25 %
   random mask repaired by ``rs.repair_square`` on the host and by
   ``repair_square_device`` on the card, both giving the EDS, walls of both;
   in a child process under lagrange-gf256 (a process pins its codec at the
   library's first use), a k = 64 square and one sharing 3/4 of its rows:
   the row memo assembles the second once, at 37.5 % reuse, with the card's
   bytes; one filled k = 64 height of ``TestNode(device="cpu")`` and of a
   TestNode on the card on the same transactions: one data root, both
   ``produce_block`` walls; the card legs' launches held to 5 an
   extension;
4l. the tool gates on the card (``tools_phase``): each twin of the JAX
   package's ``tools/*_smoke.py`` (``python -m celestia_tpu_torch.tools.
   <name> --device cuda:0``: das, swarm, ingress, device_resident,
   profile, trace, critpath, incident, multichip) as a process of its
   own, three at a time, each exiting 0 with its summary lines; each
   node's launches, from its Metrics exposition, held to 5 a cold
   extension or rebuilt block and one K7b a streamed DAS chunk (and one a
   direct DAS batch); multichip's to ``sharded_launches_per_call(k, 2)``
   on a mesh that repeats the card; the phase's wall and each twin's;
5. the kernels line (JSON: time, bound, plain time, library time, launches
   summed over every path) and, last, ``{"ok": true, "device": {...}}``.

"The plain path" of phases 4-4j is the port with ``device="cpu"``: at the
block entry points (``dah.extend_block(square, device="cpu")``, the path
references of phases 4, 4g-4j) that is the host regime, the native
library's legs, and elsewhere (serving, ``repair_square_device``, fraud,
the catch-up batch) the plain PyTorch twins.  Each kernel is held against
its plain twin in phase 2 and where a phase says so.

Imports torch, numpy and the port; nothing of JAX or of ``celestia_tpu``.
It exits non-zero without a result when no CUDA device is present or the
port is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import importlib.util
import json
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the bound column's rates and formulas: the ones the port's cost table uses
from celestia_tpu_torch.utils.devprof import (  # noqa: E402
    INT8_TENSOR_OPS_PER_S,
    INT32_OPS_PER_S,
    SHA_OPS_PER_COMPRESSION,
    bit_gemm_ops,
    bound,
    compressions,
    decode_matrix_ops,
    leopard_decode_ops,
    leopard_extend_ops,
    leopard_partial_ops,
)

REPLACES = {
    "sha256_batch": "celestia_tpu/ops/sha256.py:100",
    "nmt_leaf_digests": "celestia_tpu/ops/nmt.py:83",
    "nmt_combine_level": "celestia_tpu/ops/nmt.py:53",
    "rfc6962_root": "celestia_tpu/ops/nmt.py:272",
    "rs_extend": "celestia_tpu/ops/rs.py:64",
    "das_proof_gather": "celestia_tpu/da/device_plane.py:286",
    "rs_extend_batched": "celestia_tpu/ops/rs.py:102",
    "rs_decode_matrices": "celestia_tpu/ops/rs.py:150",
    "rs_decode_axes": "celestia_tpu/ops/rs.py:206",
    "rs_repair_verdicts": "celestia_tpu/ops/rs.py:257",
    "rs_col_parity_partial": "celestia_tpu/parallel/sharded.py:78",
    "xor_reduce_slabs": "celestia_tpu/parallel/sharded.py:89",
}
SOURCES = {
    "sha256_batch": "celestia_tpu_torch/csrc/sha256.cu",
    "nmt_leaf_digests": "celestia_tpu_torch/csrc/nmt.cu",
    "nmt_combine_level": "celestia_tpu_torch/csrc/nmt.cu",
    "rfc6962_root": "celestia_tpu_torch/csrc/rfc6962.cu",
    "rs_extend": "celestia_tpu_torch/csrc/rs_leopard.cu",
    "das_proof_gather": "celestia_tpu_torch/csrc/das_gather.cu",
    "rs_extend_batched": "celestia_tpu_torch/csrc/rs_leopard.cu",
    "rs_decode_matrices": "celestia_tpu_torch/csrc/rs_decode.cu",
    "rs_decode_axes": "celestia_tpu_torch/csrc/rs_leopard_decode.cu",
    "rs_repair_verdicts": "celestia_tpu_torch/csrc/rs_decode.cu",
    "rs_col_parity_partial": "celestia_tpu_torch/csrc/rs_leopard_partial.cu",
    "xor_reduce_slabs": "celestia_tpu_torch/csrc/rs_sharded.cu",
}
# K5, K5b, K8b and K9a run Leopard's kernels (the FFT, the erasure decode,
# the pruned encode) under
# leopard-ff8, the chain's codec and the main path's, and the bit-GEMM
# kernels under lagrange-gf256: the kernels line reports the Leopard forms
# under the launch counters' names and the bit-GEMM ones under these, each
# bit-GEMM entry's launches counted by C entry
BIT_GEMM_FORMS = {
    "rs_extend_bit_gemm": ("rs_extend", ("ctt_rs_extend", "ctt_rs_extend_rows"),
                           "celestia_tpu_torch/csrc/rs_extend.cu"),
    "rs_extend_batched_bit_gemm": ("rs_extend_batched", ("ctt_rs_extend_batched",),
                                   "celestia_tpu_torch/csrc/rs_extend.cu"),
    "rs_decode_axes_bit_gemm": ("rs_decode_axes", ("ctt_rs_decode_axes",),
                                "celestia_tpu_torch/csrc/rs_decode.cu"),
    "rs_col_parity_partial_bit_gemm": ("rs_col_parity_partial", ("ctt_rs_col_parity_partial",),
                                       "celestia_tpu_torch/csrc/rs_extend.cu"),
}
for _name, (_kernel, _, _source) in BIT_GEMM_FORMS.items():
    REPLACES[_name] = REPLACES[_kernel]
    SOURCES[_name] = _source
LEOPARD_ENTRIES = ("ctt_rs_leopard_extend", "ctt_rs_leopard_extend_batched",
                   "ctt_rs_leopard_extend_rows", "ctt_rs_leopard_decode_axes",
                   "ctt_rs_leopard_col_parity_partial")
# the kernels each path must launch
EXTEND_KERNELS = ("nmt_leaf_digests", "nmt_combine_level", "rfc6962_root", "rs_extend")
SERVE_KERNELS = ("das_proof_gather",)
# a block on the card with no cached entry (da/device_plane.py sample_proofs_from_eds)
MISS_KERNELS = ("nmt_leaf_digests", "nmt_combine_level", "rfc6962_root", "das_proof_gather")
# repair: decode, re-extension, verdicts, axis roots
REPAIR_KERNELS = ("rs_decode_axes", "rs_extend", "rs_repair_verdicts", "nmt_leaf_digests",
                  "nmt_combine_level")
# fraud: detection (decode + verdicts), then the BEFP's orthogonal trees and gather
FRAUD_KERNELS = ("rs_decode_axes", "rs_repair_verdicts", "nmt_leaf_digests", "nmt_combine_level",
                 "das_proof_gather")
# K8a builds the Lagrange matrices of K8b's bit-GEMM form: under leopard-ff8
# (Leopard's decode) no repair or fraud path launches it
LAGRANGE_ONLY_KERNELS = ("rs_decode_matrices",)
# the row level stacks of serving, a miss and fraud are K2's row-set mode + K3
OFF_PATH_KERNELS = ("sha256_batch",)
CATCHUP_KERNELS = ("rs_extend_batched", "nmt_leaf_digests", "nmt_combine_level", "rfc6962_root")
# the sharded extension: K5's row pass, K9a, K9b, K2 windows, K3, K4
SHARDED_KERNELS = ("rs_extend", "rs_col_parity_partial", "xor_reduce_slabs", "nmt_leaf_digests",
                   "nmt_combine_level", "rfc6962_root")
SHARDS = 8  # row shards of the kernels' checks and times at k = 128
# the sleep a timed run is queued behind (~50 ms at 1.98 GHz): longer than
# the host takes to issue its calls
QUEUE_SLEEP_CYCLES = 100_000_000
# SHA-256 blocks of the one message whose time per block prices one
# compression fed from L2 (K1's dependency floor)
CHAIN_BLOCKS = 1025
SHARDED_RUNS = 5  # warm calls per (k, R) of the sharded extension
REPAIR_RUNS = 5  # warm calls per mask at k = 128
CLIENTS, SAMPLES = 64, 16  # light clients per block, samples per client (da/das.py:443)
# the phases --phases selects from; 3-4f share the seeded blocks and run together
PHASES = ("1", "2", "3", "4", "4b", "4c", "4d", "4e", "4f", "4g", "4h", "4i", "4j", "4k", "4l",
          "5")
PHASE_GROUPS = {name: "4" for name in ("3", "4b", "4c", "4d", "4e", "4f")}
DEVNET_NET_HEIGHTS = 4  # ValidatorNetwork heights of phase 4h (validator 1 proposes at 5)
# the devnet's queries: DAS from the plane entry (K7b's cell mode), namespace
# data and share and tx proofs (K2's row-set mode + K3, K7b's table mode)
DEVNET_SERVE_KERNELS = ("nmt_leaf_digests", "nmt_combine_level", "das_proof_gather")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def deep_peel_mask(k: int) -> np.ndarray:
    """The chain mask of tests/test_torch_repair.py (``DEEP_PEEL_K8``) at
    any k: k^2 cells, peeled in P = k phases.  Row i < k lacks columns i-1
    and i of the first k and holds column k+i; column j < k-1 also holds
    row k+j."""
    n2 = 2 * k
    i = np.arange(k)
    avail = np.zeros((n2, n2), dtype=bool)
    avail[:k, :k] = (i[None, :] < i[:, None] - 1) | (i[None, :] > i[:, None])
    avail[i, k + i] = True
    avail[k + i[:-1], i[:-1]] = True
    return avail


def sharded_launches_per_call(k: int, R: int, groups: int = 1) -> dict:
    """The launches of one sharded extension on a mesh that repeats one card,
    ``groups`` data groups of R row shards (parallel/sharded.py): per shard
    K5's row pass, K9a and two K2 windows, and one K3 launch for all the
    row-tree levels and one for all the column-subtree levels (none at k/R
    = 1, a subtree of one leaf); per group one K9b launch for all its
    shards' reduce-scatter (the group's shards share the device, whose
    kernel reads their partials in place), one K3 launch for the log2(2R)
    finishing levels (once, for the same reason), and one K4 launch from
    the axis roots (no K1)."""
    from celestia_tpu_torch import kernels

    shards = groups * R
    counts = {name: 0 for name in kernels.KERNELS}
    counts.update(rs_extend=shards, rs_col_parity_partial=shards, xor_reduce_slabs=groups,
                  nmt_leaf_digests=2 * shards,
                  nmt_combine_level=shards * (1 + (k // R > 1)) + groups,
                  rfc6962_root=groups)
    return counts


def block_launches(calls: int, batched: bool = False) -> dict:
    """The launches of ``calls`` extensions of one square (or, ``batched``,
    of one batch of squares) through the plane: K5 (or K5b) twice, then K2,
    one K3 launch for every level of the 4k trees, and one K4 launch from
    the 4k axis roots to the data root (no K1)."""
    from celestia_tpu_torch import kernels

    counts = {name: 0 for name in kernels.KERNELS}
    counts.update({"rs_extend_batched" if batched else "rs_extend": 2 * calls},
                  nmt_leaf_digests=calls, nmt_combine_level=calls, rfc6962_root=calls)
    return counts


APP_KEYS = 40  # funded signers of phase 4g: each signs one PayForBlobs in the run
APP_PFBS = 10  # PayForBlobs a height at most (signing is host work)
APP_CHAIN = "chip-smoke-1"
APP_GENESIS_NS = 1_700_000_000 * 10**9
APP_BLOCK_NS = 15 * 10**9


class PlainRowStacks:
    """The plain path's row level stacks of an EDS's original rows (the rows
    a namespace or a blob can cover), hashed once: one ``row_level_stack``
    call over all k rows on the CPU, which hashes each row's tree apart from
    the others.  Inside ``with``, the port's ``nmt.row_level_stack`` answers
    a call on these rows' bytes with that batch's slice, so the plain
    ``namespace_data`` and ``proof`` calls of a block cost their gathers, not
    0.5 s of hashing each; any other call runs as it is.  The first answer
    is also held against the call it stands in for."""

    def __init__(self, eds):
        from celestia_tpu_torch.ops import nmt as nmt_ops

        self._nmt, self._k = nmt_ops, eds.square_size
        self._rows = eds.tensor[: self._k]
        self._levels, self._checked = None, False

    def _serve(self, real):
        import torch

        def row_level_stack(src, rows, in_place=False):
            ids = [int(r) for r in rows]
            if (in_place or src.device.type != "cpu" or not ids or min(ids) < 0
                    or max(ids) >= self._k or not torch.equal(src, self._rows[ids])):
                return real(src, rows, in_place)
            if self._levels is None:
                self._levels = real(self._rows, range(self._k))
            got = [level[ids] for level in self._levels]
            if not self._checked:
                want = real(src, rows, in_place)
                check(len(got) == len(want) and all(map(torch.equal, got, want)),
                      "the plain row stacks hashed once differ from the call's own")
                self._checked = True
            return got

        return row_level_stack

    def __enter__(self):
        self._real = self._nmt.row_level_stack
        self._nmt.row_level_stack = self._serve(self._real)
        return self

    def __exit__(self, *exc):
        self._nmt.row_level_stack = self._real


def pfb_blobs(rng, k: int, n: int) -> list:
    """The blobs of ``n`` seeded PayForBlobs, 1-3 blobs each, ~1.25x the
    blob capacity of a k x k square in all (phases 4g and 4h)."""
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace

    per_blob = int(1.25 * k * k * 478 / (2 * n))
    return [tuple(Blob(Namespace.v0(b"\x01" + rng.bytes(9)),
                       rng.bytes(int(rng.integers(per_blob // 2, 3 * per_blob // 2))))
                  for _ in range(int(rng.integers(1, 4))))
            for _ in range(n)]


def sum_counts(counts) -> dict:
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def app_phase(dev, sizes, seed: int, *, counted: bool) -> dict:
    """Phase 4g, the App on ``dev``: a proposer App and a validator App from
    one seeded genesis run one height for each square size in ``sizes``
    (GovMaxSquareSize set to it on both Apps, as a passed proposal would),
    from seeded PayForBlobs streams that overfill the square.  Each height:
    CheckTx and prepare on the proposer, process on the proposer (an
    EDS-cache hit) and on the validator (a cold extension: the validator is
    another node, so the device's EDS cache is emptied before it), finalize
    on both.  Every honest block is accepted, the app hashes agree, every
    data root equals the plain path's (``device="cpu"``) and no panic turns
    into a reject.  Then a mesh that repeats ``dev`` 4 times (1 x 4) and a
    third App replay the same heights: each block's process_proposal
    through the sharded leg, then each run of same-size heights through
    validate_blocks_batched's batched leg, both cold, then finalize.

    ``counted``: the device is a card, and each leg's kernel launches are
    returned (read just after it, the counts set to 0 just before it).
    Returns the launches, walls and breakdowns."""
    import torch

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.da import dah, eds_cache, inclusion
    from celestia_tpu_torch.da.blob import BlobTx
    from celestia_tpu_torch.parallel import mesh as provider
    from celestia_tpu_torch.state.app import App
    from celestia_tpu_torch.state.modules.blob import estimate_gas
    from celestia_tpu_torch.state.tx import Fee, MsgPayForBlobs, Tx
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    rng = np.random.default_rng(seed)
    keys = [PrivateKey.from_seed(b"chip-smoke-app-%d" % i) for i in range(APP_KEYS)]
    val_addr = PrivateKey.from_seed(b"chip-smoke-app-validator").public_key().address()
    genesis = {
        "chain_id": APP_CHAIN,
        "genesis_time_ns": APP_GENESIS_NS,
        "codec": "leopard-ff8",
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**13}
                     for k in keys],
        "validators": [{"address": val_addr.hex(), "self_delegation": 10**9}],
        "params": {"blob": {"GovMaxSquareSize": sizes[0]}},
    }

    def new_app():
        app = App(chain_id=APP_CHAIN, device=dev)
        app.init_chain(genesis)
        return app

    def pfb_stream(k: int, signers) -> list:
        """PayForBlobs of 1-3 blobs, ~1.25x the square's blob capacity over
        APP_PFBS txs, each from its own signer at sequence 0."""
        txs = []
        for key, blobs in zip(signers, pfb_blobs(rng, k, APP_PFBS)):
            addr = key.public_key().address()
            msg = MsgPayForBlobs(addr, tuple(b.namespace.raw for b in blobs),
                                 tuple(len(b.data) for b in blobs),
                                 tuple(inclusion.create_commitment(b) for b in blobs),
                                 tuple(b.share_version for b in blobs))
            gas = estimate_gas([len(b.data) for b in blobs])
            acct = proposer.accounts.get(addr).account_number
            tx = Tx((msg,), Fee(-(-gas * 2 // 1000) + 1, gas), key.public_key().compressed(), 0,
                    acct)
            txs.append(BlobTx(tx.signed(key, APP_CHAIN).marshal(), blobs).marshal())
        return txs

    def set_max_k(apps, k: int) -> None:
        for app in apps:
            if app.blob.gov_max_square_size() != k:
                app.params.set("blob", "GovMaxSquareSize", k)

    provider.configure("off")  # the single-device leg, whatever cards are visible
    proposer, validator = new_app(), new_app()
    cache = eds_cache.content_cache(dev)
    heights, out = [], {"prepare": {}, "process_hit_ms": {}, "process_cold_ms": {},
                        "prepare_wall_ms": {}, "key_ms": {}}
    kernels.reset_launch_counts()
    for i, k in enumerate(sizes):
        height = 2 + i
        set_max_k((proposer, validator), k)
        txs = pfb_stream(k, keys[i * APP_PFBS:(i + 1) * APP_PFBS])
        check(all(proposer.check_tx(raw).code == 0 for raw in txs), "CheckTx refused a PFB")
        t0 = time.perf_counter()
        prepared = proposer.prepare_proposal(txs)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        check(prepared.square_size == k, f"the square filled to {prepared.square_size}, not {k}")
        check(len(prepared.block_txs) < len(txs), "the stream did not overfill the square")
        check(prepared.eds.tensor.device == torch.device(dev), "the EDS left the App's device")
        block = (prepared.block_txs, prepared.square_size, prepared.data_root)
        t0 = time.perf_counter()
        hit = proposer.process_proposal(*block)
        hit_ms = (time.perf_counter() - t0) * 1e3
        cache.clear()
        t0 = time.perf_counter()
        cold = validator.process_proposal(*block)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(hit == cold == (True, ""), f"an honest block was rejected: {hit}, {cold}")
        time_ns = APP_GENESIS_NS + height * APP_BLOCK_NS
        finals = [a.finalize_block(list(block[0]), height, time_ns, block[2], proposer=val_addr)
                  for a in (proposer, validator)]
        check(finals[0][2] == finals[1][2], f"app hashes differ at height {height}")
        check(all(r.code == 0 for r in finals[0][0]), "a PFB of the block failed to deliver")
        heights.append((height, block, prepared.square, finals[0][2]))
        t0 = time.perf_counter()  # the extend leg's cache key: sha256 over the block's bytes
        eds_cache.make_key(block[0], k, proposer.app_version, proposer.codec)
        key_ms = (time.perf_counter() - t0) * 1e3
        for name, ms in (("prepare_wall_ms", prepare_ms), ("process_hit_ms", hit_ms),
                         ("process_cold_ms", cold_ms), ("key_ms", key_ms)):
            out[name].setdefault(k, []).append(ms)
        out["prepare"].setdefault(k, []).append(dict(proposer.last_prepare_breakdown))
    out["launches"] = kernels.launch_counts()
    if counted:
        want = block_launches(2 * len(sizes))
        check(out["launches"] == want, f"App launches {out['launches']} != {want}")
    for app in (proposer, validator):
        check(app.telemetry.counters.get("process_proposal_panic_reject", 0) == 0,
              "a process_proposal panic was turned into a reject")
    check(proposer.telemetry.counters.get("eds_cache_hit_process", 0) == len(sizes),
          f"proposer EDS-cache hits {proposer.telemetry.counters.get('eds_cache_hit_process')}")
    check(validator.telemetry.counters.get("eds_cache_miss_process", 0) == len(sizes),
          "the validator's extensions were not cold")
    for _, block, square, _ in heights:
        _, plain = dah.extend_block(square, device="cpu")
        check(plain.hash == block[2], f"the App's data root at k={block[1]} != the plain path's")
    out["app_hashes"] = [h[3].hex() for h in heights]
    out["data_roots"] = [h[1][2].hex() for h in heights]

    # the mesh leg: a third App replays the heights over a 1 x 4 mesh of dev
    provider.configure("1x4", devices=[dev] * 4)
    try:
        replay = new_app()
        routed, batched = [], []
        windows = []
        for h in heights:
            if windows and windows[-1][0][1][1] == h[1][1]:
                windows[-1].append(h)
            else:
                windows.append([h])
        for window in windows:
            k = window[0][1][1]
            set_max_k((replay,), k)
            cache.clear()
            kernels.reset_launch_counts()
            verdicts = [replay.process_proposal(*block) for _, block, _, _ in window]
            routed.append(kernels.launch_counts())
            check(all(v == (True, "") for v in verdicts), f"mesh process_proposal: {verdicts}")
            if counted:
                want = sum_counts([sharded_launches_per_call(k, 4)] * len(window))
                check(routed[-1] == want, f"sharded process launches {routed[-1]} != {want}")
            cache.clear()
            kernels.reset_launch_counts()
            verdicts = replay.validate_blocks_batched([block for _, block, _, _ in window])
            batched.append(kernels.launch_counts())
            check(verdicts == [(True, "")] * len(window), f"validate_blocks_batched: {verdicts}")
            if counted:
                want = sharded_launches_per_call(k, 4)
                check(batched[-1] == want, f"batched launches {batched[-1]} != {want}")
            for height, block, _, app_hash in window:
                got = replay.finalize_block(list(block[0]), height,
                                            APP_GENESIS_NS + height * APP_BLOCK_NS, block[2],
                                            proposer=val_addr)[2]
                check(got == app_hash, f"the mesh replay's app hash differs at height {height}")
        counters = replay.telemetry.counters
        check(counters.get("extend_sharded", 0) == len(sizes), f"extend_sharded {counters}")
        check(counters.get("extend_batched_blocks", 0) == len(sizes),
              f"extend_batched_blocks {counters}")
        check(counters.get("process_proposal_panic_reject", 0) == 0,
              "a mesh process_proposal panic was turned into a reject")
    finally:
        provider.configure(None)
    out["mesh_launches"] = sum_counts(routed + batched)
    return out


DEVNET_CHAIN = "chip-smoke-devnet-1"
DEVNET_CELLS = 1024  # DAS cells a height asks of the node (64 light clients x 16)


def devnet_phase(dev, sizes, net_heights: int, seed: int, *, counted: bool) -> dict:
    """Phase 4h, the devnet on ``dev`` (node/testnode.py, node/network.py,
    client/signer.py).

    The single node: ``TestNode(device=dev)`` from a seeded genesis of
    funded keys runs one height for each square size in ``sizes``
    (GovMaxSquareSize set to it).  Each height's seeded PayForBlobs
    (``pfb_blobs``, overfilling the square) and two sends go through the
    port's Signer, then ``produce_block`` prepares, processes (an EDS-cache
    hit) and finalizes.  Each height's data root equals the plain path's
    (``device="cpu"``); ``abci_query`` answers ``custom/das/sample_batch``
    (DEVNET_CELLS seeded cells), ``custom/namespace/shares``,
    ``custom/proof/share`` and ``custom/proof/tx``, and every proof
    verifies against the data root.  At the first height of each k the
    answers equal the plain functions' on a CPU copy of the EDS.  The node
    keeps one block's EDS (``eds_cache_blocks = 1``), so the first height,
    queried again at the end, is rebuilt on ``dev`` by ``_block_artifacts``.

    The network: ``ValidatorNetwork(n_validators=4, device=dev,
    malicious={1: "out_of_order"})`` runs ``net_heights`` heights from the
    same kind of stream, each overfilling the square at the network's
    GovMaxSquareSize (its genesis sets none: the default, 64).  Validator 1
    proposes at height 5: its block is rejected 3 to 1 and the next
    proposer's commits; every validator ends on one app hash and every data
    root equals the plain path's.  Then ``join_validator`` catches up
    through ``dah.data_roots_batched`` and lands on the network's app hash.

    ``counted``: the device is a card, and each leg's kernel launches are
    returned (read just after it, the counts set to 0 just before it) and
    held to their prediction.  Returns the launches and walls."""
    import torch

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client.signer import Signer, SubmitResult
    from celestia_tpu_torch.da import dah, das, namespace_data, proof
    from celestia_tpu_torch.da.blob import unmarshal_blob_tx
    from celestia_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
    from celestia_tpu_torch.da.square import construct
    from celestia_tpu_torch.node.network import ValidatorNetwork
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.parallel import mesh as provider
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    class BroadcastOnly(Signer):
        """The port's Signer (commitments, gas estimate, signing, nonce
        recovery, broadcast) without its confirmation poll: the phase cuts
        the blocks itself."""

        def confirm_tx(self, tx_hash, **kw):
            return SubmitResult(0, "", tx_hash)

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    heights = len(sizes) + net_heights
    keys = [PrivateKey.from_seed(b"chip-smoke-devnet-%d" % i) for i in range(APP_PFBS * heights)]
    senders = [PrivateKey.from_seed(b"chip-smoke-devnet-send-%d" % i) for i in range(2)]
    validator = PrivateKey.from_seed(b"chip-smoke-devnet-validator")
    funded = [(k, 10**13) for k in keys + senders]

    def submit(node, height_keys, k: int, send_signers) -> None:
        for key, blobs in zip(height_keys, pfb_blobs(rng, k, APP_PFBS)):
            res = BroadcastOnly(node, key).submit_pay_for_blob(list(blobs))
            check(res.code == 0, f"a PayForBlobs was refused: {res.log}")
        for s in send_signers:
            res = s.submit_tx([MsgSend(s.address, rng.bytes(20), int(rng.integers(1, 10**4)))])
            check(res.code == 0, f"a send was refused: {res.log}")

    def plain_root(blk) -> bytes:
        square, _, _ = construct(blk.txs, blk.header.square_size)
        return dah.extend_block(square, device="cpu")[1].hash

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def counted_leg(fn):
        """fn's result, its wall and the launches it made."""
        kernels.reset_launch_counts()
        out, ms = timed(fn)
        return out, ms, kernels.launch_counts()

    out = {"produce_ms": {}, "prepare": {}, "query_ms": {}, "net_height_ms": []}
    legs = {name: [] for name in ("produce", "serve", "rebuild", "network", "join")}
    provider.configure("off")  # the single-device leg, whatever cards are visible
    try:
        # --- the single node ---------------------------------------------
        genesis = {
            "chain_id": DEVNET_CHAIN, "genesis_time_ns": APP_GENESIS_NS, "codec": "leopard-ff8",
            "accounts": [{"address": k.public_key().address().hex(), "balance": b}
                         for k, b in funded],
            "validators": [{"address": validator.public_key().address().hex(),
                            "self_delegation": 10**9}],
            # the largest size first: the mempool's bound is set from it
            "params": {"blob": {"GovMaxSquareSize": max(sizes)}},
        }
        node = TestNode(chain_id=DEVNET_CHAIN, genesis=genesis, validator_key=validator,
                        device=dev, auto_produce=False)
        node.eds_cache_blocks = 1
        check(node.app.device == dev, f"the node's App is on {node.app.device}, not {dev}")
        send_signers = [BroadcastOnly(node, k) for k in senders]
        first, compared = None, set()
        for i, k in enumerate(sizes):
            if node.app.blob.gov_max_square_size() != k:
                node.app.params.set("blob", "GovMaxSquareSize", k)
            submit(node, keys[i * APP_PFBS:(i + 1) * APP_PFBS], k, send_signers)
            hits = node.app.telemetry.counters.get("eds_cache_hit_process", 0)
            blk, ms, n = counted_leg(node.produce_block)
            legs["produce"].append(n)
            out["produce_ms"].setdefault(k, []).append(ms)
            out["prepare"].setdefault(k, []).append(dict(node.app.last_prepare_breakdown))
            h, root = blk.header.height, blk.header.data_hash
            check(blk.header.square_size == k, f"height {h} filled to {blk.header.square_size}")
            check(node.app.telemetry.counters.get("eds_cache_hit_process", 0) == hits + 1,
                  f"process_proposal at height {h} was not an EDS-cache hit")
            art = node._eds_cache[h]
            check(art["eds"].tensor.device == dev, "the block's EDS left the node's device")
            check(plain_root(blk) == root, f"the node's data root at height {h} != the plain path's")
            # the queries: 1,024 cells, one blob's namespace, a share range
            # across a row boundary, a normal tx and a PFB
            cells = [[int(r), int(c)] for r, c in rng.integers(0, 2 * k, (DEVNET_CELLS, 2))]
            ns = next(unmarshal_blob_tx(t).blobs[0].namespace.raw for t in blk.txs
                      if unmarshal_blob_tx(t) is not None)
            start = k * int(rng.integers(0, k - 1)) + k - 4
            routes = [
                ("custom/das/sample_batch", {"height": h, "coords": cells}),
                ("custom/namespace/shares", {"height": h, "namespace": ns.hex()}),
                ("custom/proof/share", {"height": h, "start": start, "end": start + 8}),
                ("custom/proof/tx", {"height": h, "tx_index": 0}),
                ("custom/proof/tx", {"height": h, "tx_index": len(blk.txs) - 1}),
            ]
            kernels.reset_launch_counts()
            got = []
            for path, args in routes:
                ans, ms = timed(lambda: node.abci_query(path, dict(args)))
                got.append(ans)
                out["query_ms"].setdefault(f"{path.split('/', 1)[1]}", []).append(ms)
            legs["serve"].append(kernels.launch_counts())
            if first is None:
                first = (h, routes[0], got[0])
            das_ans, ns_ans, share_ans, *tx_ans = got
            check(len(das_ans["proofs"]) == DEVNET_CELLS and all(
                das.SampleProof.from_dict(p).verify(root) for p in das_ans["proofs"]),
                f"a served DAS proof does not verify at height {h}")
            rows = tuple(bytes.fromhex(r) for r in ns_ans["dah"]["row_roots"])
            cols = tuple(bytes.fromhex(c) for c in ns_ans["dah"]["col_roots"])
            hdr = DataAvailabilityHeader(rows, cols, DataAvailabilityHeader.compute_hash(rows, cols))
            check(hdr.hash == root and namespace_data.NamespaceData.from_dict(
                ns_ans["data"]).verify(hdr), f"served namespace data do not verify at height {h}")
            for ans in [share_ans] + tx_ans:
                check(proof.ShareInclusionProof.from_dict(ans["proof"]).verify(root),
                      f"a served share or tx proof does not verify at height {h}")
            if k not in compared:
                # the plain functions on a CPU copy of the EDS
                compared.add(k)
                eds_cpu = ExtendedDataSquare(art["eds"].shares)
                normal = [t for t in blk.txs if unmarshal_blob_tx(t) is None]
                wrapped = [w.marshal() for w in art["wrappers"]]
                want = [
                    [p.to_dict() for p in das.sample_proofs_batch(
                        eds_cpu, art["dah"], [tuple(c) for c in cells])],
                    namespace_data.get_shares_by_namespace(eds_cpu, art["dah"], ns).to_dict(),
                    proof.new_share_inclusion_proof(eds_cpu, art["dah"], start,
                                                    start + 8).to_dict(),
                ] + [proof.new_tx_inclusion_proof(art["square"], eds_cpu, art["dah"], normal,
                                                  wrapped, a["tx_index"]).to_dict()
                     for _, a in routes[3:]]
                served = [das_ans["proofs"], ns_ans["data"], share_ans["proof"]] + [
                    a["proof"] for a in tx_ans]
                check(served == want, f"served answers at height {h} differ from the plain "
                      "functions' on the CPU")
        # the first height left the node's EDS cache: rebuilt on dev
        h, (path, args), got = first
        check(h not in node._eds_cache, "the first height is still in the node's EDS cache")
        again, ms, n = counted_leg(lambda: node.abci_query(path, dict(args)))
        legs["rebuild"].append(n)
        out["rebuild_ms"] = ms
        check(again == got, "the rebuilt block's DAS answers differ from the first ones")
        check(node._eds_cache[h]["eds"].tensor.device == dev, "the rebuild left the device")
        out["node"] = {"heights": len(sizes), "app_hash": node.blocks[-1].header.app_hash.hex(),
                       "data_roots": [b.header.data_hash.hex() for b in node.blocks]}

        # --- the network -------------------------------------------------
        net_keys = keys[len(sizes) * APP_PFBS:]
        net = ValidatorNetwork(n_validators=4, device=dev, malicious={1: "out_of_order"},
                               funded_accounts=funded)
        net_k = net.app.blob.gov_max_square_size()
        kernels.reset_launch_counts()
        for i in range(net_heights):
            submit(net, net_keys[i * APP_PFBS:(i + 1) * APP_PFBS], net_k, [])
            blk, ms = timed(net.produce_block)
            out["net_height_ms"].append(ms)
            check(blk.header.square_size == net_k, f"network height filled to "
                  f"{blk.header.square_size}")
        legs["network"].append(kernels.launch_counts())
        byz = [r for r in net.rounds if r.proposer == "val-1"]
        check(len(byz) == 1 and not byz[0].committed, f"the byzantine rounds: {byz}")
        accepts = [v.validator for v in byz[0].votes if v.accept]
        check(accepts == ["val-1"] and len(byz[0].votes) == 4,
              f"the byzantine block's votes: {byz[0].votes}")
        after = net.rounds[net.rounds.index(byz[0]) + 1]
        check(after.committed and after.proposer == "val-2" and after.height == byz[0].height,
              "the next proposer did not commit the byzantine height")
        hashes = {v.app.store.app_hash() for v in net.validators}
        check(hashes == {net.blocks[-1].header.app_hash}, "the validators' app hashes differ")
        for blk in net.blocks:
            check(plain_root(blk) == blk.header.data_hash,
                  f"the network's data root at height {blk.header.height} != the plain path's")
        joined, ms, n = counted_leg(net.join_validator)
        legs["join"].append(n)
        out["join_ms"] = ms
        check(joined.app.store.app_hash() == net.blocks[-1].header.app_hash,
              "the joining validator's app hash differs from the network's")
        out["network"] = {"heights": net_heights, "rounds": len(net.rounds),
                          "byzantine_height": byz[0].height,
                          "app_hash": net.blocks[-1].header.app_hash.hex()}
    finally:
        provider.configure(None)
    out["launches"] = {name: sum_counts(c) for name, c in legs.items()}
    if counted:
        # every height's prepare extends once and its process hits the
        # device's content cache; the rebuild extends once; the byzantine
        # height extends the bad square and, at the first honest
        # validator's process, the canonical one, which the next proposer's
        # prepare and every later process hit; the catch-up is one batch
        want = {"produce": block_launches(len(sizes)),
                "network": block_launches(net_heights + 1),
                "join": block_launches(1, batched=True)}
        for name, w in want.items():
            check(out["launches"][name] == w, f"devnet {name} launches "
                  f"{out['launches'][name]} != {w}")
        rebuild = out["launches"]["rebuild"]
        check({n: rebuild[n] for n in EXTEND_KERNELS} == {
            n: c for n, c in block_launches(1).items() if n in EXTEND_KERNELS},
            f"the rebuild's extension launches {rebuild}")
    return out


SERVICE_CHAIN = "chip-smoke-service-1"
# phase 4i's heights: (GovMaxSquareSize, how the height is observed): "traced"
# with tracing on and devprof collecting; "first" traced too, a size's first
# height, which takes its first allocations; "untraced" with both off, three
# of them alternating with three traced heights at k = 128 (the cost of
# tracing, median against median); "profiled" traced under a torch.profiler
# capture
SERVICE_PLAN = ((64, "first"), (64, "traced"), (64, "traced"),
                (128, "first"), (128, "untraced"), (128, "traced"), (128, "untraced"),
                (128, "traced"), (128, "untraced"), (128, "traced"), (128, "profiled"))


def service_remote(service):
    """A RemoteNode whose transport is ``service``'s handlers: the request
    bytes RemoteNode sends go to the handler its RPC names, in process
    (``NodeService``'s methods are the snake_case of the RPCs)."""
    from celestia_tpu_torch.node.remote import RemoteNode
    from celestia_tpu_torch.utils.telemetry import snake_case

    class ServiceRemote(RemoteNode):
        def __init__(self):
            self.address, self.timeout_s, self._methods = "in-process", 120.0, {}
            self.chain_id = self.status()["chain_id"]

        def _call(self, method, payload):
            return getattr(service, snake_case(method))(payload, None)

        def _call_stream(self, method, payload):
            yield from getattr(service, snake_case(method))(payload, None)

    return ServiceRemote()


def cli_run(home: str, *argv: str) -> str:
    """``python -m celestia_tpu_torch.cli --home home argv...`` from the
    checkout's root; raises unless it exits 0; its standard output."""
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", home, *argv],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0, f"cli {' '.join(argv)} exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout


def cli_in_process(home: str, *argv: str) -> str:
    """A client command through the CLI's ``main`` in this process (its
    standard output); raises unless it returns 0.  A client command reads no
    device switch: its own process would add only imports (seconds each),
    and the node's boundary is the same gRPC."""
    import io

    from celestia_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--home", home, *argv])
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}")
    return out.getvalue()


def cli_node(home: str, dev) -> dict:
    """``cli start`` on ``dev`` as a subprocess (the card unless ``dev`` is
    the CPU, then under ``CELESTIA_TPU_TORCH_DEVICE=cpu``) serving gRPC on
    127.0.0.1; ``cli tx pay-for-blob`` from the home's key, ``cli query
    block`` and ``cli query share-proof`` over the blob's block, the proof
    verified against its data root, ``cli query das-sample`` of 16 cells
    verified; then SIGTERM, and the node must exit 0.  The client commands
    run through :func:`cli_in_process`.  Returns the walls (s) of the boot
    and of the client commands."""
    import os
    import select
    import signal
    import socket
    from pathlib import Path

    import torch

    from celestia_tpu_torch.da.proof import ShareInclusionProof

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % sock.getsockname()[1]
    env = dict(os.environ)
    env.pop("CELESTIA_TPU_TORCH_DEVICE", None)
    if torch.device(dev).type == "cpu":
        env["CELESTIA_TPU_TORCH_DEVICE"] = "cpu"
    walls = {}
    t0 = time.perf_counter()
    with open(os.path.join(home, "start.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", home, "start",
             "--grpc-address", addr, "--block-interval", "0.2"],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=log, text=True,
            env=env,
        )
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 300)
            check(bool(ready), "cli start printed no address within 300 s")
            started = json.loads(proc.stdout.readline())
            check(started["grpc"] == addr, f"cli start serves {started}, not {addr}")
            walls["boot"] = time.perf_counter() - t0
            for name, argv in (
                ("pay_for_blob", ("tx", "--node", addr, "--from", "alice", "pay-for-blob",
                                  "c1105e0000", (b"chip-smoke" * 300).hex())),
            ):
                t1 = time.perf_counter()
                tx = json.loads(cli_in_process(home, *argv))
                walls[name] = time.perf_counter() - t1
            check(tx["code"] == 0 and tx["height"] > 0, f"cli tx pay-for-blob: {tx}")
            t1 = time.perf_counter()
            blk = json.loads(cli_in_process(home, "query", "--node", addr, "block",
                                            str(tx["height"])))
            got = json.loads(cli_in_process(home, "query", "--node", addr, "share-proof",
                                            str(tx["height"]), "0", "2"))
            check(ShareInclusionProof.from_dict(got["proof"]).verify(
                bytes.fromhex(blk["data_root"])), "cli query share-proof does not verify")
            sampled = json.loads(cli_in_process(home, "query", "--node", addr, "das-sample",
                                                str(tx["height"]), "--samples", "16"))
            walls["queries"] = time.perf_counter() - t1
            check(sampled["available"] and sampled["verified"] == 16 and not sampled["failed"],
                  f"cli query das-sample: {sampled}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 0, f"cli start exited {rc} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    return walls


def service_phase(dev, seed: int) -> dict:
    """Phase 4i, the node as users start it (node/server.py, node/remote.py,
    utils/devprof.py, cli.py).

    ``NodeService(TestNode(device=dev))`` with tracing on and devprof
    collecting runs the heights of ``SERVICE_PLAN``: each height's seeded
    PayForBlobs and two sends are signed by the port's Signer over a
    RemoteNode whose transport is the service's handlers (so the service's
    ``broadcast`` handler takes the wire bytes RemoteNode sends), then
    ``produce_block`` cuts the block; its data root equals the plain path's.
    Each height answers a ``das_sample_batch`` of DEVNET_CELLS cells, a share
    proof and a tx proof through the service's handlers, each verified
    against the data root.  The metrics exposition is fetched over HTTP from
    ``_MetricsHTTPServer`` on 127.0.0.1 with ``/healthz``; the TraceDump
    document is validated and must hold ``device.extend_levels`` spans on a
    ``device:<dev>`` track under ``extend.device_plane``.  Devprof's
    occupancy probe gives the device's busy share of each ``produce_block``
    wall; three untraced k = 128 heights, each between two traced ones,
    price tracing; one traced height runs under a ``torch.profiler``
    capture.  Then the CLI as subprocesses:
    ``keys add``, ``init --fund-keyring``, ``validate-genesis``, and
    :func:`cli_node` (``start`` serving gRPC, a client's PayForBlob and a
    verified share proof, SIGTERM).

    ``dev`` is a card: the dispatch counts are held to the launch counters
    (``extend_levels`` one per traced height's cold extension,
    ``das_proof_gather`` one per K7b launch of the DAS calls) and the
    produce legs' launches to ``block_launches``."""
    import re
    import tempfile
    import urllib.request

    import torch

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client.signer import Signer, SubmitResult
    from celestia_tpu_torch.da import dah, das, proof
    from celestia_tpu_torch.da.square import construct
    from celestia_tpu_torch.node.server import NodeService, _MetricsHTTPServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.parallel import mesh as provider
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils import devprof, tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    class BroadcastOnly(Signer):
        """The port's Signer without its confirmation poll: the phase cuts
        the blocks itself."""

        def confirm_tx(self, tx_hash, **kw):
            return SubmitResult(0, "", tx_hash)

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    keys = [PrivateKey.from_seed(b"chip-smoke-service-%d" % i)
            for i in range(APP_PFBS * len(SERVICE_PLAN))]
    senders = [PrivateKey.from_seed(b"chip-smoke-service-send-%d" % i) for i in range(2)]
    validator = PrivateKey.from_seed(b"chip-smoke-service-validator")
    funded = [(k, 10**13) for k in keys + senders]
    genesis = {
        "chain_id": SERVICE_CHAIN, "genesis_time_ns": APP_GENESIS_NS, "codec": "leopard-ff8",
        "accounts": [{"address": k.public_key().address().hex(), "balance": b} for k, b in funded],
        "validators": [{"address": validator.public_key().address().hex(),
                        "self_delegation": 10**9}],
        "params": {"blob": {"GovMaxSquareSize": max(k for k, _ in SERVICE_PLAN)}},
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"produce_ms": {}, "height_ms": [], "prepare": {}, "query_ms": {}, "busy_pct": [],
           "launches": []}
    served_dispatches = k7b_launches = 0
    blocks = []
    provider.configure("off")
    node = TestNode(chain_id=SERVICE_CHAIN, genesis=genesis, validator_key=validator,
                    device=dev, auto_produce=False)
    svc = NodeService(node)
    remote = service_remote(svc)
    http = _MetricsHTTPServer(svc, "127.0.0.1", 0)
    http.start()
    tracing.enable()
    devprof.reset()
    try:
        senders_ = [BroadcastOnly(remote, k) for k in senders]
        for i, (k, mode) in enumerate(SERVICE_PLAN):
            if node.app.blob.gov_max_square_size() != k:
                node.app.params.set("blob", "GovMaxSquareSize", k)
            for key, blobs in zip(keys[i * APP_PFBS:(i + 1) * APP_PFBS],
                                  pfb_blobs(rng, k, APP_PFBS)):
                res = BroadcastOnly(remote, key).submit_pay_for_blob(list(blobs))
                check(res.code == 0, f"a PayForBlobs was refused by the service: {res.log}")
            for s in senders_:
                res = s.submit_tx([MsgSend(s.address, rng.bytes(20), int(rng.integers(1, 10**4)))])
                check(res.code == 0, f"a send was refused by the service: {res.log}")
            if mode == "untraced":
                tracing.disable()
            if mode == "profiled":
                profile_dir = tempfile.mkdtemp(prefix="chip-smoke-profile-")
                devprof.start_profiler(profile_dir)
            c0 = kernels.launch_counts()
            sync()
            devprof.occupancy_probe()
            t0 = time.perf_counter()
            blk = node.produce_block()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            busy = devprof.occupancy_probe()
            launches = {n: c - c0[n] for n, c in kernels.launch_counts().items()}
            if mode == "profiled":
                trace_path = devprof.stop_profiler()
            if mode == "untraced":
                tracing.enable()
            else:
                out["busy_pct"].append(busy)
            out["launches"].append(launches)
            out["produce_ms"].setdefault(f"{k} {mode}", []).append(ms)
            out["height_ms"].append(ms)
            out["prepare"].setdefault(k, []).append(dict(node.app.last_prepare_breakdown))
            h, root = blk.header.height, blk.header.data_hash
            check(blk.header.square_size == k, f"height {h} filled to {blk.header.square_size}")
            blocks.append(blk)
            # the queries, through the service's handlers as RemoteNode sends them
            cells = [(int(r), int(c)) for r, c in rng.integers(0, 2 * k, (DEVNET_CELLS, 2))]
            before = devprof.device_profile()["dispatches"].get("das_proof_gather", 0)
            k7b0 = kernels.launch_counts()["das_proof_gather"]
            t0 = time.perf_counter()
            ans = remote.das_sample_batch(h, cells)
            out["query_ms"].setdefault("das_sample_batch", []).append(
                (time.perf_counter() - t0) * 1e3)
            served_dispatches += devprof.device_profile()["dispatches"].get(
                "das_proof_gather", 0) - before
            k7b_launches += kernels.launch_counts()["das_proof_gather"] - k7b0
            check(len(ans["proofs"]) == DEVNET_CELLS and all(
                das.SampleProof.from_dict(p).verify(root) for p in ans["proofs"]),
                f"a DAS proof served by the service does not verify at height {h}")
            start = k * int(rng.integers(0, k - 1)) + k - 4
            for name, path, args in (
                ("proof/share", "custom/proof/share", {"height": h, "start": start,
                                                       "end": start + 8}),
                ("proof/tx", "custom/proof/tx", {"height": h, "tx_index": len(blk.txs) - 1}),
            ):
                t0 = time.perf_counter()
                got = remote.abci_query(path, args)
                out["query_ms"].setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                check(proof.ShareInclusionProof.from_dict(got["proof"]).verify(root),
                      f"a {name} answer served by the service does not verify at height {h}")
        # --- HTTP: healthz and the exposition --------------------------------
        base = f"http://{http.address}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok", f"/healthz: {health}")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            exposition = r.read().decode()
        metrics = {}
        for line in exposition.splitlines():
            m = re.match(r"^([a-z_]+)(\{[^}]*\})? (\S+)$", line)
            if m:
                metrics[m.group(1) + (m.group(2) or "")] = float(m.group(3))
        traced = sum(mode != "untraced" for _, mode in SERVICE_PLAN)
        want = {"extend_levels": traced, "das_proof_gather": k7b_launches}
        for name, n in want.items():
            got = metrics.get(f"celestia_tpu_span_device_{name}_seconds_count", 0)
            check(got == n, f"the exposition counts {got} {name} dispatches, predicted {n}")
        check(served_dispatches == want["das_proof_gather"],
              f"das_proof_gather dispatches {served_dispatches} != K7b launches {k7b_launches}")
        key = f"{dev.type}:{dev.index or 0}"
        check(metrics.get(f'celestia_tpu_device_busy_ms{{device="{key}"}}', 0) > 0,
              "no device busy time in the exposition")
        if dev.type == "cuda":
            for gauge in ("celestia_tpu_device_mem_bytes_in_use",
                          "celestia_tpu_device_mem_peak_bytes"):
                check(metrics.get(gauge, 0) > 0, f"{gauge} is not > 0")
        profile = devprof.device_profile()
        for name in profile["dispatches"]:
            check(f'celestia_tpu_kernel_bytes{{kernel="{name}"}}' in metrics,
                  f"no cost-table row for dispatch {name}")
        # --- the trace -------------------------------------------------------
        doc = json.loads(svc.trace_dump(b"{}", None))["trace"]
        problems = tracing.validate_chrome_trace(doc)
        check(not problems, f"the TraceDump document is invalid: {problems[:5]}")
        events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        by_id = {e["args"].get("span_id"): e for e in events if "span_id" in e.get("args", {})}
        track = {e["tid"] for e in doc["traceEvents"] if e.get("ph") == "M"
                 and e.get("args", {}).get("name") == f"device:{key}"}
        device_spans = [e for e in events if e["name"] == "device.extend_levels"]
        check(track and device_spans and all(e["tid"] in track for e in device_spans),
              f"no device.extend_levels spans on a device:{key} track")
        check(all(by_id.get(e["args"].get("parent_id"), {}).get("name") == "extend.device_plane"
                  for e in device_spans),
              "a device.extend_levels span is not a child of extend.device_plane")
        out["trace"] = {"events": len(doc["traceEvents"]), "device_spans": len(device_spans)}
        out["exposition_lines"] = len(exposition.splitlines())
        out["cost_table"] = profile["kernels"]
        out["transfers"] = devprof.transfer_accounting()
        out["dispatches"] = profile["dispatches"]
        out["mem"] = profile["mem"]
    finally:
        http.stop()
        tracing.disable()
        provider.configure(None)
    # the plain path's data roots, outside the traced window
    for blk in blocks:
        square, _, _ = construct(blk.txs, blk.header.square_size)
        check(dah.extend_block(square, device="cpu")[1].hash == blk.header.data_hash,
              f"the served node's data root at height {blk.header.height} != the plain path's")
    # --- the torch.profiler capture ------------------------------------------
    with open(trace_path) as f:
        captured = json.load(f)
    kernels_us = {}
    for e in captured.get("traceEvents", []):
        if e.get("cat") == "kernel":
            kernels_us[e["name"]] = kernels_us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    out["profiler_kernels_ms"] = {n: us / 1e3 for n, us in sorted(kernels_us.items())}
    # --- the CLI as subprocesses -----------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as home:
        cli_run(home, "keys", "add", "alice")
        cli_run(home, "init", "--chain-id", "chip-smoke-cli-1", "--fund-keyring", "1000000000")
        cli_run(home, "validate-genesis")
        out["cli"] = cli_node(home, dev)
    out["cli_s"] = time.perf_counter() - t0
    # tracing's cost with the walls' drift over the heights taken out: each
    # untraced height between two traced ones of its size against their mean
    walls = out["height_ms"]
    out["tracing_cost_ms"] = [
        (walls[i - 1] + walls[i + 1]) / 2 - walls[i]
        for i, (k, mode) in enumerate(SERVICE_PLAN[1:-1], 1)
        if mode == "untraced" and SERVICE_PLAN[i - 1] == SERVICE_PLAN[i + 1] == (k, "traced")
    ]
    for (k, mode), launches in zip(SERVICE_PLAN, out["launches"]):
        check(launches == block_launches(1), f"the {mode} height at k={k} launched "
              f"{launches}, predicted {block_launches(1)}")
    return out


NET_CHAIN = "chip-smoke-mesh-1"
NET_VALIDATORS = 4
NET_FILLED_HEIGHTS = 4  # heights whose square is the mesh's GovMaxSquareSize
NET_STOP_AFTER, NET_RESTART_AFTER = 2, 4  # validator 3 is down between these heights
NET_BLOCK_GAP_S = 0.2  # cli start --block-interval: the gap before the next height
# one PayForBlobs a filled height, its blobs 30 % of a k x k square's shares:
# above a quarter, so the block's square is k, and its proposal (the txs as
# hex in JSON) stays under gRPC's 4 MiB receive limit at k = 64
NET_FILL = 0.3
NET_VERIFY_CELLS = 1024  # the swarm's served cells verified against the data roots
COORD_VALIDATORS, COORD_HEIGHTS = 3, 2
# the relay leg: heights a cli bft-relay drives before it is killed, its
# block interval (the wait in which it is killed), and the heights the mesh
# then commits on its own (one of them filled)
RELAY_HEIGHTS, RELAY_GAP_S, RELAY_MESH_HEIGHTS = 2, 1.0, 3


def mesh_blobs(rng, k: int) -> list:
    """The blobs (1-3) of one PayForBlobs that alone take NET_FILL of a
    k x k square."""
    from celestia_tpu_torch.da.blob import Blob
    from celestia_tpu_torch.da.namespace import Namespace

    n = int(rng.integers(1, 4))
    total = int(NET_FILL * k * k * 478)
    return [Blob(Namespace.v0(b"\x01" + rng.bytes(9)), rng.bytes(total // n)) for _ in range(n)]


class Gossiped:
    """A Signer's node for a ProcessCoordinator's validators: queries go to
    ``remote``, a broadcast to every validator (``coord.gossip_tx``)."""

    def __init__(self, coord, remote):
        self.coord, self.remote = coord, remote

    def __getattr__(self, name):
        return getattr(self.remote, name)

    def broadcast_tx(self, raw: bytes):
        from celestia_tpu_torch.client.signer import SubmitResult

        return self.coord.gossip_tx(raw) or SubmitResult(0, "", hashlib.sha256(raw).digest())


def log_tail(path, n: int = 12) -> str:
    try:
        return "\n".join(open(path, errors="replace").read().splitlines()[-n:])
    except OSError as e:
        return f"({e})"


COUNTERS = {  # node_counts' keys: the telemetry counters they read
    "rebuilt": "celestia_tpu_block_artifacts_rebuilt_total",
    "validated": "celestia_tpu_bft_proposals_validated_total",
    "adopted": "celestia_tpu_bft_blocks_adopted_total",
}


def node_counts(text: str) -> dict:
    """From a node's Metrics exposition: its kernel launches, the build
    wall, the cold extensions its App made (the content cache's misses, all
    legs), the blocks it rebuilt for serving, the DAS chunks it streamed
    (its per-lane sample latency histograms' counts), the BFT proposals it
    validated, and the decided blocks it adopted on their certificates and
    the height of the last."""
    from celestia_tpu_torch import tools
    from celestia_tpu_torch.node import cluster

    # launches, misses, rebuilt and chunks as the tool twins read them
    out = {"build_seconds": None, "adopted_height": 0, **dict.fromkeys(COUNTERS, 0),
           **tools.exposition_counts(text)}
    names = {metric: key for key, metric in COUNTERS.items()}
    for name, labels, value in cluster.parse_exposition(text):
        if name == "celestia_tpu_kernel_build_seconds":
            out["build_seconds"] = value
        elif name in names:
            out[names[name]] = int(value)
        elif name == "celestia_tpu_bft_adopted_height":
            out["adopted_height"] = int(value)
    return out


def window(a: dict, b: dict) -> dict:
    """What a node did between two readings ``a`` and ``b``: the heights,
    the launches of every kernel and the differences of its counters."""
    from celestia_tpu_torch import kernels

    return {"heights": [a["height"], b["height"]],
            "launches": {n: b["launches"].get(n, 0) - a["launches"].get(n, 0)
                         for n in kernels.KERNELS},
            **{key: b[key] - a[key] for key in ("misses", "chunks", *COUNTERS)}}


def window_bounds(w: dict, new: int) -> list:
    """The cold extensions a window of a mesh validator can hold, given
    ``new`` block contents new to it among the window's heights: each
    such content once, less one for each block it adopted on its
    certificate (finalized, never extended), and at most one more for
    each proposal it validated that did not decide (a round that timed
    out, whose proposer's mempool may have held other txs).  A node
    validates one proposal a height it decides live, give or take the
    next height's at each end of the window."""
    live = w["heights"][1] - w["heights"][0] - w["adopted"]
    return [new - w["adopted"], new + max(0, w["validated"] - live + 1)]


def window_prediction(w: dict) -> dict:
    """The launches a window of a node should hold: one extension (K5
    twice, K2, K3, K4) for each cold extension and each rebuilt block, and
    one K7b gather for each DAS chunk it streamed."""
    want = block_launches(w["misses"] + w["rebuilt"])
    want["das_proof_gather"] = w["chunks"]
    return want


def network_phase(dev, k: int, seed: int) -> dict:
    """Phase 4j, the network stack on ``dev`` (node/gossip.py,
    node/coordinator.py, node/cluster.py, client/swarm.py, txsim's
    ``run_remote`` and the CLI commands that reach them).

    A gossip mesh of NET_VALIDATORS ``cli start --bft-valset --peers``
    processes on ``dev`` (the card unless ``dev`` is the CPU, then under
    ``CELESTIA_TPU_TORCH_DEVICE=cpu``), each told one seed's address, with a
    shared genesis at GovMaxSquareSize ``k`` and ``k`` among its warm
    squares; tracing on in each.  A Signer in this process sends, at each
    of NET_FILLED_HEIGHTS heights, one seeded PayForBlobs that fills the
    square to ``k`` and two sends, each to ONE validator (want/have gossip
    carries the rest); validator 3 is stopped with SIGTERM (exit 0) after
    filled height NET_STOP_AFTER and restarted from its home after
    NET_RESTART_AFTER: it catches up through the certificate-verified
    catch-up (``bft_catchup_batch``, block by block without a mesh) and
    lands on the mesh's app hash.  Then over the mesh: ``cli query
    cluster-health`` (4 peers, one height and app hash), ``cli query
    cluster-trace`` (a valid merged document, one Chrome process a node,
    cross-node flow links) and ``cli txsim --blob 2 --send 1`` (every tx
    succeeded).  Every process reports the same data root and app hash at
    every height, and each data root equals the plain path's
    (``device="cpu"``) on the decided block's txs.  Last ``swarm.run_swarm``
    with ``SwarmConfig()``'s defaults against one node, whose served cells
    (up to NET_VERIFY_CELLS) verify against their data roots.

    Each process's launches are read from its Metrics exposition, each
    reading at one height (``snapshot``): after warm-up at a baseline once
    the mesh runs and before any tx (a restarted validator: as soon as it
    is ready), and again at the end of each window.  In every window the
    launches are exactly one extension (5 launches) for each cold
    extension the node's App made and each block it rebuilt for serving,
    and one K7b gather for each DAS chunk it streamed; and the cold
    extensions are exactly the block contents new to that process among
    the heights of the window (an empty block repeats one square, which a
    process extends once).

    Then a ``cli bft-relay`` drives an in-process mesh of NET_VALIDATORS
    ``TestNode(device=dev)`` BFT validators behind ``NodeServer``s for
    RELAY_HEIGHTS heights (their ``GossipEngine``s not started: an engine
    drains the outboxes a relay forwards) and is killed mid-run; the
    engines start, a filled PayForBlobs sent to one validator commits and
    the mesh goes on for RELAY_MESH_HEIGHTS heights on one app hash and the
    plain path's data roots.  Last, a ``ProcessCoordinator`` in this process
    over COORD_VALIDATORS ``NodeServer``s of ``TestNode(device=dev)`` for
    COORD_HEIGHTS heights filled to ``k``: data roots equal to the plain
    path's, one app hash.  In both legs the launches are counted here (0
    just before) and equal one extension for each block content (the
    validators of one process share the device's content cache).

    Returns the walls, the swarm's report and the launch windows."""
    import os
    import select
    import signal
    import socket
    import tempfile
    from pathlib import Path

    import torch

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client import swarm
    from celestia_tpu_torch.client.signer import Signer, SubmitResult
    from celestia_tpu_torch.da import dah, das, eds_cache
    from celestia_tpu_torch.da.square import construct
    from celestia_tpu_torch.node.bft import BlockPayload
    from celestia_tpu_torch.node.coordinator import PeerValidator, ProcessCoordinator
    from celestia_tpu_torch.node.gossip import GossipEngine
    from celestia_tpu_torch.node.remote import RemoteNode
    from celestia_tpu_torch.node.server import NodeServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils import tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    class BroadcastOnly(Signer):
        def confirm_tx(self, tx_hash, **kw):
            return SubmitResult(0, "", tx_hash)

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    root = Path(__file__).resolve().parent
    base = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-"))
    vals = [PrivateKey.from_seed(b"chip-smoke-mesh-val-%d" % i) for i in range(NET_VALIDATORS)]
    users = [PrivateKey.from_seed(b"chip-smoke-mesh-user-%d" % i)
             for i in range(NET_FILLED_HEIGHTS + 1 + COORD_HEIGHTS)]
    senders = [PrivateKey.from_seed(b"chip-smoke-mesh-send-%d" % i) for i in range(2)]
    alice = PrivateKey.from_seed(b"chip-smoke-mesh-alice")
    genesis = {
        "chain_id": NET_CHAIN, "genesis_time_ns": APP_GENESIS_NS,
        "accounts": [{"address": p.public_key().address().hex(), "balance": 10**13}
                     for p in vals + users + senders + [alice]],
        "validators": [{"address": v.public_key().address().hex(), "self_delegation": 10**8}
                       for v in vals],
        "params": {"blob": {"GovMaxSquareSize": k}},
    }
    valset = [{"address": v.public_key().address().hex(),
               "pubkey": v.public_key().compressed().hex(), "power": 100} for v in vals]
    (base / "genesis.json").write_text(json.dumps(genesis))
    (base / "valset.json").write_text(json.dumps(valset))
    client_home = base / "client"
    (client_home / "keyring").mkdir(parents=True)
    (client_home / "keyring" / "alice.json").write_text(json.dumps(
        {"priv": f"{alice.d:064x}", "address": alice.public_key().address().hex()}))
    for i, v in enumerate(vals):
        home = base / f"val{i}"
        cli_in_process(str(home), "init", "--chain-id", NET_CHAIN, "--genesis",
                       str(base / "genesis.json"))
        (home / "config" / "priv_validator_key.json").write_text(
            json.dumps({"priv_key": f"{v.d:064x}"}))
    socks = [socket.socket() for _ in vals]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    addrs = ["127.0.0.1:%d" % s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    warm = sorted({1, 2, 4, k})
    env = dict(os.environ)
    env.pop("CELESTIA_TPU_TORCH_DEVICE", None)
    if dev.type == "cpu":
        env["CELESTIA_TPU_TORCH_DEVICE"] = "cpu"

    def spawn(i: int):
        argv = [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", str(base / f"val{i}"),
                "start", "--bft-valset", str(base / "valset.json"), "--grpc-address", addrs[i],
                "--peers", addrs[1] if i == 0 else addrs[0],
                "--block-interval", str(NET_BLOCK_GAP_S), "--warm-squares",
                ",".join(map(str, warm)), "--timeseries-interval", "0"]
        log = open(base / f"val{i}.log", "a")
        proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE, stderr=log, text=True,
                                env={**env, "CELESTIA_TPU_TORCH_TRACE": "1",
                                     "CELESTIA_TPU_TORCH_NODE_ID": f"val-{i}",
                                     "PYTHONFAULTHANDLER": "1"})
        log.close()
        return proc

    def stop(i: int, proc) -> None:
        """SIGTERM, which must end the process with 0 within 60 s; past
        that its threads' stacks are dumped into its log (SIGABRT under
        PYTHONFAULTHANDLER) and the check fails with the log's end."""
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)
            proc.wait(timeout=60)
            check(False, f"mesh validator {i} did not exit within 60 s of SIGTERM; its log "
                  "ends:\n" + log_tail(base / f"val{i}.log", 120))
        check(rc == 0, f"mesh validator {i} exited {rc} on SIGTERM; its log ends:\n"
              + log_tail(base / f"val{i}.log"))

    def ready(procs: dict, t0: float) -> dict:
        """Each process's boot wall (s) to the address line it prints."""
        boot = {}
        for i, proc in procs.items():
            left = max(1.0, 300 - (time.perf_counter() - t0))
            got, _, _ = select.select([proc.stdout], [], [], left)
            line = proc.stdout.readline() if got else ""
            check(line.startswith("{") and json.loads(line)["grpc"] == addrs[i],
                  f"mesh validator {i} started as {line!r}; its log ends:\n"
                  + log_tail(base / f"val{i}.log"))
            boot[i] = time.perf_counter() - t0
        return boot

    def mesh_state() -> str:
        """Each live validator's height, gossip stats and the failures its
        tracer noted, and the end of its log: what a timeout reports."""
        lines = []
        for i, r in sorted(remotes.items()):
            try:
                st = r.status()
                notes = [(e["args"].get("point"), e["args"].get("error"))
                         for e in r.trace_dump()["trace"].get("traceEvents", [])
                         if e.get("name") == "fault.note"][-6:]
                lines.append(f"validator {i}: height {st['height']}, gossip {st.get('gossip')}, "
                             f"noted {notes}")
            except Exception as e:  # noqa: BLE001 — a diagnostic, best effort
                lines.append(f"validator {i}: {e!r}"[:300])
            lines.append(log_tail(base / f"val{i}.log", 8))
        return "\n".join(lines)

    def wait_for(what: str, cond, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                got = cond()
            except Exception:  # a node restarting or busy: ask again
                got = None
            if got:
                return got
            if time.monotonic() >= deadline:
                check(False, f"timed out after {timeout} s waiting for {what}:\n"
                      + mesh_state())
            time.sleep(0.05)

    def heights(idx) -> list:
        return [remotes[i].height for i in idx]

    def snapshot(i: int) -> dict:
        """Validator i's counts (``node_counts``) at one height: its
        height, its Metrics exposition, and its height again, until a
        block did not commit in between."""
        for _ in range(100):
            h = remotes[i].height
            got = node_counts(remotes[i].metrics())
            if remotes[i].height == h:
                return dict(got, height=h)
        check(False, f"validator {i} committed a block across each of 100 readings")

    out = {"filled": [], "commit_ms": []}
    procs, remotes = {}, {}
    t_mesh = time.perf_counter()
    try:
        # --- the mesh boots --------------------------------------------------
        t0 = time.perf_counter()
        procs = {i: spawn(i) for i in range(NET_VALIDATORS)}
        out["boot_s"] = ready(procs, t0)
        remotes = {i: RemoteNode(a, timeout_s=60.0) for i, a in enumerate(addrs)}
        wait_for("the mesh's first heights", lambda: min(heights(remotes)) >= 3)
        # PEX: each validator, told one seed, learns every other one
        wait_for("PEX to give each validator every peer", lambda: all(
            remotes[i].status()["gossip"]["peers"] >= NET_VALIDATORS - 1 for i in remotes))
        # the baselines: every process warmed up and past its first (empty)
        # block, no tx sent yet
        first = {i: snapshot(i) for i in remotes}
        send_signers = [BroadcastOnly(remotes[1], s) for s in senders]
        live = list(range(NET_VALIDATORS))
        for j in range(NET_FILLED_HEIGHTS):
            # --- one filled height: each tx to one validator -------------------
            to = live[j % len(live)]
            t1 = time.perf_counter()
            res = BroadcastOnly(remotes[to], users[j]).submit_pay_for_blob(mesh_blobs(rng, k))
            check(res.code == 0, f"the mesh refused a PayForBlobs: {res.log}")
            txs = [res.tx_hash]
            for s in send_signers:
                sent = s.submit_tx([MsgSend(s.address, rng.bytes(20), int(rng.integers(1, 10**4)))])
                check(sent.code == 0, f"the mesh refused a send: {sent.log}")
                txs.append(sent.tx_hash)
            def committed():
                infos = [remotes[i].get_tx(h) for h in txs for i in live]
                return infos[:len(live)] if all(infos) else None

            landed = wait_for(f"filled height {j + 1} on every live validator", committed)
            out["commit_ms"].append((time.perf_counter() - t1) * 1e3)
            h = landed[0]["height"]
            check(all(info["height"] == h and info["code"] == 0 for info in landed),
                  f"the filled height's PayForBlobs landed as {landed}")
            blk = remotes[live[0]].block(h)
            check(blk["square_size"] == k, f"filled height {h} has a k={blk['square_size']} square")
            out["filled"].append(h)
            if j + 1 == NET_STOP_AFTER:
                stopped = snapshot(3)
                stop(3, procs[3])
                procs[3].stdout.close()
                remotes.pop(3).close()
                live = [0, 1, 2]
                out["stopped_at"] = stopped["height"]
        check(min(heights(live)) >= out["stopped_at"] + 2,
              "the mesh did not commit past the stopped validator")
        # --- validator 3 restarts from its home and catches up --------------------
        t0 = time.perf_counter()
        procs[3] = spawn(3)
        out["restart_boot_s"] = ready({3: procs[3]}, t0)[3]
        remotes[3] = RemoteNode(addrs[3], timeout_s=60.0)
        restarted = snapshot(3)
        t1 = time.perf_counter()
        target = max(heights(live))
        wait_for("validator 3's catch-up", lambda: remotes[3].height >= target, timeout=300)
        out["catchup_s"] = time.perf_counter() - t1
        out["caught_up_heights"] = target - out["stopped_at"]
        check(remotes[3].block(target)["app_hash"] == remotes[0].block(target)["app_hash"],
              f"validator 3 caught up to another app hash at height {target}")
        out["mesh_s"] = time.perf_counter() - t_mesh
        t_idle, h_idle = time.perf_counter(), min(heights(remotes))
        # --- cluster observability over the mesh ----------------------------------------
        nodes_arg = ",".join(addrs)
        def level_health():
            got = json.loads(cli_in_process(str(client_home), "query", "--node", addrs[0],
                                            "cluster-health", "--nodes", nodes_arg))
            return got if got["height_spread"] == 0 else None

        health = wait_for("one height on every peer", level_health)
        check(health["reachable"] == NET_VALIDATORS and health["app_hash_agree"] is True,
              f"cluster-health: {health['reachable']} reachable, agree {health['app_hash_agree']}")
        out["health"] = {key: health[key] for key in ("reachable", "max_height", "app_hash_agree",
                                                       "breakers_open", "fault_notes")}
        trace_path = base / "cluster.trace.json"
        got = json.loads(cli_in_process(str(client_home), "query", "--node", addrs[0],
                                        "cluster-trace", "--nodes", nodes_arg, "--out",
                                        str(trace_path)))
        doc = json.loads(trace_path.read_text())
        check(not tracing.validate_chrome_trace(doc), "cluster-trace wrote an invalid document")
        pids = {e["pid"] for e in doc["traceEvents"] if e.get("name") == "process_name"}
        check(len(pids) == NET_VALIDATORS and got["cross_node_flows"] >= 1,
              f"cluster-trace: {len(pids)} processes, {got['cross_node_flows']} flows")
        out["trace"] = {"events": got["events"], "cross_node_flows": got["cross_node_flows"]}
        # --- remote txsim ---------------------------------------------------------------
        t1 = time.perf_counter()
        rep = json.loads(cli_in_process(str(client_home), "txsim", "--node", addrs[1], "--from",
                                        "alice", "--blob", "2", "--send", "1", "--iterations",
                                        "2"))
        check(rep["succeeded"] == rep["submitted"] > 0, f"cli txsim: {rep}")
        out["txsim"] = dict(rep, seconds=time.perf_counter() - t1)
        # every tx has committed: the windows close here
        last = {i: snapshot(i) for i in remotes}
        out["heights_at_read"] = {i: last[i]["height"] for i in remotes}
        # the mesh's own pace while the observability and txsim legs ran
        # beside it: its inverse, ms a height
        out["idle_ms_per_height"] = 1e3 * (time.perf_counter() - t_idle) / max(
            1, min(out["heights_at_read"].values()) - h_idle)
        # --- one chain on every process, every data root the plain path's ----------
        top = max(out["heights_at_read"].values())
        roots, empty = {}, {}
        for h in range(2, top + 1):
            blks = [remotes[i].block(h) for i in remotes if out["heights_at_read"][i] >= h]
            check(len({(b["data_root"], b["app_hash"]) for b in blks}) == 1,
                  f"the mesh's processes differ at height {h}: {blks}")
            wire = remotes[0].bft_decided(h)
            check(wire is not None, f"no decided block served at height {h}")
            payload = BlockPayload.from_wire(wire["payload"])
            square, _, _ = construct(list(payload.txs), payload.square_size)
            check(dah.extend_block(square, device="cpu")[1].hash.hex() == blks[0]["data_root"]
                  == payload.data_root.hex(), f"the mesh's data root at height {h} != the plain "
                  "path's")
            roots[h], empty[h] = blks[0]["data_root"], not payload.txs
        out["heights"] = top
        check(len({roots[h] for h in roots if empty[h]}) == 1,
              "the mesh's empty blocks differ in data root")

        def contents(lo: int, hi: int, seen=()) -> int:
            """Block contents among heights (lo, hi] that are not ``seen``."""
            return len({roots[h] for h in range(lo + 1, hi + 1)} - set(seen))

        # --- the DAS swarm against one node ------------------------------------------
        roots_bytes = {h: bytes.fromhex(roots[h]) for h in out["filled"]}
        answers = []
        report = swarm.run_swarm(addrs[2], [(h, k) for h in out["filled"]], swarm.SwarmConfig(),
                                 on_served=lambda h, coords, ans: answers.append((h, coords, ans)))
        swarmed = snapshot(2)
        check(report["rounds_run"] == 3 and not report["deadline_hit"], f"swarm: {report}")
        cells = [(h, set(coords), p) for h, coords, ans in answers for p in ans["proofs"]]
        step = max(1, len(cells) // NET_VERIFY_CELLS)
        verified = 0
        for h, coords, p in cells[::step]:
            proof = das.SampleProof.from_dict(p)
            check((proof.row, proof.col) in coords and proof.verify(roots_bytes[h]),
                  f"a cell the swarm was served at height {h} does not verify")
            verified += 1
        check(verified >= 64, f"only {verified} served cells verified")
        # --- each process's windows ------------------------------------------------------
        # a process extends the empty block's square once, before its
        # baseline (validator 3 restarted: after its restart, with a new
        # content cache), and every other content once
        empty_root = [roots[h] for h in roots if empty[h]][:1]
        windows = {f"validator {i}": (window(first[i], last[i]),
                                      contents(first[i]["height"], last[i]["height"], empty_root))
                   for i in (0, 1, 2)}
        windows["validator 3"] = (window(first[3], stopped),
                                  contents(first[3]["height"], stopped["height"], empty_root))
        # restarted, with a new content cache: every content of its heights
        # since the stop is new to it (only empty blocks commit between its
        # stop reading and its restart); those it extended before its
        # first reading are in that reading
        windows["validator 3 restarted"] = (
            window(restarted, last[3]),
            contents(out["stopped_at"], last[3]["height"]) - restarted["misses"])
        # past its last adopted height it decided every height itself, so
        # it extended each content of those heights in this life
        live_floor = contents(max(last[3]["adopted_height"], out["stopped_at"]),
                              last[3]["height"]) - restarted["misses"]
        windows["validator 2 swarm"] = (window(last[2], swarmed), 0)
        out["swarm"] = dict(report, verified=verified, answered=len(answers),
                            k7b_launches=windows["validator 2 swarm"][0]["launches"][
                                "das_proof_gather"],
                            chunks=windows["validator 2 swarm"][0]["chunks"])
        out["windows"] = {name: dict(w, new_contents=n, want=window_prediction(w),
                                     bounds=window_bounds(w, n))
                          for name, (w, n) in windows.items()}
        bounds = out["windows"]["validator 3 restarted"]["bounds"]
        bounds[0] = max(bounds[0], live_floor)
        out["build_seconds"] = {i: last[i]["build_seconds"] for i in last}
        out["build_seconds"]["3 before its stop"] = stopped["build_seconds"]
        for r in remotes.values():
            r.close()
        remotes = {}
        for i, proc in procs.items():
            stop(i, proc)
    finally:
        for r in remotes.values():
            r.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()
    # --- a relay drives an in-process mesh, is killed, and the mesh goes on ----------
    rgen = dict(genesis, chain_id=NET_CHAIN + "-relay")
    rnodes = [TestNode(chain_id=rgen["chain_id"], genesis=rgen, validator_key=v, device=dev,
                       auto_produce=False) for v in vals]
    for n in rnodes:
        n.enable_bft(valset)
    rservers = [NodeServer(n, block_interval_s=None) for n in rnodes]
    engines, relay = [], None
    try:
        for s in rservers:
            s.start()
        raddrs = [s.address for s in rservers]
        # built after the servers bind: an engine stamps its node's address
        engines = [GossipEngine(n, [a for j, a in enumerate(raddrs) if j != i],
                                block_gap_s=NET_BLOCK_GAP_S) for i, n in enumerate(rnodes)]
        eds_cache.content_cache(dev).clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        relay = subprocess.Popen(
            [sys.executable, "-m", "celestia_tpu_torch.cli", "bft-relay", "--peers",
             ",".join(raddrs), "--blocks", "0", "--block-interval", str(RELAY_GAP_S)],
            cwd=root, stdout=subprocess.PIPE, stderr=open(base / "relay.log", "w"), env=env,
            text=True)
        driven = []
        while len(driven) < RELAY_HEIGHTS:
            got, _, _ = select.select([relay.stdout], [], [], 120)
            line = relay.stdout.readline() if got else ""
            check(line.startswith("{"), f"cli bft-relay printed {line!r} after heights {driven}; "
                  f"exit {relay.poll()}; its log ends:\n" + log_tail(base / "relay.log"))
            driven.append(json.loads(line)["height"])
        # killed while it waits out its block interval: mid-run, no height
        # half driven
        relay.kill()
        relay.wait()
        killed_at = min(n.height for n in rnodes)
        check(driven == list(range(2, 2 + RELAY_HEIGHTS)) and killed_at == driven[-1],
              f"cli bft-relay drove heights {driven}; the validators are at "
              f"{[n.height for n in rnodes]}")
        relay_s = time.perf_counter() - t0
        for e in engines:
            e.start()
        rremote = RemoteNode(raddrs[1], timeout_s=60.0)
        try:
            res = BroadcastOnly(rremote, users[NET_FILLED_HEIGHTS]).submit_pay_for_blob(
                mesh_blobs(rng, k))
        finally:
            rremote.close()
        check(res.code == 0, f"the relay leg's mesh refused a PayForBlobs: {res.log}")
        deadline = time.monotonic() + 120
        while not all(n.get_tx(res.tx_hash) for n in rnodes) or min(
                n.height for n in rnodes) < killed_at + RELAY_MESH_HEIGHTS:
            check(time.monotonic() < deadline, "the relay leg's mesh stopped at heights "
                  f"{[n.height for n in rnodes]} after the relay was killed at {killed_at}")
            time.sleep(0.05)
        for e in engines:
            e.stop()
        engines = []
        relay_launches = kernels.launch_counts()
        rtop = min(n.height for n in rnodes)
        check(len({n.app.store.committed_hash(rtop) for n in rnodes}) == 1,
              f"the relay leg's validators differ in app hash at height {rtop}")
        rroots = set()
        for h in range(2, rtop + 1):
            blks = [n.block(h) for n in rnodes]
            check(len({b.header.data_hash for b in blks}) == 1,
                  f"the relay leg's validators differ at height {h}")
            square, _, _ = construct(list(blks[0].txs), blks[0].header.square_size)
            check(dah.extend_block(square, device="cpu")[1].hash == blks[0].header.data_hash,
                  f"the relay leg's data root at height {h} != the plain path's")
            rroots.add(blks[0].header.data_hash)
        filled_h = rnodes[0].get_tx(res.tx_hash)["height"]
        check(rnodes[0].block(filled_h).header.square_size == k,
              f"the relay leg's filled height {filled_h} is not k={k}")
        # the validators share the device's content cache: each block
        # content is extended at least once, and at most once by each
        # validator that validated it (two that miss the cache at once both
        # extend); 5 launches each (none on the CPU)
        counts = [node_counts(n.app.telemetry.export_prometheus()) for n in rnodes]
        misses = sum(c["misses"] for c in counts)
        validated = sum(c["validated"] for c in counts)
        adopted = sum(c["adopted"] for c in counts)
        check(len(rroots) - adopted <= misses <= validated, f"the relay leg's validators made "
              f"{misses} cold extensions for {len(rroots)} block contents ({validated} "
              f"proposals validated, {adopted} blocks adopted)")
        want = block_launches(misses if dev.type == "cuda" else 0)
        check(relay_launches == want, f"the relay leg launched {relay_launches}, predicted "
              f"{want} ({misses} cold extensions)")
        out["relay"] = {"driven": driven, "killed_at": killed_at, "mesh_to": rtop,
                        "filled": filled_h, "contents": len(rroots), "misses": misses,
                        "validated": validated, "adopted": adopted, "relay_s": relay_s,
                        "launches": relay_launches}
    finally:
        if relay is not None:
            if relay.poll() is None:
                relay.kill()
                relay.wait()
            relay.stdout.close()
        for e in engines:
            e.stop()
        for s in rservers:
            s.stop()
    # --- the process coordinator in this process -----------------------------------------
    coord_vals = vals[:COORD_VALIDATORS]
    cgen = dict(genesis, chain_id=NET_CHAIN + "-coord", validators=[
        {"address": v.public_key().address().hex(), "self_delegation": 10**8} for v in coord_vals])
    nodes = [TestNode(chain_id=cgen["chain_id"], genesis=cgen, validator_key=v, device=dev,
                      auto_produce=False) for v in coord_vals]
    servers = [NodeServer(n, block_interval_s=None) for n in nodes]
    for s in servers:
        s.start()
    clients = [RemoteNode(s.address, timeout_s=120.0) for s in servers]
    out["coord_ms"] = []
    try:
        coord = ProcessCoordinator([PeerValidator(f"val-{i}", c) for i, c in enumerate(clients)])
        kernels.reset_launch_counts()
        for j in range(COORD_HEIGHTS):
            signer = BroadcastOnly(Gossiped(coord, clients[0]), users[NET_FILLED_HEIGHTS + 1 + j])
            res = signer.submit_pay_for_blob(mesh_blobs(rng, k))
            check(res.code == 0, f"the coordinator's validators refused a PayForBlobs: {res.log}")
            t1 = time.perf_counter()
            coord.produce_block()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["coord_ms"].append((time.perf_counter() - t1) * 1e3)
        out["coord_launches"] = kernels.launch_counts()
        check(len({n.app.store.app_hash() for n in nodes}) == 1,
              "the coordinator's validators differ in app hash")
        for blk in coord.blocks:
            check(blk["square_size"] == k, f"the coordinator's height {blk['height']} is "
                  f"k={blk['square_size']}")
            square, _, _ = construct(list(blk["block_txs"]), blk["square_size"])
            check(dah.extend_block(square, device="cpu")[1].hash == blk["data_root"],
                  f"the coordinator's data root at height {blk['height']} != the plain path's")
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()
    return out


HOST_SQUARES = 4  # seeded squares a size of phase 4k
HOST_RUNS = 5  # breakdown calls and repairs a size of phase 4k
HOST_CHAIN = "chip-smoke-host-1"


def host_square(rng, k: int) -> np.ndarray:
    """A seeded k x k square of 512-byte shares with sorted version-0
    namespaces, as a real square has."""
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    ns = np.sort(rng.integers(0, 256, (k * k, 10), dtype=np.uint8).view("S10").ravel())
    flat = sq.reshape(k * k, 512)
    flat[:, :19] = 0
    flat[:, 19:29] = np.frombuffer(ns.tobytes(), np.uint8).reshape(-1, 10)
    return sq


def host_threads() -> str:
    """The host CPU the host regime runs on and the threads beside it: the
    native pool's (``hostpool.cpu_threads()``) and torch's own."""
    import os

    import torch

    from celestia_tpu_torch.utils import hostpool

    # /proc/cpuinfo names an x86 model; an Arm host's names only parts,
    # which lscpu decodes
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    if model is None:
        try:
            lscpu = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
            model = next((line.split(":", 1)[1].strip() for line in lscpu.splitlines()
                          if line.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    model = f"{model or 'model not reported'} ({platform.machine()})"
    return (f"{model}, {os.cpu_count()} logical CPUs; native pool "
            f"{hostpool.cpu_threads()} threads, torch {torch.get_num_threads()} threads")


def reference_extend(dev):
    """``dev``'s extend_and_header: on the card the entry point (the plane);
    on the CPU, where the entry point is the host regime itself, the plane's
    plain twins (a rehearsal)."""
    import torch

    from celestia_tpu_torch.da import dah, device_plane

    dev = torch.device(dev)
    if dev.type == "cuda":
        return lambda sq: dah.extend_and_header(sq, device=dev)
    return lambda sq: device_plane.extend_and_header(sq, device=dev)


def memo_child(dev, k: int, seed: int) -> None:
    """Phase 4k's row-memo leg, run in a child process: the codec is
    switched to lagrange-gf256 before the library's first use (a process
    pins its codec at that use).  A seeded square, then one sharing 3/4 of
    its rows, through the host regime: the memo must assemble the second
    once, at the predicted reuse, with the bytes of the fused leg and of
    ``dev``'s extension.  Prints one JSON line."""
    from celestia_tpu_torch.da import dah
    from celestia_tpu_torch.ops import gf256

    gf256.set_active_codec(gf256.CODEC_LAGRANGE)
    rng = np.random.default_rng(seed)
    first = host_square(rng, k)
    second = first.copy()
    second[3 * k // 4:] = host_square(rng, k)[3 * k // 4:]
    dah.clear_row_memo()
    host, walls = [], []
    for sq in (first, second):
        t0 = time.perf_counter()
        host.append(dah.extend_and_header(sq, device="cpu"))
        walls.append((time.perf_counter() - t0) * 1e3)
    stats = dah.row_memo_stats()
    check(stats["assembled"] == 1, f"the row memo assembled {stats['assembled']} squares, not 1")
    want_pct = 100.0 * (3 * k // 4) / (2 * k)
    check(stats["reuse_pct"] == want_pct, f"the row memo's reuse {stats['reuse_pct']} % != "
          f"{want_pct} %")
    t0 = time.perf_counter()
    cold = dah._extend_and_header_host(second)
    cold_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(cold[0].shares, host[1][0].shares) and cold[1] == host[1][1],
          "the memo's square differs from the fused native leg's")
    card = reference_extend(dev)
    for (eds_h, dah_h), sq in zip(host, (first, second)):
        eds_c, dah_c = card(sq)
        check(dah_h == dah_c and np.array_equal(eds_h.shares, eds_c.shares),
              "the host regime's memo square differs from the card's")
    print(json.dumps({"memo": stats, "walls_ms": walls, "fused_ms": cold_ms,
                      "codec": gf256.active_codec(), "threads": host_threads()}))


# phase 4l: the twins of the JAX package's tool gates, in the order they
# run, with the summary key of each leg's line
TOOL_TWINS = {
    "das_smoke": ("das_smoke",),
    "swarm_smoke": ("swarm_smoke",),
    "ingress_smoke": ("ingress_smoke",),
    "device_resident_smoke": ("device_resident_smoke",),
    "profile_smoke": ("profile_smoke", "profile_smoke_node"),
    "trace_smoke": ("trace_smoke", "trace_smoke_2node"),
    "critpath_smoke": ("critpath_smoke_mesh", "critpath_smoke_slo"),
    "incident_smoke": ("incident_smoke", "incident_smoke_disarmed"),
    "multichip_smoke": ("multichip_smoke",),
}
TOOL_TIMEOUT_S = 300  # one twin, its node processes included
TOOL_PARALLEL = 3  # twins at once (each with up to 3 node processes on 8 host cores)


def twin_summaries(name: str, stdout: str) -> dict:
    """The summary line of each of twin ``name``'s legs, by its key; each
    must say "ok"."""
    got = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            for key in TOOL_TWINS[name]:
                if key in doc:
                    got[key] = doc
    for key in TOOL_TWINS[name]:
        check(got.get(key, {}).get(key) == "ok", f"twin {name} printed no {key!r}: ok line")
    return got


def twin_predictions(name: str, summaries: dict) -> list:
    """(what, launches, predicted) for every node of a twin's summaries: 5
    launches (K5 twice, K2, K3, K4) for each cold extension and rebuilt
    block, one K7b for each streamed DAS chunk and each direct DAS batch;
    multichip's one sharded extension on its mesh of one repeated device."""
    from celestia_tpu_torch import kernels

    out = []
    for key, doc in summaries.items():
        if "mesh_devices" in doc:
            got = {n: doc["launches"].get(n, 0) for n in kernels.KERNELS}
            want = sharded_launches_per_call(doc["k"], len(doc["mesh_devices"]))
            out.append((f"{key} (k={doc['k']}, R={len(doc['mesh_devices'])})", got, want))
        for i, c in enumerate(doc.get("node_counts", ())):
            got = {n: c["launches"].get(n, 0) for n in kernels.KERNELS}
            want = block_launches(c["misses"] + c["rebuilt"])
            want["das_proof_gather"] = c["chunks"] + doc.get("das_batches", 0)
            out.append((f"{key} node {i} ({c['misses']} cold extensions, {c['rebuilt']} "
                        f"rebuilt, {c['chunks']} chunks)", got, want))
    return out


def tools_phase(dev, twins=tuple(TOOL_TWINS), *, counted: bool) -> dict:
    """Phase 4l: each twin of the JAX package's tool gates as a process on
    ``dev`` (``python -m celestia_tpu_torch.tools.<name> --device <dev>``),
    its summary lines parsed and every node's launches held to their
    prediction (``counted=False`` on the CPU, where nothing launches: the
    predictions are computed and not held).  Returns each twin's wall,
    summaries and predictions, and the launches of all nodes."""
    from concurrent.futures import ThreadPoolExecutor

    from celestia_tpu_torch import kernels

    device = str(dev)

    def run(name):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"celestia_tpu_torch.tools.{name}", "--device", device],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=TOOL_TIMEOUT_S,
        )
        return proc, time.perf_counter() - t0

    # the twins are independent processes (their nodes bind port 0, their
    # homes are temporary), so TOOL_PARALLEL run at once; each one's
    # launches are its own processes'
    with ThreadPoolExecutor(max_workers=TOOL_PARALLEL) as pool:
        done = dict(zip(twins, pool.map(run, twins)))
    out = {"twins": {}, "launches": {n: 0 for n in kernels.KERNELS}}
    for name in twins:
        proc, wall = done[name]
        check(proc.returncode == 0, f"twin {name} exited {proc.returncode} on {device}:\n"
              + "\n".join(proc.stderr.splitlines()[-15:]))
        summaries = twin_summaries(name, proc.stdout)
        preds = twin_predictions(name, summaries)
        for what, got, want in preds:
            if counted:
                check(got == want, f"twin {name}, {what}: launched "
                      f"{ {n: c for n, c in got.items() if c} }, predicted "
                      f"{ {n: c for n, c in want.items() if c} }")
            for n in kernels.KERNELS:
                out["launches"][n] += got[n]
        out["twins"][name] = {"wall_s": wall, "summaries": summaries, "predictions": preds}
    return out


def host_phase(dev, sizes, memo_k: int, seed: int, *, counted: bool) -> dict:
    """Phase 4k, the host regime (``device="cpu"`` at the block entry points
    of da/dah.py and ``ops/rs.py`` ``repair_square``: the native library's
    legs) against ``dev``.

    For each k in ``sizes``, HOST_SQUARES seeded squares through
    ``dah.extend_and_header(sq, device="cpu")`` and through ``dev``'s
    extension (``reference_extend``): equal EDS bytes, 4k axis roots and
    data roots, the kernel launch counts unmoved by the host calls; walls
    of both.  ``extend_and_header_breakdown`` on ``dev`` and on the CPU,
    HOST_RUNS calls a k.  At the largest k, a 25 % random mask repaired by
    ``rs.repair_square`` (host) and ``rs.repair_square_device`` on ``dev``,
    both the EDS.  In a child process under lagrange-gf256 at ``memo_k``, the
    row memo (``memo_child``).  Last, one filled height at GovMaxSquareSize
    ``sizes[0]`` of ``TestNode(device="cpu")`` and of ``TestNode(device=
    dev)`` on the same transactions: equal data roots; both walls.

    ``counted``: ``dev`` is a card; the launches of its legs are returned,
    and its extensions' held to 5 each."""
    import os

    import torch

    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client.signer import Signer, SubmitResult
    from celestia_tpu_torch.da import dah
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.ops import rs
    from celestia_tpu_torch.parallel import mesh as provider
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    card = reference_extend(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def host_leg(fn):
        """fn's result and wall; fn must launch no kernel."""
        before = kernels.launch_counts()
        out, ms = timed(fn)
        check(kernels.launch_counts() == before, "the host regime launched a kernel")
        return out, ms

    out = {"threads": host_threads(), "host_ms": {}, "card_ms": {}, "breakdown": {},
           "host_breakdown": {}, "launches": {}}
    card_calls, extended = 0, {}
    kernels.reset_launch_counts()
    for k in sizes:
        squares = [host_square(rng, k) for _ in range(HOST_SQUARES)]
        card(squares[0])  # one warm call a leg
        host_leg(lambda: dah.extend_and_header(squares[0], device="cpu"))
        card_calls += 1
        for sq in squares:
            (eds_h, dah_h), h_ms = host_leg(lambda: dah.extend_and_header(sq, device="cpu"))
            (eds_c, dah_c), c_ms = timed(lambda: card(sq))
            card_calls += 1
            check(dah_h.row_roots == dah_c.row_roots and dah_h.col_roots == dah_c.col_roots,
                  f"the host regime's axis roots differ from the card's at k={k}")
            check(dah_h.hash == dah_c.hash, f"the host regime's data root differs at k={k}")
            check(np.array_equal(eds_h.shares, eds_c.shares),
                  f"the host regime's EDS differs from the card's at k={k}")
            out["host_ms"].setdefault(k, []).append(h_ms)
            out["card_ms"].setdefault(k, []).append(c_ms)
        extended[k] = (eds_c.shares, dah_c)
        for key, where, leg in (("breakdown", dev, timed), ("host_breakdown", "cpu", host_leg)):
            runs = []
            for _ in range(HOST_RUNS):
                (_, dah_b, split), _ = leg(
                    lambda: dah.extend_and_header_breakdown(squares[-1], device=where))
                check(dah_b == dah_h, f"the breakdown's DAH differs at k={k} ({key})")
                runs.append(split)
            out[key][k] = {name: statistics.median(r[name] for r in runs) for name in runs[0]}
        card_calls += HOST_RUNS
    extend_launches = kernels.launch_counts()
    if counted:
        check(extend_launches == block_launches(card_calls), f"phase 4k's card extensions "
              f"launched {extend_launches}, predicted {block_launches(card_calls)}")
    out["launches"]["extend"] = extend_launches

    # repair at the largest k: a 25 % random mask, host and card
    k = max(sizes)
    eds, dah_c = extended[k]
    roots = [np.frombuffer(b"".join(r), dtype=np.uint8).reshape(2 * k, 90)
             for r in (dah_c.row_roots, dah_c.col_roots)]
    avail = np.random.default_rng(seed + 1).random((2 * k, 2 * k)) >= 0.25
    damaged = eds.copy()
    damaged[~avail] = 0
    host_runs, card_runs = [], []
    kernels.reset_launch_counts()
    for _ in range(HOST_RUNS):
        got, ms = host_leg(lambda: rs.repair_square(damaged, avail, *roots))
        check(np.array_equal(got, eds), f"the host repair at k={k} is not the EDS")
        host_runs.append(ms)
        got, ms = timed(lambda: rs.repair_square_device(damaged, avail, *roots, device=dev))
        check(np.array_equal(got, eds), f"the repair on {dev} at k={k} is not the EDS")
        card_runs.append(ms)
    out["launches"]["repair"] = kernels.launch_counts()
    out["repair_ms"] = {"host": host_runs, "card": card_runs, "k": k,
                        "withheld": int((~avail).sum())}

    # the row memo, in a child process under lagrange-gf256
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.memo_child({str(dev)!r}, "
         f"{memo_k}, {seed + 2})"],
        cwd=here, capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"the row-memo child failed: {proc.stderr[-2000:]}")
    out["memo"] = json.loads(proc.stdout.strip().splitlines()[-1])
    out["memo"]["child_s"] = time.perf_counter() - t0
    out["memo"]["k"] = memo_k

    # one filled height of a TestNode on the CPU and one on dev, same txs
    class BroadcastOnly(Signer):
        def confirm_tx(self, tx_hash, **kw):
            return SubmitResult(0, "", tx_hash)

    k = sizes[0]
    keys = [PrivateKey.from_seed(b"chip-smoke-host-%d" % i) for i in range(APP_PFBS)]
    validator = PrivateKey.from_seed(b"chip-smoke-host-validator")
    genesis = {
        "chain_id": HOST_CHAIN, "genesis_time_ns": APP_GENESIS_NS, "codec": "leopard-ff8",
        "accounts": [{"address": key.public_key().address().hex(), "balance": 10**13}
                     for key in keys],
        "validators": [{"address": validator.public_key().address().hex(),
                        "self_delegation": 10**9}],
        "params": {"blob": {"GovMaxSquareSize": k}},
    }
    blobs = pfb_blobs(rng, k, APP_PFBS)
    blocks, node_ms = {}, {}
    provider.configure("off")
    try:
        for label, where, leg in (("host", "cpu", host_leg), ("card", dev, timed)):
            node = TestNode(chain_id=HOST_CHAIN, genesis=genesis, validator_key=validator,
                            device=where, auto_produce=False)
            for key, b in zip(keys, blobs):
                res = BroadcastOnly(node, key).submit_pay_for_blob(list(b))
                check(res.code == 0, f"a PayForBlobs was refused: {res.log}")
            kernels.reset_launch_counts()
            blocks[label], node_ms[label] = leg(node.produce_block)
            out["launches"][f"testnode_{label}"] = kernels.launch_counts()
    finally:
        provider.configure(None)
    blk_h, blk_c = blocks["host"], blocks["card"]
    check(blk_h.header.square_size == k, f"the host TestNode's height filled to "
          f"{blk_h.header.square_size}, not {k}")
    check(blk_h.txs == blk_c.txs and blk_h.header.data_hash == blk_c.header.data_hash,
          "the host TestNode's block differs from the card TestNode's")
    if counted:
        check(out["launches"]["testnode_card"] == block_launches(1), "the card TestNode's "
              f"height launched {out['launches']['testnode_card']}, predicted "
              f"{block_launches(1)}")
    out["testnode_ms"] = node_ms
    out["testnode_root"] = blk_c.header.data_hash.hex()
    return out


def tree_parents(trees: int, m: int) -> list:
    """Parents of each level 1 .. log2 m of ``trees`` trees of ``m`` leaves."""
    return [trees * (m >> j) for j in range(1, m.bit_length())]


def level_floor_ms(parents: list, compression_ms: float) -> float:
    """K3's level floor: over its levels, the longer of the level's
    compressions (3 a 181-byte node) at the int32 issue rate and three
    compressions one after another at the in-kernel latency."""
    per = compressions(181)
    return sum(max(n * per * SHA_OPS_PER_COMPRESSION / INT32_OPS_PER_S * 1e3, per * compression_ms)
               for n in parents)


@functools.lru_cache(maxsize=None)
def cuobjdump(flag: str) -> str:
    """``cuobjdump <flag>`` of the built library (beside nvcc), run once a
    flag: the library does not change within a run."""
    import os

    from celestia_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([tool, flag, str(kernels.build())], capture_output=True, text=True,
                          check=True).stdout


def kernel_sass_mix(kernel: str) -> dict:
    """Opcode counts of the built library's SASS for the kernel whose mangled
    name holds ``kernel`` (``cuobjdump -sass``, beside nvcc): how its rounds
    compile (SHF / LOP3 / IADD3), how many loads it holds and whether any
    spill (LDL / STL), and its longest runs of instructions with no load
    between them (in code order, with their SHF counts): a run that holds
    the rounds of two compressions took every message word from registers."""
    import re
    from collections import Counter

    for func in re.split(r"\n\s*Function : ", cuobjdump("-sass")):
        if kernel in func.split("\n", 1)[0]:
            code = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", func)
            ops = Counter(code)
            runs, length, shf = [], 0, 0
            for op in code + ["LDS"]:
                if op in ("LDS", "LDG", "LDL", "LD", "LDSM"):
                    runs.append({"instructions": length, "SHF": shf})
                    length, shf = 0, 0
                else:
                    length, shf = length + 1, shf + (op == "SHF")
            runs.sort(key=lambda r: -r["instructions"])
            return {"instructions": sum(ops.values()),
                    **{op: ops[op] for op in ("SHF", "LOP3", "IADD3", "PRMT", "LDS", "STS", "LDG",
                                              "STG", "LDL", "STL", "BAR")},
                    "most_common": ops.most_common(10),
                    "longest_load_free_runs": runs[:3]}
    raise AssertionError(f"no kernel {kernel} in the built library's SASS")


def kernel_resources(kernel: str) -> dict:
    """Registers, stack, shared and local memory of the built library's
    kernel whose mangled name holds ``kernel`` (``cuobjdump -res-usage``):
    a spill shows as STACK and LOCAL bytes."""
    import re

    lines = cuobjdump("-res-usage").splitlines()
    for head, usage in zip(lines, lines[1:]):
        if head.strip().startswith("Function") and kernel in head:
            return {key: int(v) for key, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", usage)}
    raise AssertionError(f"no kernel {kernel} in the built library's resource usage")


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all of "
                    f"{','.join(PHASES)}); 1 and 5 always run, and any of 3-4f runs 3-4f")
    args = ap.parse_args()
    selected = set()
    for name in args.phases.split(","):
        if name.strip() not in PHASES:
            ap.error(f"unknown phase {name!r}; choose from {','.join(PHASES)}")
        selected.add(PHASE_GROUPS.get(name.strip(), name.strip()))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.appconsts import DEFAULT_GOV_MAX_SQUARE_SIZE
    from celestia_tpu_torch.da import dah, das, device_plane, eds_cache, fraud, golden
    from celestia_tpu_torch.da import namespace_data, proof
    from celestia_tpu_torch.da import square as square_mod
    from celestia_tpu_torch.da.blob import Blob, BlobTx
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.da.shares import sparse_shares_needed
    from celestia_tpu_torch.ops import gather, gf256, nmt, rs
    from celestia_tpu_torch.ops.sha256 import sha256_cuda, sha256_plain

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)
    results = {"seed": args.seed}

    # --- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: nvcc {kernels.build_seconds:.1f} s (library ready in "
          f"{time.perf_counter() - t0:.1f} s)")
    results["device"] = smi
    results["build_seconds"] = kernels.build_seconds
    # the node service's transport needs grpc; whether this machine has it
    # decides which form of phase 4i runs (PERF.md says which ran)
    grpc_found = importlib.util.find_spec("grpc") is not None
    print(f"grpc: {'importable' if grpc_found else 'not importable'} on this machine")
    results["grpc"] = grpc_found

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def time_ms(fn, reps: int = 20, warm: int = 2, queued: bool = False) -> float:
        """Milliseconds of one call of fn on the card: reps calls between two
        events as the host issues them (for a kernel shorter than its Python
        wrapper, the wrapper's time); queued=True puts the calls behind a
        sleep, so that the card runs them back to back and the host's issue
        time stays out: the GPU time."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item()) if a.numel() else 0

    errs = {name: 0 for name in (*kernels.KERNELS, *BIT_GEMM_FORMS)}

    def k5(name: str, codec: str) -> str:
        """K5's or K5b's name in errs and perf for the kernel ``codec`` runs."""
        return name if codec == gf256.CODEC_LEOPARD else f"{name}_bit_gemm"
    perf = {}
    # the launches of every path; a path of an unselected phase launched nothing
    extend_launches = serve_launches = repair_launches = fraud_launches = {}
    catchup_launches = sharded_launches = app_launches = app_mesh_launches = {}
    devnet_launches = service_launches = network_launches = host_launches = {}
    tools_launches = {}

    def compare(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} differs from its plain version ({what}): max_abs_err {err}")

    if "2" in selected:
        # --- 2. kernels against their plain versions ------------------------------
        for L in (542, 181, 91, 65):
            msgs = upload(rng.integers(0, 256, (65536, L), dtype=np.uint8))
            got = sha256_cuda(msgs)
            compare("sha256_batch", got, sha256_plain(msgs), f"L={L}")
            host = msgs.cpu().numpy()
            out = got.cpu().numpy()
            for i in rng.integers(0, len(host), 64):
                check(hashlib.sha256(host[i].tobytes()).digest() == out[i].tobytes(),
                      f"sha256_batch != hashlib at L={L}, message {i}")
            ms = time_ms(lambda: sha256_cuda(msgs))
            ops = 65536 * compressions(L) * SHA_OPS_PER_COMPRESSION
            b_ms, _ = bound(65536 * (L + 32), ops, INT32_OPS_PER_S)
            print(f"K1 sha256_batch L={L} n=65536: {ms:.4f} ms (bound {b_ms:.4f} ms) byte-equal")

        # K2, and every level of K3 from one launch against the plain chain of
        # combine_level_plain, at every k; k = 128 gives the main path's shapes
        # (the EDS, the leaf grid, the levels) to the checks and times below
        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            sq_np = rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8)
            sq_np[..., :18] = 0  # version-0 namespaces: real min/max ranges
            sq = upload(sq_np)
            eds = rs.extend_cuda(sq, gf256.active_codec())
            grid = nmt.eds_leaf_digests(eds)
            compare("nmt_leaf_digests", grid, nmt.eds_leaf_digests_plain(eds), f"k={kk} EDS")
            levels = nmt.grid_levels(grid)
            check(len(levels) == (2 * kk).bit_length() - 1, f"K3 gave {len(levels)} levels at k={kk}")
            if kk == 64:
                grid64 = grid  # K3's time at k = 64 below
            for j, (got, want) in enumerate(zip(levels, nmt.grid_levels_plain(grid)), 1):
                compare("nmt_combine_level", got, want, f"k={kk} level {j} of the 4k trees")
            compare("nmt_combine_level", levels[-1][:, 0].reshape(2, 2 * kk, 90),
                    nmt.eds_nmt_roots_plain(eds), f"k={kk} roots")
            # K2's row-set mode (+ K3): a scattered, unsorted set of rows read in
            # place from the EDS, and gathered from its transposed view (drawn
            # from a generator of their own: the seeded blocks below stay as
            # they were)
            row_set = np.random.default_rng([args.seed, kk]).permutation(2 * kk)[
                : max(1, 2 * kk // 3)].tolist()
            for view, how in ((eds, "in place"), (eds.transpose(0, 1), "gathered, transposed")):
                want = nmt.eds_row_level_stack_plain(view, row_set)
                got = nmt.eds_row_level_stack(view, row_set)
                compare("nmt_leaf_digests", got[0], want[0], f"k={kk} row set {how}")
                for lv_got, lv_want in zip(got[1:], want[1:]):
                    compare("nmt_combine_level", lv_got, lv_want,
                            f"k={kk} row set {how}, level of {lv_want.shape[-2]}")
        # the one-level functions (K3 with one level) against those levels
        compare("nmt_combine_level", nmt.combine_grid(grid), levels[0], "k=128 combine_grid")
        compare("nmt_combine_level", nmt.combine_level(levels[0]), levels[1], "k=128 combine_level")
        k = 128
        n2 = 2 * k

        # K4 from the leaves (the data root's 4k axis roots of 90 bytes, one tree
        # and a batch of 8) and over given leaf hashes, at every k
        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            roots8 = upload(rng.integers(0, 256, (8, 4 * kk, 90), dtype=np.uint8))
            compare("rfc6962_root", nmt.rfc6962_levels(roots8[0]), nmt.rfc6962_levels_plain(roots8[0]),
                    f"from {4 * kk} leaves")
            compare("rfc6962_root", nmt.rfc6962_levels(roots8), nmt.rfc6962_levels_plain(roots8),
                    f"a batch of 8 trees of {4 * kk} leaves")
            hashes8 = nmt.rfc6962_leaf_hashes_plain(roots8)
            compare("rfc6962_root", nmt.rfc6962_tree_levels(hashes8),
                    nmt.rfc6962_tree_levels_plain(hashes8), f"over 8 x {4 * kk} given hashes")
        del roots8, hashes8
        rand_roots = upload(rng.integers(0, 256, (4 * k, 90), dtype=np.uint8))
        leaf_hashes = nmt.rfc6962_leaf_hashes(rand_roots)
        compare("sha256_batch", leaf_hashes, nmt.rfc6962_leaf_hashes_plain(rand_roots),
                "RFC-6962 leaf hashes of 512 roots")
        data_root = nmt.rfc6962_root_pow2(rand_roots)
        compare("rfc6962_root", data_root, nmt.rfc6962_tree_plain(leaf_hashes), "512 leaves")
        host_root = nmt.rfc6962_root_np(list(rand_roots.cpu().numpy()))
        check(data_root.cpu().numpy().tobytes() == host_root.tobytes(),
              "rfc6962_root != rfc6962_root_np (hashlib)")
        root_tree = nmt.rfc6962_levels(rand_roots)
        compare("rfc6962_root", root_tree, nmt.rfc6962_tree_levels_plain(leaf_hashes),
                "levels output, 512 leaves")
        compare("rfc6962_root", nmt.rfc6962_tree_levels(leaf_hashes), root_tree,
                "over the 512 given hashes")
        for got, want in zip(nmt.rfc6962_level_stack(rand_roots),
                             nmt.rfc6962_level_stack_plain(rand_roots)):
            compare("rfc6962_root", got, want, f"rfc6962_level_stack level of {want.shape[0]}")
        check(root_tree[-1].cpu().numpy().tobytes() == host_root.tobytes(),
              "rfc6962_root levels output: root != rfc6962_root_np (hashlib)")

        # K7b in both modes against the plain gather over the host's item table
        # (device_plane.proof_items), at every k: 1,024 cells with the four
        # corners, each cell's tree its own row, then another row of the block
        def das_cells(kk: int):
            nk = 2 * kk
            return [(0, 0), (0, nk - 1), (nk - 1, 0), (nk - 1, nk - 1)] + [
                (int(r), int(c)) for r, c in rng.integers(0, nk, (CLIENTS * SAMPLES - 4, 2))]

        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            sq_k = upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8))
            entry_k = device_plane.DevicePlaneEntry(kk, bytes(32), *device_plane._extend_levels(sq_k))
            cells_k = das_cells(kk)
            srcs_k = entry_k.gather_sources()
            nbytes_k = len(cells_k) * device_plane._cell_layout(kk).cell_bytes
            for trees in (None, rng.integers(0, 2 * kk, len(cells_k)).tolist()):
                items_k = device_plane.proof_items(kk, cells_k, trees)
                want = gather.das_proof_gather_plain(srcs_k, items_k, nbytes_k)
                what = f"1,024 cells at k={kk}, {'other' if trees else 'own'} tree rows"
                compare("das_proof_gather", device_plane.gather_cells(kk, srcs_k, cells_k, trees),
                        want, f"cell mode, {what}")
                compare("das_proof_gather", gather.das_proof_gather(srcs_k, items_k, nbytes_k), want,
                        f"table mode, {what}")
        del sq_k, entry_k, srcs_k, want
        print("K7b das_proof_gather: the cell mode and the table mode byte-equal to the plain "
              "gather at k=1..128 (1,024 cells, corners, own and other tree rows)")
        # the main path's shapes: a k = 128 block's plane entry, 1,024 cells
        eds_k, grid_k, levels_k, tree_k = device_plane._extend_levels(sq)
        entry = device_plane.DevicePlaneEntry(k, bytes(32), eds_k, grid_k, levels_k, tree_k)
        cells = das_cells(k)
        g_sources = entry.gather_sources()
        g_layout = device_plane._cell_layout(k)
        g_cells = device_plane.cell_table(cells)
        g_items = device_plane.proof_items(k, cells)
        g_bytes = len(cells) * g_layout.cell_bytes
        g_cells_dev = torch.from_numpy(g_cells).to(dev)
        g_items_dev = torch.from_numpy(g_items).to(dev)
        g_out = torch.empty(g_bytes, dtype=torch.uint8, device=dev)
        g_want = gather.das_proof_gather_plain(g_sources, g_items, g_bytes)
        gather.launch_cells(g_sources, g_layout, g_cells_dev, g_out)
        compare("das_proof_gather", g_out, g_want, "cell mode, 1,024 cells at k=128 (timed call)")
        gather.launch_gather(g_sources, g_items_dev, g_out)
        compare("das_proof_gather", g_out, g_want, "table mode, 1,024 cells at k=128 (timed call)")
        # library yardstick: one torch.index_select per source, each gathering its
        # items as rows of a 2D view of the source
        lib_select = []
        for i, src in enumerate(g_sources):
            mine = g_items[g_items[:, 0] == i].astype(np.int64)
            if not len(mine):
                continue
            rows = src.tensor.reshape(-1)[src.offset:].view(-1, src.width) if src.row_stride == 0 \
                else src.tensor.view(-1, src.width)
            per_row = src.row_stride // src.width
            lib_select.append((rows, upload(mine[:, 1] * per_row + mine[:, 2])))

        def library_gather():
            return [torch.index_select(rows, 0, idx) for rows, idx in lib_select]

        g_payload = int(sum(g_sources[i].width for i in g_items[:, 0]))  # bytes of the 18,432 items
        lib_out = torch.cat([t.reshape(-1) for t in library_gather()])
        check(lib_out.numel() == g_payload, "index_select yardstick gathers another byte count")

        for codec in gf256.CODECS:
            for kk in (1, 2, 4, 8, 16, 32, 64, 128):
                s = upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8))
                compare(k5("rs_extend", codec), rs.extend_cuda(s, codec), rs.extend_plain(s, codec),
                        f"k={kk} codec={codec}")
        # the FFT kernel (leopard-ff8) of K5, K5b and the row pass against the
        # plain path and against the bit-GEMM kernel given leopard's E, at every k
        leo = gf256.CODEC_LEOPARD
        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            s = upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8))
            fft = rs.extend_cuda(s, leo)
            gemm = rs.extend_bit_gemm_cuda(s, leo)
            compare("rs_extend", fft, gemm, f"FFT against the bit-GEMM kernel, k={kk}")
            compare("rs_extend_bit_gemm", gemm, rs.extend_plain(s, leo), f"k={kk} codec={leo}")
            s3 = upload(rng.integers(0, 256, (3, kk, kk, 512), dtype=np.uint8))
            fft = rs.extend_batched_cuda(s3, leo)
            gemm = rs.extend_batched_bit_gemm_cuda(s3, leo)
            compare("rs_extend_batched", fft, rs.extend_batched_plain(s3, leo),
                    f"n=3 k={kk} codec={leo}")
            compare("rs_extend_batched", fft, gemm, f"FFT against the bit-GEMM kernel, n=3 k={kk}")
            rows = upload(rng.integers(0, 256, (kk + 3, kk, 512), dtype=np.uint8))
            fft = rs.extend_rows_cuda(rows, leo)
            compare("rs_extend", fft, rs.extend_rows_plain(rows, leo),
                    f"row pass of {kk + 3} rows, k={kk} codec={leo}")
            compare("rs_extend", fft, rs.extend_rows_bit_gemm_cuda(rows, leo),
                    f"row pass of {kk + 3} rows against the bit-GEMM kernel, k={kk}")
        del s, s3, rows, fft, gemm
        print("K5 under leopard-ff8 (Leopard's FFT kernel): one square, a batch of 3 and the row "
              "pass byte-equal to the plain path and to the bit-GEMM kernel at k=1..128")
        # K9a's FFT form (leopard-ff8) at every k and every R (n_in = k/R down to
        # 1): each shard of a batch of 2 squares' top rows (Q0 | Q1) against its
        # plain version and the bit-GEMM given leopard's E, and the R partials'
        # XOR against the squares' parity rows
        k9a_shards = 0
        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            e2 = rs.extend_batched_cuda(upload(rng.integers(0, 256, (2, kk, kk, 512),
                                                            dtype=np.uint8)), leo)
            Gk = rs.encode_matrix_bits_tensor(kk, leo, str(dev))
            R = 1
            while R <= kk:
                m = kk // R
                acc = torch.zeros((2, kk, 2 * kk, 512), dtype=torch.uint8, device=dev)
                for d in range(R):
                    what = f"shard {d} of {R} (n_in={m}) at k={kk}, batch of 2"
                    top = e2[:, d * m : (d + 1) * m].contiguous()
                    fft = rs.col_parity_partial_cuda(
                        top, *rs.partial_coefficients(kk, d * m, m, leo, dev))
                    gemm = rs.col_parity_partial_bit_gemm_cuda(
                        top, *rs.bit_gemm_partial_coefficients(kk, d * m, m, leo, dev))
                    plain = rs.col_parity_partial_plain(
                        top, Gk[:, 8 * d * m : 8 * (d + 1) * m].contiguous())
                    compare("rs_col_parity_partial", fft, plain, what)
                    compare("rs_col_parity_partial_bit_gemm", gemm, plain, what)
                    compare("rs_col_parity_partial", fft, gemm, f"against the bit-GEMM, {what}")
                    acc ^= fft
                    k9a_shards += 1
                compare("rs_col_parity_partial", acc, e2[:, kk:],
                        f"the {R} partials' XOR against the parity rows, k={kk}, batch of 2")
                R *= 2
        del e2, Gk, acc, top, fft, gemm, plain
        print(f"K9a under leopard-ff8 (Leopard's pruned encode): {k9a_shards} shards at k=1..128, "
              "every R from 1 to k, a batch of 2, byte-equal to the plain path and to the bit-GEMM "
              "kernel, every R's partials XOR to the parity rows")
        # the repair kernels and the batched extension (K8a at k = 4, 32, 128;
        # K8b at every k; K8c and K5b at k = 32), K5's row pass and K9a, and the
        # batched K2/K3, both codecs
        def known_sets(kk: int, n: int) -> np.ndarray:
            return np.stack([np.sort(rng.permutation(2 * kk)[:kk]) for _ in range(n)]).astype(np.uint8)

        for codec in gf256.CODECS:
            for kk in (1, 2, 4, 8, 16, 32, 64, 128):
                # 2k axes (one a block), and 300 (several a block at small k)
                for n_ax in (2 * kk, 300):
                    known = upload(known_sets(kk, n_ax))
                    compare("rs_decode_matrices", rs.decode_matrices_cuda(known, kk, codec),
                            rs._decode_matrices_dev(known, kk, codec),
                            f"k={kk}, {n_ax} axes, codec={codec}")
            for kk in (1, 2, 4, 8, 16, 32, 64, 128):
                ek = rs.extend_cuda(upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8)), codec)
                # k + 3 axes, 20 and 2: the Leopard kernel's three launch shapes
                # (66 axes or more, 9-65, at most 8: the deep peel's); the
                # unknown cells of each decoded axis garbage
                for n_ax in sorted({min(2 * kk, kk + 3), min(2 * kk, 20), min(2 * kk, 2)}):
                    known_np = known_sets(kk, n_ax)
                    known_np[0] = np.arange(kk)  # the first k positions, as fraud detection asks
                    known = upload(known_np)
                    Dk = rs.decode_matrices_cuda(known, kk, codec)
                    for cols in (False, True):
                        axes_np = np.sort(rng.permutation(2 * kk)[:n_ax]).astype(np.int32)
                        axes = upload(axes_np)
                        unknown = np.zeros((2 * kk, 2 * kk), dtype=bool)
                        unknown[axes_np] = True
                        unknown[axes_np[:, None], known_np.astype(np.int64)] = False
                        start = ek.clone()
                        view = start.transpose(0, 1) if cols else start
                        view[upload(unknown)] = upload(rng.integers(
                            0, 256, (int(unknown.sum()), 512), dtype=np.uint8))
                        what = f"k={kk} {n_ax} {'columns' if cols else 'rows'} codec={codec}"
                        gemm = rs.decode_axes_bit_gemm_cuda(start.clone(), Dk, known, axes, cols,
                                                            codec)
                        compare("rs_decode_axes_bit_gemm", gemm,
                                rs.decode_axes_plain(start.clone(), Dk, known, axes, cols, codec),
                                what)
                        check(torch.equal(gemm, ek), f"K8b's bit-GEMM did not restore ({what})")
                        if codec == gf256.CODEC_LEOPARD:
                            got = rs.decode_axes_cuda(start.clone(), None, known, axes, cols, codec)
                            compare("rs_decode_axes", got,
                                    rs.decode_axes_fft_plain(start.clone(), known, axes, cols), what)
                            compare("rs_decode_axes", got, gemm, f"against the bit-GEMM, {what}")
                if kk == 32:
                    e32 = ek
            # K5's row pass and K9a on every shard, down to one input a shard;
            # K9a through the sharded path's dispatch (rs.col_parity_partial),
            # which launches the codec's kernel and no other
            for kk, R in ((8, 8), (32, 4), (128, 8)):
                rows_r = kk // R
                ek = rs.extend_cuda(upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8)), codec)
                Gk = rs.encode_matrix_bits_tensor(kk, codec, str(dev))
                parts = []
                for d in range(R):
                    mine = ek[d * rows_r : (d + 1) * rows_r]
                    compare(k5("rs_extend", codec),
                            rs.extend_rows_cuda(mine[:, :kk].contiguous(), codec), mine,
                            f"row pass of shard {d} of {R} at k={kk} codec={codec}")
                    top = mine[None]
                    before = kernels.entry_launch_counts()
                    parts.append(rs.col_parity_partial(
                        top, rs.partial_coefficients(kk, d * rows_r, rows_r, codec, dev)))
                    after = kernels.entry_launch_counts()
                    k9a_entry = ("ctt_rs_leopard_col_parity_partial"
                                 if codec == gf256.CODEC_LEOPARD else "ctt_rs_col_parity_partial")
                    check({e: c - before.get(e, 0) for e, c in after.items()
                           if c != before.get(e, 0)} == {k9a_entry: 1},
                          f"K9a under {codec} launched {after} (before {before}), not {k9a_entry}")
                    compare(k5("rs_col_parity_partial", codec), parts[-1],
                            rs.col_parity_partial_plain(
                                top, Gk[:, 8 * d * rows_r : 8 * (d + 1) * rows_r].contiguous()),
                            f"shard {d} of {R} (n_in={rows_r}) at k={kk} codec={codec}")
                compare(k5("rs_col_parity_partial", codec),
                        rs.xor_reduce_slabs_plain(torch.stack(parts))[0], ek[kk:],
                        f"the {R} partials' XOR against the parity rows, k={kk} codec={codec}")
                # K3's column subtrees over each shard's top and bottom rows (one
                # launch each, none at k/R = 1), then the finish over the 2R
                # gathered nodes a column: the EDS's column roots
                gk = nmt.eds_leaf_digests(ek)
                sub = []
                for d in range(R):
                    win = torch.stack([gk[d * rows_r : (d + 1) * rows_r],
                                       gk[kk + d * rows_r : kk + (d + 1) * rows_r]])
                    got = nmt.column_levels(win)
                    for j, (a, b) in enumerate(zip(got, nmt.column_levels_plain(win)), 1):
                        compare("nmt_combine_level", a, b,
                                f"column subtrees of shard {d} of {R}, level {j}, k={kk}")
                    sub.append(got[-1][..., 0, :] if got else win[:, 0])
                gathered = torch.stack(sub, dim=1).reshape(2 * R, 2 * kk, 90)
                fin = nmt.column_levels(gathered)
                for j, (a, b) in enumerate(zip(fin, nmt.column_levels_plain(gathered)), 1):
                    compare("nmt_combine_level", a, b, f"finishing level {j} of {R} shards, k={kk}")
                compare("nmt_combine_level", fin[-1][:, 0], nmt.eds_nmt_roots_plain(ek)[1],
                        f"column roots from {R} shards' subtrees, k={kk} codec={codec}")
                del parts, ek, gk, sub, gathered, fin
            kk = 32
            rec, prov = e32.clone(), e32.clone()
            rec[3, 40, 17] ^= 1
            prov[5, 6, 511] ^= 2
            prov[7, 7, 0] ^= 1
            av = upload((rng.random((2 * kk, 2 * kk)) < 0.5).astype(np.uint8))
            av[5, 6] = 1
            for name, got, want in zip(("mismatch", "provided_mismatch"),
                                       rs.repair_verdicts_cuda(e32, rec, prov, av),
                                       rs.repair_verdicts_plain(e32, rec, prov, av)):
                compare("rs_repair_verdicts", got, want, f"k={kk} {name} codec={codec}")
            sq2 = upload(rng.integers(0, 256, (2, kk, kk, 512), dtype=np.uint8))
            e2 = rs.extend_batched_cuda(sq2, codec)
            compare(k5("rs_extend_batched", codec), e2, rs.extend_batched_plain(sq2, codec),
                    f"n=2 k={kk} codec={codec}")
        compare("nmt_leaf_digests", nmt.eds_leaf_digests(e2), nmt.eds_leaf_digests_plain(e2),
                "batch of 2 EDSs at k=32")
        compare("nmt_combine_level", nmt.eds_nmt_roots(e2), nmt.eds_nmt_roots_plain(e2),
                "batched roots of 2 EDSs at k=32")
        del Dk, e32, rec, prov, av, sq2, e2, start, gemm, got
        print("kernels: byte-equal to their plain versions "
              f"(K5 and K8b's bit-GEMM at k=1..128 x {len(gf256.CODECS)} codecs, K8b's Leopard "
              "decode at k=1..128 against its plain version and the bit-GEMM, the row pass, K9a and K3's "
              "column subtrees and finish at k/R = 8/8, 32/4, 128/8 x both codecs, K2 and every K3 "
              "level at k=1..128, K4 from the leaves at n=4k for k=1..128 (one tree, a batch of 8, "
              "given hashes), K8a at k=1..128 x both codecs, K8c/K5b and batched K2/K3 at k=32)")

        # times at the main path's k = 128 shapes (per block)
        codec = gf256.active_codec()
        check(codec == gf256.CODEC_LEOPARD, f"K5's bound counts the Leopard codec, active: {codec}")
        G = rs.encode_matrix_bits_tensor(k, codec, str(dev))
        # the bit-GEMM's B operand for the three quadrants: Q0's bit planes as
        # (8k, k*512), three times over
        q0_bits = rs.unpack_bits(sq).permute(1, 0, 2).reshape(8 * k, k * 512)
        bits = torch.cat([q0_bits] * 3, dim=1).contiguous()

        parents = 4 * k * (n2 - 1)
        # K8a/K8b/K8c at a repair's k = 128 shapes: under the 25 % mask of
        # BASELINE config 4 every row is solvable in phase 1, so 2k axes
        avail25 = rng.random((n2, n2)) >= 0.25
        known25, axes25, segs25 = rs._schedule_tensors(rs._simulate_schedule(avail25, k), dev)
        check(segs25 == [(0, n2, False)], f"the 25 % mask's schedule is {segs25}, not 2k rows")
        N25 = n2
        D25 = rs.decode_matrices_cuda(known25, k, codec)
        compare("rs_decode_matrices", D25, rs._decode_matrices_dev(known25, k, codec),
                "k=128, the 25 % mask's schedule")
        # every cell but the known ones starts as garbage, so the decode must
        # write each of them (the available-but-not-known cells too)
        unknown_cells = torch.ones((n2, n2), dtype=torch.bool, device=dev)
        unknown_cells[axes25.long()[:, None], known25.long()] = False
        scratch = eds.clone()
        scratch[unknown_cells] = upload(
            rng.integers(0, 256, (int(unknown_cells.sum()), 512), dtype=np.uint8))
        # K8b's Leopard kernel, its bit-GEMM and their plain versions, each on
        # its own copy
        scratch_plain, scratch_gemm, scratch_gemm_plain = (scratch.clone() for _ in range(3))
        # K8b's yardstick: its bit-GEMM (the unknown rows of each D, lifted,
        # against the known cells' bit planes) as one fp16 torch.bmm, exact for
        # 0/1 operands and sums <= 8k (torch._int_mm takes no batch)
        known25_np = known25.cpu().numpy()
        unknown25 = upload(np.stack([np.setdiff1d(np.arange(n2), kn) for kn in known25_np]))
        D_unknown = torch.gather(D25, 1, unknown25.long()[:, :, None].expand(-1, -1, k))
        Dh = rs._bit_expand_dev(D_unknown, codec).half()
        Xh = rs.unpack_bits(rs._gather_known(eds, known25)).half()
        del D_unknown
        # K8c's inputs at k = 128: a re-extension differing in 8 cells, provided
        # shares differing in 8 available cells and 8 withheld ones (only the
        # available ones are flagged)
        rec25, prov25 = eds.clone(), eds.clone()
        av25 = upload(avail25.astype(np.uint8))
        want_mm = np.zeros((n2, n2), dtype=bool)
        want_pm = np.zeros((n2, n2), dtype=bool)
        flat = rng.permutation(n2 * n2)
        for i, cell in enumerate(flat[:8]):
            r, c = divmod(int(cell), n2)
            rec25[r, c, (37 * i) % 512] ^= 1 + i
            want_mm[r, c] = True
        held = flat[8:][avail25.reshape(-1)[flat[8:]]][:8]
        withheld = flat[8:][~avail25.reshape(-1)[flat[8:]]][:8]
        for i, cell in enumerate(np.concatenate([held, withheld])):
            r, c = divmod(int(cell), n2)
            prov25[r, c, (101 * i) % 512] ^= 0x80
            want_pm[r, c] = bool(avail25[r, c])
        check(want_pm.sum() == 8, "the k=128 verdict case has not 8 available cells to flip")
        # K5b at the catch-up batch: 8 squares of k = 128; its yardstick is the
        # bit-GEMM of the 8 squares as one torch._int_mm, as for K5
        sq8 = upload(rng.integers(0, 256, (8, k, k, 512), dtype=np.uint8))
        bits8 = torch.cat([bits] * 8, dim=1)
        # K9 at k = 128 over R = 8 shards, every shard, on the k = 128 EDS's rows:
        # K5's row pass on each shard's rows, K9a's partials (which XOR to the
        # parity rows), K9b over the partials' slabs in place, K2 over its windows
        R9, rows9 = SHARDS, k // SHARDS
        tops, coeffs9, gemm_coeffs9, g_cols9, partials9 = [], [], [], [], []
        for d in range(R9):
            got = rs.extend_rows_cuda(sq[d * rows9 : (d + 1) * rows9], codec)
            compare("rs_extend", got, rs.extend_rows_plain(sq[d * rows9 : (d + 1) * rows9], codec),
                    f"row pass of shard {d} of {R9} at k=128 against its plain version")
            compare("rs_extend", got, eds[d * rows9 : (d + 1) * rows9],
                    f"row pass of shard {d} of {R9} at k=128 against the EDS's rows")
            top = eds[d * rows9 : (d + 1) * rows9][None]  # (1, k/R, 2k, 512): Q0 | Q1 rows
            tops.append(top)
            coeffs9.append(rs.partial_coefficients(k, d * rows9, rows9, codec, dev))
            gemm_coeffs9.append(rs.bit_gemm_partial_coefficients(k, d * rows9, rows9, codec, dev))
            g_cols9.append(G[:, 8 * d * rows9 : 8 * (d + 1) * rows9].contiguous())
            partials9.append(rs.col_parity_partial_cuda(top, *coeffs9[d]))
            compare("rs_col_parity_partial", partials9[d],
                    rs.col_parity_partial_plain(top, g_cols9[d]), f"shard {d} of {R9} at k=128")
        compare("rs_col_parity_partial", rs.xor_reduce_slabs_plain(torch.stack(partials9))[0],
                eds[k:], "the 8 partials' XOR against the EDS's parity rows")
        # K9b: slab d of every partial, read in place, into shard d's parity rows,
        # every shard in one launch
        slabs9 = [[p.narrow(1, d * rows9, rows9) for p in partials9] for d in range(R9)]
        outs9 = [torch.empty((1, rows9, n2, 512), dtype=torch.uint8, device=dev) for _ in range(R9)]
        rs.xor_reduce_scatter_cuda(partials9, range(R9), outs9, 1)
        for d in range(R9):
            got = outs9[d]
            compare("xor_reduce_slabs", got, rs.xor_reduce_slabs_plain(torch.stack(slabs9[d])),
                    f"shard {d} of {R9} at k=128")
            compare("xor_reduce_slabs", got[0], eds[k + d * rows9 : k + (d + 1) * rows9],
                    f"shard {d}'s parity rows")
            for row0 in (d * rows9, k + d * rows9):
                window = eds[row0 : row0 + rows9]
                got = nmt.leaf_digests_window(window, row0)
                compare("nmt_leaf_digests", got, grid[row0 : row0 + rows9],
                        f"row window {row0}..{row0 + rows9 - 1} against the full-EDS call")
                compare("nmt_leaf_digests", got, nmt.leaf_digests_window_plain(window, row0),
                        f"row window {row0}..{row0 + rows9 - 1} against its plain version")
        # the library yardstick of K9a: torch._int_mm of each shard's bit-GEMM
        # slice, G[:, 8 j0 : 8 (j0 + k/R)] against its rows' bit planes by column
        bits9 = [rs.unpack_bits(t[0].transpose(0, 1)).permute(1, 0, 2).reshape(8 * rows9, n2 * 512)
                 .contiguous() for t in tops]
        # in-place K9b at k = 64 and 128 over R = 1, 2, 4, 8 shards, a batch of 2
        # squares a partial (each slab two runs), every shard in one launch
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for kk in (64, 128):
            for R in (1, 2, 4, 8):
                m = kk // R
                parts = [torch.randint(0, 256, (2, kk, 2 * kk, 512), dtype=torch.uint8, device=dev,
                                       generator=gen) for _ in range(R)]
                slabs = [[p.narrow(1, d * m, m) for p in parts] for d in range(R)]
                outs = [torch.empty((2, m, 2 * kk, 512), dtype=torch.uint8, device=dev)
                        for _ in range(R)]
                rs.xor_reduce_scatter_cuda(parts, range(R), outs, 1)
                for d in range(R):
                    compare("xor_reduce_slabs", outs[d],
                            rs.xor_reduce_slabs_plain(torch.stack(slabs[d])),
                            f"in place, shard {d} of {R} at k={kk}, batch of 2")
        del parts, slabs, outs
        print(f"K9 at k=128, R={R9}: row passes, K9a partials (XOR = parity rows), K9b in place and "
              "K2 row windows byte-equal to their plain versions and the single-device EDS; K9b in "
              "place at k=64, 128 x R=1, 2, 4, 8 (batch of 2) byte-equal to its plain version")
        timings = {
            "sha256_batch": (
                lambda: nmt.rfc6962_leaf_hashes(rand_roots),
                lambda: nmt.rfc6962_leaf_hashes_plain(rand_roots),
                None,
                bound(4 * k * (90 + 32),
                      4 * k * compressions(91) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
            ),
            "nmt_leaf_digests": (
                lambda: nmt.eds_leaf_digests(eds),
                lambda: nmt.eds_leaf_digests_plain(eds),
                None,
                bound(n2 * n2 * (512 + 90),
                      n2 * n2 * compressions(542) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
            ),
            "nmt_combine_level": (
                lambda: nmt.grid_levels(grid),
                lambda: nmt.grid_levels_plain(grid),
                None,
                # the leaf grid read once, every level (4k trees x 2k - 1 nodes) written once
                bound(n2 * n2 * 90 + parents * 90,
                      parents * compressions(181) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
            ),
            # the main path's data root: the 4k axis roots (90 bytes) read once, every
            # level written once; 4k leaf hashes and 4k - 1 inner nodes
            "rfc6962_root": (
                lambda: nmt.rfc6962_levels(rand_roots),
                lambda: nmt.rfc6962_levels_plain(rand_roots),
                None,
                bound(4 * k * 90 + (8 * k - 1) * 32,
                      (4 * k * compressions(91) + (4 * k - 1) * compressions(65))
                      * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
            ),
            "rs_extend": (
                lambda: rs.extend_cuda(sq, codec),
                lambda: rs.extend_plain(sq, codec),
                # the GEMM part only: G int8[8k, 8k] @ bits int8[8k, 3k*512]
                lambda: torch._int_mm(G, bits),
                bound(k * k * 512 + n2 * n2 * 512, leopard_extend_ops(k), INT32_OPS_PER_S),
            ),
            # the same function by the bit-GEMM kernel, given leopard's E
            "rs_extend_bit_gemm": (
                lambda: rs.extend_bit_gemm_cuda(sq, codec),
                lambda: rs.extend_plain(sq, codec),
                lambda: torch._int_mm(G, bits),
                bound(k * k * 512 + n2 * n2 * 512, leopard_extend_ops(k), INT32_OPS_PER_S),
            ),
            # the main path's cell mode
            "das_proof_gather": (
                lambda: gather.launch_cells(g_sources, g_layout, g_cells_dev, g_out),
                lambda: gather.das_proof_gather_plain(g_sources, g_items, g_bytes),
                library_gather,
                # each item read once, each record written once, and the triples
                bound(g_payload + g_bytes + g_cells.nbytes, 0, INT32_OPS_PER_S),
            ),
            "rs_extend_batched": (
                lambda: rs.extend_batched_cuda(sq8, codec),
                lambda: rs.extend_batched_plain(sq8, codec),
                lambda: torch._int_mm(G, bits8),
                bound(8 * (k * k * 512 + n2 * n2 * 512), 8 * leopard_extend_ops(k), INT32_OPS_PER_S),
            ),
            "rs_extend_batched_bit_gemm": (
                lambda: rs.extend_batched_bit_gemm_cuda(sq8, codec),
                lambda: rs.extend_batched_plain(sq8, codec),
                lambda: torch._int_mm(G, bits8),
                bound(8 * (k * k * 512 + n2 * n2 * 512), 8 * leopard_extend_ops(k), INT32_OPS_PER_S),
            ),
            "rs_decode_matrices": (
                lambda: rs.decode_matrices_cuda(known25, k, codec),
                lambda: rs._decode_matrices_dev(known25, k, codec),
                None,
                bound(N25 * k + N25 * n2 * k, decode_matrix_ops(k, N25), INT32_OPS_PER_S),
            ),
            # Leopard's decode, which the path runs (no D)
            "rs_decode_axes": (
                lambda: rs.decode_axes_cuda(scratch, None, known25, axes25, False, codec),
                lambda: rs.decode_axes_fft_plain(scratch_plain, known25, axes25, False),
                lambda: torch.bmm(Dh, Xh),
                # the k known cells read and the k unknown ones written per axis, the
                # index tables read once
                bound(2 * N25 * k * 512 + N25 * (k + 4), leopard_decode_ops(k, N25),
                      INT32_OPS_PER_S),
            ),
            # the same function by the bit-GEMM kernel with K8a's matrices
            "rs_decode_axes_bit_gemm": (
                lambda: rs.decode_axes_bit_gemm_cuda(scratch_gemm, D25, known25, axes25, False,
                                                     codec),
                lambda: rs.decode_axes_plain(scratch_gemm_plain, D25, known25, axes25, False,
                                             codec),
                lambda: torch.bmm(Dh, Xh),
                # as above, and D read once
                bound(2 * N25 * k * 512 + N25 * n2 * k + N25 * (k + 4),
                      leopard_decode_ops(k, N25), INT32_OPS_PER_S),
            ),
            "rs_repair_verdicts": (
                lambda: rs.repair_verdicts_cuda(eds, rec25, prov25, av25),
                lambda: rs.repair_verdicts_plain(eds, rec25, prov25, av25),
                # two (a != b).any(-1) calls, one per mask
                lambda: ((eds != rec25).any(-1), (eds != prov25).any(-1)),
                bound(3 * n2 * n2 * 512 + 3 * n2 * n2, 0, INT32_OPS_PER_S),
            ),
            # K9a and K9b over all R = 8 shards of a k = 128 square, one call each
            # (K9a the path's Leopard form, then its bit-GEMM given leopard's E)
            "rs_col_parity_partial": (
                lambda: [rs.col_parity_partial_cuda(t, *c) for t, c in zip(tops, coeffs9)],
                lambda: [rs.col_parity_partial_plain(t, g) for t, g in zip(tops, g_cols9)],
                lambda: [torch._int_mm(g, b) for g, b in zip(g_cols9, bits9)],
                # the top rows read once (16 MiB), R partials written (128 MiB); the
                # R shards' pruned Leopard transforms, the least-work form
                bound(k * n2 * 512 + R9 * k * n2 * 512, leopard_partial_ops(k, R9),
                      INT32_OPS_PER_S),
            ),
            "rs_col_parity_partial_bit_gemm": (
                lambda: [rs.col_parity_partial_bit_gemm_cuda(t, *c)
                         for t, c in zip(tops, gemm_coeffs9)],
                lambda: [rs.col_parity_partial_plain(t, g) for t, g in zip(tops, g_cols9)],
                lambda: [torch._int_mm(g, b) for g, b in zip(g_cols9, bits9)],
                bound(k * n2 * 512 + R9 * k * n2 * 512, leopard_partial_ops(k, R9),
                      INT32_OPS_PER_S),
            ),
            "xor_reduce_slabs": (
                lambda: rs.xor_reduce_scatter_cuda(partials9, range(R9), outs9, 1),
                lambda: [rs.xor_reduce_slabs_plain(torch.stack(s)) for s in slabs9],
                # a torch.bitwise_xor fold over each shard's R slabs, read in place
                lambda: [functools.reduce(torch.bitwise_xor, s) for s in slabs9],
                # R slabs read and one written per shard; R - 1 XORs per 4 bytes
                bound(R9 * (R9 + 1) * rows9 * n2 * 512, R9 * (R9 - 1) * rows9 * n2 * 512 // 4,
                      INT32_OPS_PER_S),
            ),
        }
        for name, (fast, plain, lib, (b_ms, b_by)) in timings.items():
            perf[name] = {
                "ms": time_ms(fast),
                "gpu_ms": time_ms(fast, queued=True),
                "plain_ms": time_ms(plain, reps=3),
                "library_ms": time_ms(lib) if lib is not None else None,
                "bound_ms": b_ms,
                "bound_by": b_by,
            }
            lib_ms = perf[name]["library_ms"]
            print(f"{name}: {perf[name]['ms']:.4f} ms as issued (GPU time "
                  f"{perf[name]['gpu_ms']:.4f} ms, queued), plain {perf[name]['plain_ms']:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} | {smi}")
        # K5's and K5b's two kernels at k = 64 and 128 (8 squares for K5b), the
        # FFT (leopard-ff8) and the bit-GEMM given leopard's E, and K8b's two,
        # Leopard's decode and the bit-GEMM with K8a's matrices, on the 2k rows
        # of a 25 % mask at k = 64 and 128; GPU time (queued), in turns: FFT,
        # bit-GEMM, bit-GEMM, FFT, FFT, bit-GEMM
        sq64 = upload(rng.integers(0, 256, (64, 64, 512), dtype=np.uint8))
        sq8_64 = upload(rng.integers(0, 256, (8, 64, 64, 512), dtype=np.uint8))
        eds64 = rs.extend_cuda(sq64, codec)
        known64, axes64, segs64 = rs._schedule_tensors(
            rs._simulate_schedule(rng.random((128, 128)) >= 0.25, 64), dev)
        check(segs64 == [(0, 128, False)], f"the k=64 25 % mask's schedule is {segs64}")
        D64 = rs.decode_matrices_cuda(known64, 64, codec)
        dec64, dec64_gemm, dec128_gemm = eds64.clone(), eds64.clone(), eds.clone()
        one_row, one_row_gemm = eds.clone(), eds.clone()  # one row, as a deep-peel phase
        # K9a's two forms at k = 64, R = 8 over the 8 shards of the k = 64 EDS
        # (and at k = 128 over the timings' tops): Leopard's pruned encode and
        # the bit-GEMM given leopard's E
        rows64 = 64 // R9
        tops64 = [eds64[d * rows64 : (d + 1) * rows64][None] for d in range(R9)]
        k9a64 = [rs.partial_coefficients(64, d * rows64, rows64, codec, dev) for d in range(R9)]
        k9a64_gemm = [rs.bit_gemm_partial_coefficients(64, d * rows64, rows64, codec, dev)
                      for d in range(R9)]
        turn_pairs = {
            "rs_extend k=64": (lambda: rs.extend_cuda(sq64, codec),
                               lambda: rs.extend_bit_gemm_cuda(sq64, codec)),
            "rs_extend k=128": (lambda: rs.extend_cuda(sq, codec),
                                lambda: rs.extend_bit_gemm_cuda(sq, codec)),
            "rs_extend_batched n=8 k=64": (lambda: rs.extend_batched_cuda(sq8_64, codec),
                                           lambda: rs.extend_batched_bit_gemm_cuda(sq8_64, codec)),
            "rs_extend_batched n=8 k=128": (lambda: rs.extend_batched_cuda(sq8, codec),
                                            lambda: rs.extend_batched_bit_gemm_cuda(sq8, codec)),
            "rs_decode_axes 2k rows k=64": (
                lambda: rs.decode_axes_cuda(dec64, None, known64, axes64, False, codec),
                lambda: rs.decode_axes_bit_gemm_cuda(dec64_gemm, D64, known64, axes64, False,
                                                     codec)),
            "rs_decode_axes 2k rows k=128": (
                lambda: rs.decode_axes_cuda(scratch, None, known25, axes25, False, codec),
                lambda: rs.decode_axes_bit_gemm_cuda(dec128_gemm, D25, known25, axes25, False,
                                                     codec)),
            "rs_decode_axes 1 row k=128": (
                lambda: rs.decode_axes_cuda(one_row, None, known25[:1], axes25[:1], False, codec),
                lambda: rs.decode_axes_bit_gemm_cuda(one_row_gemm, D25[:1], known25[:1],
                                                     axes25[:1], False, codec)),
            f"rs_col_parity_partial {R9} shards k=64": (
                lambda: [rs.col_parity_partial_cuda(t, *c) for t, c in zip(tops64, k9a64)],
                lambda: [rs.col_parity_partial_bit_gemm_cuda(t, *c)
                         for t, c in zip(tops64, k9a64_gemm)]),
            f"rs_col_parity_partial {R9} shards k=128": (
                lambda: [rs.col_parity_partial_cuda(t, *c) for t, c in zip(tops, coeffs9)],
                lambda: [rs.col_parity_partial_bit_gemm_cuda(t, *c)
                         for t, c in zip(tops, gemm_coeffs9)]),
        }
        in_turns = {"rs_extend": "k5_in_turns", "rs_decode_axes": "k8b_in_turns",
                    "rs_col_parity_partial": "k9a_in_turns"}
        for key in in_turns.values():
            results[key] = {}
        for what, fns in turn_pairs.items():
            got = {"fft": [], "bit_gemm": []}
            for turn in ("fft", "bit_gemm", "bit_gemm", "fft", "fft", "bit_gemm"):
                got[turn].append(time_ms(fns[turn == "bit_gemm"], queued=True))
            results[in_turns[what.split()[0].replace("_batched", "")]][what] = got
            ratio = statistics.median(got["bit_gemm"]) / statistics.median(got["fft"])
            print(f"{what}, GPU time in turns: FFT {', '.join(f'{v:.4f}' for v in got['fft'])} ms, "
                  f"bit-GEMM {', '.join(f'{v:.4f}' for v in got['bit_gemm'])} ms (bit-GEMM / FFT "
                  f"{ratio:.2f}x) | {smi}")
        for name, got, want in (("rs_decode_axes", dec64, eds64),
                                ("rs_decode_axes_bit_gemm", dec64_gemm, eds64),
                                ("rs_decode_axes_bit_gemm", dec128_gemm, eds),
                                ("rs_decode_axes", one_row, eds),
                                ("rs_decode_axes_bit_gemm", one_row_gemm, eds)):
            compare(name, got, want, "the rows decoded in turns against the codeword")
        del eds64, known64, axes64, D64, dec64, dec64_gemm, dec128_gemm, one_row, one_row_gemm
        for d in range(R9):
            compare("rs_col_parity_partial", rs.col_parity_partial_cuda(tops64[d], *k9a64[d]),
                    rs.col_parity_partial_bit_gemm_cuda(tops64[d], *k9a64_gemm[d]),
                    f"shard {d} of {R9} at k=64 (timed in turns) against the bit-GEMM")
        del sq64, sq8_64, turn_pairs, tops64, k9a64, k9a64_gemm
        # K7b's table mode on the same 1,024 cells (the range proofs' mode), and
        # its latency floor: an empty launch and a launch with one load that the
        # store waits on (gather.dependent_load_probe), timed as gpu_ms is
        compare("das_proof_gather", g_out, g_want, "cell mode, 1,024 cells at k=128 (after timing)")
        table_mode = {"ms": time_ms(lambda: gather.launch_gather(g_sources, g_items_dev, g_out)),
                      "gpu_ms": time_ms(lambda: gather.launch_gather(g_sources, g_items_dev, g_out),
                                        queued=True),
                      "items": int(g_items.shape[0]), "table_bytes": int(g_items.nbytes)}
        compare("das_proof_gather", g_out, g_want, "table mode, 1,024 cells at k=128 (after timing)")
        probe_src = torch.zeros(512, dtype=torch.uint8, device=dev)
        probe_dst = torch.empty(512, dtype=torch.uint8, device=dev)
        probe = {loads: statistics.median(
            time_ms(lambda: gather.dependent_load_probe(probe_src, probe_dst, loads), reps=16,
                    queued=True) for _ in range(5)) for loads in (0, 1)}
        results["das_proof_gather_table_mode"] = table_mode
        results["dependency_floor"] = {"das_proof_gather": probe[1], "empty_launch_ms": probe[0]}
        print(f"das_proof_gather table mode (18 items a cell, a {g_items.nbytes:,}-byte table): "
              f"{table_mode['ms']:.4f} ms as issued (GPU time {table_mode['gpu_ms']:.4f} ms); cell mode "
              f"GPU time {perf['das_proof_gather']['gpu_ms']:.4f} ms against its latency floor "
              f"{probe[1]:.4f} ms (one launch with one dependent load, queued; an empty launch "
              f"{probe[0]:.4f} ms) and its byte bound {perf['das_proof_gather']['bound_ms']:.4f} ms "
              f"| {smi}")
        # the launch sequences' bounds, the sums of their kernels' at these
        # shapes: K6/K7a's extension of one k = 128 square (K5, K2, K3, K4 from
        # the 4k roots), and K9's over R = 8 shards (the row passes -- Q0 read,
        # Q0 | Q1 written --, K9a, K9b, K2 and K3 over the shards, K4)
        row_pass_ms, _ = bound(k * k * 512 + k * n2 * 512, 0, INT32_OPS_PER_S)
        seq_bounds = {
            "K6/K7a extend_and_header k=128": sum(perf[n]["bound_ms"] for n in (
                "rs_extend", "nmt_leaf_digests", "nmt_combine_level", "rfc6962_root")),
            f"K9 extend_and_header_sharded k=128 R={R9}": row_pass_ms + sum(perf[n]["bound_ms"] for n in (
                "rs_col_parity_partial", "xor_reduce_slabs", "nmt_leaf_digests", "nmt_combine_level",
                "rfc6962_root")),
        }
        results["sequence_bounds_ms"] = seq_bounds
        for name, b_ms in seq_bounds.items():
            print(f"{name}: bound {b_ms:.4f} ms (the sum of its kernels' bounds) | {smi}")
        # K4's per-level latency in the kernel: the slope of its GPU time at batch
        # 1 over n = 2..1024 leaves (log2 n + 1 levels of 2 compressions, words in
        # registers), a least-squares line through the 10 points, and over the
        # levels warp 0 runs alone (n = 2..32).  Half the latter is one
        # compression's latency in the kernel, the yardstick of the tree kernels'
        # dependency floors below (an upper estimate: a level also syncs the warp
        # and stores its nodes).
        tree_ms = {}
        for lg in range(1, 11):
            leaves = upload(rng.integers(0, 256, (1 << lg, 90), dtype=np.uint8))
            tree_ms[lg] = statistics.median(
                time_ms(lambda: nmt.rfc6962_levels(leaves), reps=16, queued=True) for _ in range(3))
        slope_all = float(np.polyfit(list(tree_ms), list(tree_ms.values()), 1)[0])
        slope_warp = float(np.polyfit(range(1, 6), [tree_ms[lg] for lg in range(1, 6)], 1)[0])
        compression_ms = slope_warp / 2
        # K1's time per block on one message of CHAIN_BLOCKS blocks less its time
        # on one of 1 block, over the blocks between them (the launch and the
        # message's first load and digest store cancel), queued behind a sleep so
        # the card runs them back to back: a compression whose block's words come
        # from L2.  K1's own floor on the main path's 512 independent 2-block
        # messages: one launch (K1 on one 1-block message) and one more block.
        chain = {}
        for blocks in (1, CHAIN_BLOCKS):
            msg = upload(rng.integers(0, 256, (1, 64 * blocks - 9), dtype=np.uint8))
            chain[blocks] = statistics.median(
                time_ms(lambda: sha256_cuda(msg), reps=16, queued=True) for _ in range(5))
        k1_compression_ms = (chain[CHAIN_BLOCKS] - chain[1]) / (CHAIN_BLOCKS - 1)
        k1_floor_ms = chain[1] + k1_compression_ms
        results["rfc6962_root_level_latency"] = {
            "gpu_ms_by_leaves": {1 << lg: v for lg, v in tree_ms.items()},
            "ms_per_level": slope_all, "ms_per_level_warp_levels": slope_warp,
            "compression_ms": compression_ms, "per_compression_all_levels_ms": slope_all / 2,
            "k1_compression_ms": k1_compression_ms}
        print("rfc6962_root GPU time at batch 1 by leaves: "
              + ", ".join(f"{1 << lg} {v:.4f}" for lg, v in tree_ms.items())
              + f" ms; slope {slope_warp * 1e3:.4f} us a level over n = 2..32 (warp 0 alone: "
              f"{compression_ms * 1e3:.4f} us a compression), {slope_all * 1e3:.4f} us a level over "
              f"n = 2..1024 ({slope_all * 5e2:.4f} us a compression); K1 on one message of "
              f"{CHAIN_BLOCKS} blocks {chain[CHAIN_BLOCKS]:.4f} ms less one of 1 block "
              f"{chain[1]:.4f} ms, over {CHAIN_BLOCKS - 1} blocks: {k1_compression_ms * 1e3:.4f} us "
              f"a compression from L2 | {smi}")
        results["dependency_floor"].update({"compression_ms": compression_ms,
                                       "k1_compression_ms": k1_compression_ms,
                                       "k1_one_block_ms": chain[1],
                                       f"k1_{CHAIN_BLOCKS}_blocks_ms": chain[CHAIN_BLOCKS],
                                       "sha256_batch": k1_floor_ms})
        print(f"sha256_batch: dependency floor {k1_floor_ms:.4f} ms (one launch, K1 on a 1-block "
              f"message {chain[1]:.4f} ms, + one block at K1's {k1_compression_ms * 1e3:.4f} us); "
              f"GPU time {perf['sha256_batch']['gpu_ms']:.4f} ms, bound "
              f"{perf['sha256_batch']['bound_ms']:.6f} ms ({perf['sha256_batch']['bound_by']}) | {smi}")
        # the tree kernels' dependency floor: their levels run one after another,
        # each a chain of compressions (K3: log2(2k) levels of one 181-byte node,
        # 3 compressions; K4: the leaf level and log2(4k) inner levels, 2 each),
        # at the in-kernel compression latency; the same chain at K1's L2-fed
        # latency printed beside it
        for name, levels_, per_level in (("nmt_combine_level", n2.bit_length() - 1, compressions(181)),
                                         ("rfc6962_root", (4 * k).bit_length(), compressions(65))):
            floor_ms = levels_ * per_level * compression_ms
            results["dependency_floor"][name] = floor_ms
            print(f"{name}: dependency floor {floor_ms:.4f} ms ({levels_} levels x {per_level} "
                  f"compressions at {compression_ms * 1e3:.4f} us each, in K4); GPU time "
                  f"{perf[name]['gpu_ms']:.4f} ms = {perf[name]['gpu_ms'] / floor_ms:.2f}x it, as "
                  f"issued {perf[name]['ms']:.4f} ms; at K1's L2-fed latency the chain takes "
                  f"{levels_ * per_level * k1_compression_ms:.4f} ms; bound "
                  f"{perf[name]['bound_ms']:.6f} ms ({perf[name]['bound_by']}) | {smi}")
        sass = kernel_sass_mix("rfc6962_tree_kernel")
        results["rfc6962_root_sass"] = sass
        print(f"rfc6962_root SASS (cuobjdump -sass of the built library): {sass}")
        # K3's level floor (level_floor_ms) beside its GPU time: one grid's 4k
        # trees at k = 64 and 128 here, the catch-up batch and the row stacks'
        # levels below
        k3_floor = results["k3_level_floor"] = {}

        def k3_against_floor(case: str, gpu_ms: float, parents: list) -> None:
            floor_ms = level_floor_ms(parents, compression_ms)
            k3_floor[case] = {"gpu_ms": gpu_ms, "level_floor_ms": floor_ms,
                              "share": floor_ms / gpu_ms}
            print(f"nmt_combine_level {case}: GPU time {gpu_ms:.4f} ms, level floor "
                  f"{floor_ms:.4f} ms ({len(parents)} levels, each the longer of its "
                  f"compressions at the int32 rate and 3 at {compression_ms * 1e3:.4f} us), "
                  f"{100 * floor_ms / gpu_ms:.1f} % of it | {smi}")

        k3_against_floor("grid k=64", time_ms(lambda: nmt.grid_levels(grid64), queued=True),
                         tree_parents(4 * 64, 128))
        k3_against_floor("grid k=128", perf["nmt_combine_level"]["gpu_ms"],
                         tree_parents(4 * k, n2))
        del grid64
        # K3's instances, one a tile of 2^8, 2^9, 2^10 level-0 nodes: registers and
        # spills (STACK, LOCAL) and their SASS
        results["nmt_combine_level_kernel"] = {}
        for lg_tile in (8, 9, 10):
            name = f"nmt_reduce_kernelILj{lg_tile}E"
            k3_res, k3_sass = kernel_resources(name), kernel_sass_mix(name)
            results["nmt_combine_level_kernel"][lg_tile] = {"resources": k3_res, "sass": k3_sass}
            print(f"nmt_combine_level kernel, tile of {1 << lg_tile} (cuobjdump): resources "
                  f"{k3_res}; SASS {k3_sass['instructions']} instructions; opcodes "
                  f"{k3_sass['most_common']}; LDS {k3_sass['LDS']} STS {k3_sass['STS']} LDG "
                  f"{k3_sass['LDG']} STG {k3_sass['STG']} BAR {k3_sass['BAR']} LDL {k3_sass['LDL']} "
                  f"STL {k3_sass['STL']}; longest load-free runs {k3_sass['longest_load_free_runs']}")
            check(k3_res.get("REG", 256) <= 128 and not k3_res.get("STACK")
                  and not k3_res.get("LOCAL") and not k3_sass["LDL"] and not k3_sass["STL"],
                  f"K3's tile of {1 << lg_tile} needs at most 128 registers and no spill: {k3_res}")
        # the bit-GEMM kernels against the tensor-core floor of their form (K5
        # and K5b by their bit-GEMM kernel, which lagrange-gf256 runs): K5 the
        # three quadrants' 8k x 8k GEMMs over k axes of 512 bytes, K5b 8 squares of
        # it, K8b the 25 % mask's 2k rows (8k unknown bit rows, 8k deep each), K9a
        # the 8 shards' 8k x 8(k/R) GEMMs over 2k columns
        floors = {
            "rs_extend_bit_gemm": bit_gemm_ops(8 * k, 8 * k, 3 * k * 512),
            "rs_extend_batched_bit_gemm": 8 * bit_gemm_ops(8 * k, 8 * k, 3 * k * 512),
            "rs_decode_axes_bit_gemm": N25 * bit_gemm_ops(8 * k, 8 * k, 512),
            "rs_col_parity_partial_bit_gemm": R9 * bit_gemm_ops(8 * k, 8 * rows9, n2 * 512),
        }
        results["tensor_core_floor"] = {}
        for name, ops in floors.items():
            floor_ms = ops / INT8_TENSOR_OPS_PER_S * 1e3
            share = floor_ms / perf[name]["ms"]
            results["tensor_core_floor"][name] = {"ops": ops, "floor_ms": floor_ms, "share": share}
            print(f"{name}: tensor-core floor {floor_ms:.4f} ms ({ops / 1e9:.1f} G int8 ops at "
                  f"1,979 TOPS), achieved {100 * share:.1f} % of it in {perf[name]['ms']:.4f} ms "
                  f"(bound {perf[name]['bound_ms']:.4f} ms, plain {perf[name]['plain_ms']:.3f} ms, "
                  f"library {perf[name]['library_ms']:.4f} ms) | {smi}")
        # the FFT kernel's k = 128 instance: registers and spills (STACK, LOCAL)
        # and its SASS; a column's two threads compute 4 bytes of each of k
        # parity shares in k log2 k butterflies on a word
        fft_res = kernel_resources("rs_leopard_kernelILj7E")
        fft_sass = kernel_sass_mix("rs_leopard_kernelILj7E")
        results["rs_extend_fft_kernel"] = {"resources": fft_res, "sass": fft_sass}
        print(f"rs_extend FFT kernel, k=128 instance (cuobjdump): resources {fft_res}; SASS "
              f"{fft_sass['instructions']} instructions a thread, "
              f"{2 * fft_sass['instructions'] / (4 * k):.2f} a parity byte, "
              f"{2 * fft_sass['instructions'] / (k * (k.bit_length() - 1)):.2f} a butterfly word; "
              f"opcodes {fft_sass['most_common']}; LDL {fft_sass['LDL']} STL {fft_sass['STL']}")
        # K8b's Leopard kernel, its k = 128 instances (2k = 256 points), one a
        # launch shape: 2^C threads a column decode 4 bytes of each of the k
        # erased positions
        results["rs_decode_axes_leopard_kernel"] = {}
        for c, shape in ((3, "66 axes or more"), (4, "9-65 axes"), (5, "at most 8 axes")):
            name = f"rs_leopard_decode_kernelILj8ELj{c}E"
            dec_res, dec_sass = kernel_resources(name), kernel_sass_mix(name)
            results["rs_decode_axes_leopard_kernel"][shape] = {"resources": dec_res,
                                                               "sass": dec_sass}
            print(f"rs_decode_axes Leopard kernel, k=128, {1 << c} threads a column ({shape}; "
                  f"cuobjdump): resources {dec_res}; SASS {dec_sass['instructions']} instructions a "
                  f"thread, {(1 << c) * dec_sass['instructions'] / (4 * k):.2f} a decoded byte; "
                  f"opcodes {dec_sass['most_common']}; PRMT {dec_sass['PRMT']} LDS "
                  f"{dec_sass['LDS']} LDG {dec_sass['LDG']} STG {dec_sass['STG']} LDL "
                  f"{dec_sass['LDL']} STL {dec_sass['STL']}")
        # K9a's Leopard kernel, its k = 128 instances, one an m = k/R: a
        # column's two threads write 4 bytes of each of the k parity positions
        # of the shard's partial; in those of R = 8 (m = 16, the sharded path's)
        # and R = 4 (m = 32, the App's mesh leg) more than 128 registers or a
        # spill fails the phase
        results["rs_col_parity_partial_leopard_kernel"] = {}
        for lg_m in range(8):
            name = f"rs_leopard_partial_kernelILj7ELj{lg_m}E"
            k9a_res, k9a_sass = kernel_resources(name), kernel_sass_mix(name)
            results["rs_col_parity_partial_leopard_kernel"][f"m={1 << lg_m}"] = {
                "resources": k9a_res, "sass": k9a_sass}
            print(f"rs_col_parity_partial Leopard kernel, k=128, m={1 << lg_m} (cuobjdump): "
                  f"resources {k9a_res}; SASS {k9a_sass['instructions']} instructions a thread, "
                  f"{2 * k9a_sass['instructions'] / (4 * k):.2f} a partial byte; opcodes "
                  f"{k9a_sass['most_common']}; PRMT {k9a_sass['PRMT']} LDS {k9a_sass['LDS']} LDG "
                  f"{k9a_sass['LDG']} STG {k9a_sass['STG']} LDL {k9a_sass['LDL']} STL "
                  f"{k9a_sass['STL']}")
            check(lg_m not in (4, 5) or (
                      k9a_res.get("REG", 256) <= 128 and not k9a_res.get("STACK")
                      and not k9a_res.get("LOCAL") and not k9a_sass["LDL"] and not k9a_sass["STL"]),
                  f"K9a's k=128, m={1 << lg_m} instance needs at most 128 registers and no "
                  f"spill: {k9a_res}")
        # the row level stacks behind proofs, namespace data, BEFPs and DAS misses
        # (ops/nmt.py eds_row_level_stack: K2's row-set mode, then K3) at R = 1, 5
        # and 2k rows of the k = 128 EDS, as issued and GPU time.  Beside them,
        # step by step, the K1 path they replace (gather, prefix build, K1, digest
        # cat, K3, and the whole), K2 over the same rows taken as one window, and
        # the row-set mode alone, in place and from a gathered block (da/proof.py
        # keeps the rows K7b reads).  The dependency floor of a row stack: a
        # leaf's 9 compressions and log2(2k) levels of 3, one after another
        row_floor_ms = (compressions(542) + (n2.bit_length() - 1) * compressions(181)) * compression_ms
        results["row_stacks"] = {"dependency_floor_ms": row_floor_ms}
        for R in (1, 5, n2):
            ab_rows = list(range(R))
            ab_block, ab_idx = nmt.eds_rows(eds, ab_rows)
            ab_leaves = nmt.row_leaves(ab_block, ab_idx)
            ab_hash = nmt.rfc6962_leaf_hashes(ab_leaves)
            ab_digests = nmt.leaf_digests(ab_leaves)
            k1_path = nmt.nmt_level_stack(ab_leaves)
            for got, want in zip(nmt.eds_row_level_stack(eds, ab_rows), k1_path):
                compare("nmt_combine_level" if got.shape[-2] < n2 else "nmt_leaf_digests", got, want,
                        f"{R}-row stack against the K1 path, level of {want.shape[-2]}")
            compare("nmt_leaf_digests", nmt.row_leaf_digests(ab_block, ab_rows), ab_digests,
                    f"{R} gathered rows against the K1 path's leaf digests")
            compare("nmt_leaf_digests", nmt.leaf_digests_window(eds[:R], 0), ab_digests,
                    f"window of rows 0..{R - 1} against the K1 path's leaf digests")
            steps = {
                "eds_rows": lambda: nmt.eds_rows(eds, ab_rows),
                "prefix_build": lambda: nmt.row_leaves(ab_block, ab_idx),
                "k1": lambda: nmt.rfc6962_leaf_hashes(ab_leaves),
                "digest_cat": lambda: nmt._leaf_digests_with(lambda _: ab_hash, ab_leaves),
                "k3": lambda: nmt.reduce_levels(ab_digests),
                "k1_path": lambda: nmt.nmt_level_stack(nmt.eds_row_leaves(eds, ab_rows)),
                "k2_window": lambda: nmt.leaf_digests_window(eds[:R], 0),
                "k2_rows": lambda: nmt.row_leaf_digests(eds, ab_rows, in_place=True),
                "k2_rows_block": lambda: nmt.row_leaf_digests(ab_block, ab_rows),
                "k2_k3_path": lambda: nmt.eds_row_level_stack(eds, ab_rows),
            }
            ab = {name: {"ms": time_ms(fn), "gpu_ms": time_ms(fn, queued=True)}
                  for name, fn in steps.items()}
            results["row_stacks"][R] = ab
            k3_against_floor(f"row stack R={R}", ab["k3"]["gpu_ms"], tree_parents(R, n2))
            print(f"row level stack, {R} rows at k=128 (floor {row_floor_ms:.4f} ms), ms as issued "
                  "[GPU]: " + ", ".join(f"{n} {v['ms']:.4f} [{v['gpu_ms']:.4f}]" for n, v in ab.items())
                  + f" | {smi}")
            if R == 5:  # a namespace or blob spanning 5 rows of a k = 128 block
                for got, want in zip(k1_path, nmt.nmt_level_stack_plain(ab_leaves)):
                    compare("sha256_batch" if got.shape[-2] == n2 else "nmt_combine_level", got, want,
                            f"5-row K1 path against its plain version, level of {want.shape[-2]}")
                rows_plain_ms = time_ms(lambda: nmt.eds_row_level_stack_plain(eds, ab_rows), reps=3)
                rows_bound, rows_by = bound(
                    R * n2 * 512 + R * (2 * n2 - 1) * 90,
                    R * (n2 * compressions(542) + (n2 - 1) * compressions(181))
                    * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S,
                )
                new = ab["k2_k3_path"]
                results["row_level_stack_5_rows"] = {**new, "plain_ms": rows_plain_ms,
                                                     "bound_ms": rows_bound, "bound_by": rows_by,
                                                     "dependency_floor_ms": row_floor_ms}
                print(f"eds_row_level_stack, 5 rows at k=128 (K2's row-set mode, then K3 for "
                      f"{n2.bit_length() - 1} levels in one launch): {new['ms']:.4f} ms as issued (GPU "
                      f"time {new['gpu_ms']:.4f} ms = {new['gpu_ms'] / row_floor_ms:.2f}x its "
                      f"dependency floor {row_floor_ms:.4f} ms), plain {rows_plain_ms:.3f} ms, bound "
                      f"{rows_bound:.4f} ms ({rows_by}), library none | {smi}")
        del ab_block, ab_idx, ab_leaves, ab_hash, ab_digests, k1_path
        # the outputs of the timed calls at the main path's k = 128 shapes
        compare("rs_decode_axes", scratch, scratch_plain, "k=128 rows of the 25 % mask")
        check(torch.equal(scratch, eds), "K8b did not restore the k=128 codeword's unknown cells")
        compare("rs_decode_axes_bit_gemm", scratch_gemm, scratch_gemm_plain,
                "k=128 rows of the 25 % mask")
        check(torch.equal(scratch_gemm, eds),
              "K8b's bit-GEMM did not restore the k=128 codeword's unknown cells")
        for name, got, want, expect in zip(("mismatch", "provided_mismatch"),
                                           rs.repair_verdicts_cuda(eds, rec25, prov25, av25),
                                           rs.repair_verdicts_plain(eds, rec25, prov25, av25),
                                           (want_mm, want_pm)):
            compare("rs_repair_verdicts", got, want, f"k=128 {name}")
            check(np.array_equal(got.cpu().numpy().astype(bool), expect),
                  f"K8c's k=128 {name} mask flags other cells than the flipped ones")
        # the catch-up batch: K5b, then K2 over the 8 EDSs and K3 per level over
        # all 8 x 4k trees (the JAX vmap of eds_nmt_roots)
        e8 = rs.extend_batched_cuda(sq8, codec)
        compare("rs_extend_batched", e8, rs.extend_batched_plain(sq8, codec), "n=8 k=128")
        g8 = nmt.eds_leaf_digests(e8)
        compare("nmt_leaf_digests", g8, nmt.eds_leaf_digests_plain(e8), "batch of 8 EDSs at k=128")
        for j, (got, want) in enumerate(zip(nmt.grid_levels(g8), nmt.grid_levels_plain(g8)), 1):
            compare("nmt_combine_level", got, want, f"batch of 8 EDSs at k=128, level {j}")
        compare("nmt_combine_level", nmt.eds_nmt_roots(e8), nmt.eds_nmt_roots_plain(e8),
                "batched roots of 8 EDSs at k=128")
        k3_against_floor("catch-up batch of 8 grids k=128",
                         time_ms(lambda: nmt.grid_levels(g8), queued=True), tree_parents(8 * 4 * k, n2))
        del g8
        print("kernels at the main path's k=128 shapes: K8a (25 % mask's schedule), K8b (its rows, "
              "unknown cells garbage), K8c (flipped cells), K5b and batched K2/K3 (n=8) byte-equal "
              "to their plain versions")
        vmap_ms = time_ms(lambda: nmt.eds_nmt_roots(e8))
        vmap_gpu_ms = time_ms(lambda: nmt.eds_nmt_roots(e8), queued=True)
        vmap_plain_ms = time_ms(lambda: nmt.eds_nmt_roots_plain(e8), reps=1, warm=0)
        vmap_bound, vmap_by = bound(
            8 * (n2 * n2 * (512 + 90) + n2 * n2 * 90 + 2 * n2 * 90),
            8 * (n2 * n2 * compressions(542) + parents * compressions(181)) * SHA_OPS_PER_COMPRESSION,
            INT32_OPS_PER_S,
        )
        print(f"eds_nmt_roots, batch of 8 at k=128 (K2, then K3 for {n2.bit_length() - 1} levels in "
              f"one launch): {vmap_ms:.4f} ms as issued (GPU time {vmap_gpu_ms:.4f} ms), "
              f"plain {vmap_plain_ms:.3f} ms, bound {vmap_bound:.4f} ms ({vmap_by}), library none "
              f"| {smi}")
        results["eds_nmt_roots_batch_8"] = {"ms": vmap_ms, "gpu_ms": vmap_gpu_ms,
                                            "plain_ms": vmap_plain_ms, "bound_ms": vmap_bound,
                                            "bound_by": vmap_by}
        del bits, q0_bits, G, entry, eds_k, grid_k, levels_k, tree_k, lib_select, g_out
        del scratch, scratch_plain, scratch_gemm, scratch_gemm_plain, Dh, Xh, rec25, prov25, sq8, bits8, e8, D25, unknown_cells
        del tops, coeffs9, gemm_coeffs9, g_cols9, partials9, slabs9, outs9, bits9

    # K5's, K8b's and K9a's launches by C entry over the paths run in this
    # process (phases 3 to 4l): the chain's codec runs the Leopard kernels,
    # never the bit-GEMM
    entries_before = kernels.entry_launch_counts()

    def entries_since(before: dict) -> dict:
        now = kernels.entry_launch_counts()
        return {e: now.get(e, 0) - before.get(e, 0) for e in now}

    if "4" in selected:
        # --- 3. Go-pinned goldens through the port's entry points on the card ---
        check(dah.min_data_availability_header().hash == golden.MIN_DAH_HASH, "MIN_DAH_HASH")
        check(dah.new_data_availability_header(dah.extend_shares(golden.fixture_shares(4))).hash
              == golden.DAH_2X2_HASH, "DAH_2X2_HASH")
        eds128 = dah.extend_shares(golden.fixture_shares(128 * 128))
        check(eds128.tensor.is_cuda, "extend_shares left the card")
        check(dah.new_data_availability_header(eds128).hash == golden.DAH_128_HASH, "DAH_128_HASH")
        _, dah128 = dah.extend_and_header(golden.fixture_shares(128 * 128).reshape(128, 128, 512))
        check(dah128.hash == golden.DAH_128_HASH, "DAH_128_HASH via extend_and_header")
        print("goldens: MIN_DAH_HASH, DAH_2X2_HASH, DAH_128_HASH reproduced on the card")

        # --- 4. main path: extension -------------------------------------------
        def tx_stream(capacity_bytes: int):
            txs, total = [], 0
            while total < 1.25 * capacity_bytes:
                blobs = []
                for _ in range(int(rng.integers(1, 4))):
                    ns = Namespace.v0(b"\x01" + rng.bytes(9))
                    size = int(rng.integers(478, 256 * 1024 + 1))
                    blobs.append(Blob(ns, rng.bytes(size)))
                    total += size
                inner = rng.bytes(int(rng.integers(250, 401)))
                txs.append(BlobTx(inner, tuple(blobs)).marshal())
            return txs

        blocks = [DEFAULT_GOV_MAX_SQUARE_SIZE] * 4 + [128] * 4
        streams = [tx_stream(m * m * 478) for m in blocks]
        kernels.reset_launch_counts()
        ext_entries0 = kernels.entry_launch_counts()
        t_main = time.perf_counter()
        main_out = []
        for max_size, txs in zip(blocks, streams):
            sq_p, block_txs, _ = square_mod.build(txs, max_square_size=max_size)
            eds_p, dah_p = dah.extend_block(sq_p)
            sq_v, txs_v, _ = square_mod.construct(block_txs, max_square_size=max_size)
            eds_v, dah_v = dah.extend_block(sq_v)
            main_out.append((max_size, sq_p, block_txs, txs_v, eds_p, dah_p, dah_v))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t_main
        extend_launches = kernels.launch_counts()
        print(f"extension path: {len(blocks)} blocks (proposer + validator) in {main_s:.2f} s; "
              f"launches {extend_launches}")
        for name in EXTEND_KERNELS:
            check(extend_launches[name] > 0, f"kernel {name} was not launched on the extension path")
        check(extend_launches == block_launches(2 * len(blocks)),
              f"extension launches {extend_launches} != {block_launches(2 * len(blocks))}")
        ext_entries = {e: c for e, c in entries_since(ext_entries0).items() if c}
        check(ext_entries.get("ctt_rs_leopard_extend") == extend_launches["rs_extend"]
              and not any(ext_entries.get(e) for _, es, _ in BIT_GEMM_FORMS.values() for e in es),
              f"the extension path's K5 launches by C entry {ext_entries}: not all the FFT's")

        plain_out = []
        for max_size, sq_p, block_txs, txs_v, eds_p, dah_p, dah_v in main_out:
            kk = sq_p.size
            check(kk == max_size, f"square filled to {kk}, expected {max_size}")
            check(txs_v == block_txs, "validator block txs differ from the proposer's")
            check(dah_p.hash == dah_v.hash, "proposer and validator data roots differ")
            dah_p.validate_basic()
            shares = eds_p.shares
            check(shares.shape == (2 * kk, 2 * kk, 512), f"EDS shape {shares.shape}")
            check(np.array_equal(shares[:kk, :kk].reshape(kk * kk, 512), sq_p.to_array()),
                  "EDS Q0 is not the square")
            eds_plain, dah_plain = dah.extend_block(sq_p, device="cpu")
            check(dah_plain.hash == dah_p.hash, f"card and plain data roots differ at k={kk}")
            plain_out.append((eds_plain, dah_plain))
            print(f"block k={kk} txs={len(block_txs)} data_root={dah_p.hash.hex()} "
                  "proposer == validator == plain")
        results["data_roots"] = [o[5].hash.hex() for o in main_out]

        # median time of extend_and_header (upload, kernels, roots fetch), and
        # the same three phases timed apart with events between them
        medians, breakdown = {}, {}
        for max_size, sq_p, *_ in (main_out[0], main_out[-1]):
            arr = sq_p.to_array().reshape(max_size, max_size, 512)
            dah.extend_and_header(arr)
            runs, phases = [], []
            for _ in range(15):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                dah.extend_and_header(arr)
                ev[1].record()
                ev[1].synchronize()
                runs.append(ev[0].elapsed_time(ev[1]))
                ev[0].record()
                sq_dev = dah._square_tensor(arr, dev)
                ev[1].record()
                _, _, levels_dev, tree_dev = device_plane._extend_levels(sq_dev)
                ev[2].record()
                torch.cat([levels_dev[-1].reshape(-1), tree_dev[-1]]).cpu()
                ev[3].record()
                ev[3].synchronize()
                phases.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
            medians[max_size] = statistics.median(runs)
            breakdown[max_size] = dict(zip(
                ("upload_ms", "kernels_ms", "fetch_ms"),
                (statistics.median(p[i] for p in phases) for i in range(3)),
            ))
            print(f"extend_and_header k={max_size}: median {medians[max_size]:.3f} ms over "
                  f"{len(runs)} warm runs (CUDA events); phases "
                  + ", ".join(f"{n} {v:.3f}" for n, v in breakdown[max_size].items())
                  + f" | {smi}")
        results["extend_and_header_median_ms"] = medians
        results["extend_and_header_phases_ms"] = breakdown

        # --- 4b. main path: serving ---------------------------------------------
        def blob_ranges(sq_obj):
            """(namespace, start, end) of every blob's shares in a square
            (namespace padding shares start a sequence of length 0: skipped)."""
            out, i = [], 0
            while i < len(sq_obj.shares):
                sh = sq_obj.shares[i]
                if sh.namespace.is_reserved() or not sh.is_sequence_start or not sh.sequence_len():
                    i += 1
                    continue
                n = sparse_shares_needed(sh.sequence_len())
                out.append((sh.namespace.raw, i, i + n))
                i += n
            return out

        kernels.reset_launch_counts()
        t_serve = time.perf_counter()
        serve_ms, split_inputs = {}, []
        n_ns = n_share_proofs = 0
        for b, ((max_size, sq_p, *_), (eds_plain, dah_plain)) in enumerate(zip(main_out, plain_out)):
            kk = sq_p.size
            eds_g, dah_g = dah.extend_block(sq_p)
            check(dah_g.hash == dah_plain.hash, "plane data root differs from the plain path's")
            entry = eds_cache.get_device_entry(dah_g.hash, dev)
            check(entry is not None and entry.eds.is_cuda, "the block's plane entry is not on the card")
            seeds = [args.seed * 100_000 + b * 1000 + i for i in range(CLIENTS)]
            coords = [c for sd in seeds
                      for c in das.LightClient(dah_g.hash, kk, seed=sd).pick_coordinates(SAMPLES)]
            das.reset_host_prover_calls()
            dah.reset_full_eds_fetches()
            t0 = time.perf_counter()
            warm = das.sample_proofs_batch(eds_g, dah_g, coords)
            warm_s = time.perf_counter() - t0
            for i, sd in enumerate(seeds):
                mine = warm[i * SAMPLES : (i + 1) * SAMPLES]
                res = das.LightClient(dah_g.hash, kk, seed=sd).sample(
                    fetch_batch=lambda cs, mine=mine: mine, n_samples=SAMPLES)
                check(res.available and res.verified == SAMPLES,
                      f"light client {sd}: {res.verified}/{SAMPLES} verified, {res.failed[:2]}")
            ranges = blob_ranges(sq_p)
            plain_stacks = PlainRowStacks(eds_plain)
            for ns in sorted({r[0] for r in ranges}):
                got = namespace_data.get_shares_by_namespace(eds_g, dah_g, ns)
                check(got.verify(dah_g), "namespace data does not verify")
                with plain_stacks:
                    want = namespace_data.get_shares_by_namespace(eds_plain, dah_plain, ns)
                check(got.to_dict() == want.to_dict(), "namespace data differs from the plain path")
                n_ns += 1
            for _, start, end in ranges:
                got = proof.new_share_inclusion_proof(eds_g, dah_g, start, end)
                check(got.verify(dah_g.hash), "share proof does not verify")
                with plain_stacks:
                    want = proof.new_share_inclusion_proof(eds_plain, dah_plain, start, end)
                check(got.to_dict() == want.to_dict(), "share proof differs from the plain path")
                n_share_proofs += 1
            check(das.host_prover_calls() == 0, "the host prover served a warm block")
            check(dah.full_eds_fetches() == 0, "serving a warm block fetched the whole EDS")
            # the same cells once the card's entry is gone: served from the EDS
            # on the card, same bytes
            check(eds_cache.drop_device_entry(dah_g.hash, dev), "the plane entry was not cached")
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            cold = das.sample_proofs_batch(eds_g, dah_g, coords)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            after = kernels.launch_counts()
            for name in MISS_KERNELS:
                check(after[name] > before[name], f"kernel {name} was not launched on a miss on the card")
            for name in OFF_PATH_KERNELS:
                check(after[name] == before[name], f"kernel {name} was launched on a miss on the card")
            check(das.host_prover_calls() == 0, "the host prover served a block on the card")
            check([p.to_dict() for p in cold] == [p.to_dict() for p in warm],
                  "proofs of a miss on the card differ from the gather's")
            check(dah.full_eds_fetches() == 0, "a miss on the card fetched the whole EDS")
            # and by the host prover, from the plain path's EDS with no entry
            eds_cache.drop_device_entry(dah_plain.hash, "cpu")
            t0 = time.perf_counter()
            host = das.sample_proofs_batch(eds_plain, dah_plain, coords)
            host_s = time.perf_counter() - t0
            check(das.host_prover_calls() == 1, "the host prover did not serve the plain path's EDS")
            check([p.to_dict() for p in host] == [p.to_dict() for p in warm],
                  "host prover and gather proofs differ")
            serve_ms.setdefault(kk, []).append((warm_s * 1e3, cold_s * 1e3, host_s * 1e3))
            if kk == 128:
                split_inputs.append((entry, dah_g, coords, warm))
            print(f"serve block k={kk}: {len(coords)} cells from the gather in {warm_s * 1e3:.2f} ms, "
                  f"from the EDS on the card (no entry) {cold_s * 1e3:.2f} ms, host prover "
                  f"{host_s * 1e3:.2f} ms; {len(ranges)} blobs in "
                  f"{len({r[0] for r in ranges})} namespaces proven, each equal to the plain "
                  "path's")
        torch.cuda.synchronize()
        serve_launches = kernels.launch_counts()
        print(f"serving path: {len(main_out)} blocks in {time.perf_counter() - t_serve:.2f} s; "
              f"{n_ns} namespaces, {n_share_proofs} share proofs; launches {serve_launches}")
        for name in SERVE_KERNELS:
            check(serve_launches[name] > 0, f"kernel {name} was not launched on the serving path")
        for name in OFF_PATH_KERNELS:
            check(serve_launches[name] == 0, f"kernel {name} was launched on the serving path")
        # the warm k = 128 calls again, phase by phase (outside the counted run)
        # the warm k = 128 calls again, phase by phase (outside the counted run):
        # the cell mode as the path runs it, then the table mode over the same
        # cells (the host-built item table of PR 2-7's path) beside it
        split_ms = {"cell": [], "table": []}
        for entry, dah_g, coords, warm in split_inputs:
            lay = device_plane._cell_layout(entry.k)
            nbytes = len(coords) * lay.cell_bytes
            for mode in ("cell", "table"):
                ph = [time.perf_counter()]
                sources = entry.gather_sources()
                if mode == "cell":
                    index = device_plane.cell_table(coords)
                    gather.check_cells(sources, lay, index)
                else:
                    index = device_plane.proof_items(entry.k, coords)
                    gather.check_items(sources, index, nbytes)
                ph.append(time.perf_counter())
                index_dev = torch.from_numpy(index).to(dev)
                out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
                torch.cuda.synchronize()
                ph.append(time.perf_counter())
                if mode == "cell":
                    gather.launch_cells(sources, lay, index_dev, out)
                else:
                    gather.launch_gather(sources, index_dev, out)
                torch.cuda.synchronize()
                ph.append(time.perf_counter())
                host = out.cpu().numpy()
                ph.append(time.perf_counter())
                again = device_plane.assemble_proofs(entry.k, dah_g, coords, host)
                ph.append(time.perf_counter())
                check(again == warm, f"phase-by-phase gather ({mode} mode) differs")
                split_ms[mode].append([(ph[i + 1] - ph[i]) * 1e3 for i in range(5)])
        del split_inputs
        serve_medians = {
            kk: {"gather_ms": statistics.median(w for w, _, _ in v),
                 "card_miss_ms": statistics.median(c for _, c, _ in v),
                 "host_prover_ms": statistics.median(h for _, _, h in v)}
            for kk, v in serve_ms.items()
        }
        split = {mode: dict(zip(("index_build_ms", "upload_ms", "gather_ms", "fetch_ms",
                                 "assembly_ms"),
                                (statistics.median(s[i] for s in runs) for i in range(5))))
                 for mode, runs in split_ms.items()}
        for kk, m in serve_medians.items():
            print(f"sample_proofs_batch k={kk}, {CLIENTS * SAMPLES} cells: median "
                  f"{m['gather_ms']:.3f} ms warm (gather), {m['card_miss_ms']:.3f} ms from the EDS on "
                  f"the card (no entry), {m['host_prover_ms']:.3f} ms host prover "
                  f"| {smi}")
        for mode, ph in split.items():
            print(f"sample_proofs_batch k=128 phases, {mode} mode (median of {len(split_ms[mode])}): "
                  + ", ".join(f"{n} {v:.3f}" for n, v in ph.items()) + f" | {smi}")
        results["sample_proofs_batch_ms"] = serve_medians
        results["sample_proofs_batch_phases_ms"] = split

        # --- 4c. repair (BASELINE config 4) ---------------------------------------
        def roots_np(hdr):
            return [np.frombuffer(b"".join(r), dtype=np.uint8).reshape(-1, 90)
                    for r in (hdr.row_roots, hdr.col_roots)]

        def masks(kk: int):
            """(name, availability) of the three masks at square size kk."""
            nn = 2 * kk
            rows_cols = np.ones((nn, nn), dtype=bool)
            rows_cols[rng.choice(nn, kk, replace=False), :] = False
            rows_cols[:, rng.choice(nn, kk, replace=False)] = False
            return [("25% cells", rng.random((nn, nn)) >= 0.25),
                    ("k rows + k cols", rows_cols),
                    ("deep peel", deep_peel_mask(kk))]

        def damaged(full: torch.Tensor, avail: np.ndarray) -> torch.Tensor:
            out = full.clone()
            out[upload(~avail)] = 0x55
            return out

        plain_before = rs.plain_repairs()
        kernels.reset_launch_counts()
        t_repair = time.perf_counter()
        repair_inputs = []
        for _, sq_p, *_ in main_out:
            eds_g, dah_g = dah.extend_block(sq_p)
            repair_inputs.append((eds_g.tensor, dah_g))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()  # the re-extensions above are the extension path's
        repair_stats = {}
        for full, hdr in repair_inputs:
            kk = full.shape[0] // 2
            rr, cr = roots_np(hdr)
            for name, avail in masks(kk):
                phases = rs._simulate_schedule(avail, kk)[0].shape[0]
                bad = damaged(full, avail)
                out = rs.repair_square_device(bad, avail, rr, cr, return_device=True)
                check(out.is_cuda and torch.equal(out, full),
                      f"repair at k={kk} ({name}, P={phases}) did not give the plane's EDS")
                repair_stats.setdefault((kk, name), phases)
        torch.cuda.synchronize()
        repair_launches = kernels.launch_counts()
        check(rs.plain_repairs() == plain_before, "a repair on the card ran on the host")
        print(f"repair path: {len(repair_inputs)} blocks x 3 masks in "
              f"{time.perf_counter() - t_repair:.2f} s, every EDS restored on the card, no host "
              f"repair; phases {sorted(set(repair_stats.items()))}; launches {repair_launches}")
        for name in REPAIR_KERNELS:
            check(repair_launches[name] > 0, f"kernel {name} was not launched on the repair path")
        for name in LAGRANGE_ONLY_KERNELS:
            check(repair_launches[name] == 0, f"kernel {name} was launched on the repair path")
        check(repair_stats[(128, "deep peel")] > 4 and repair_stats[(128, "25% cells")] == 1,
              f"unexpected phase counts {repair_stats}")
        # medians of warm calls per mask at k = 128 (outside the counted run)
        full, hdr = next((f, h) for f, h in repair_inputs if f.shape[0] == 256)
        rr, cr = roots_np(hdr)
        repair_medians = {}
        for name, avail in masks(128):
            bad = damaged(full, avail)
            rs.repair_square_device(bad, avail, rr, cr, return_device=True)
            walls, bds = [], []
            for _ in range(REPAIR_RUNS):
                bd = {}
                t0 = time.perf_counter()
                out = rs.repair_square_device(bad, avail, rr, cr, breakdown=bd, return_device=True)
                walls.append((time.perf_counter() - t0) * 1e3)
                bds.append(bd)
                check(torch.equal(out, full), f"warm repair ({name}) differs")
            med = {"wall_ms": statistics.median(walls), "phases": repair_stats[(128, name)]}
            for key in ("schedule_ms", "upload_compute_ms", "verdict_fetch_ms", "kernels_ms"):
                med[key] = statistics.median(b[key] for b in bds)
            repair_medians[name] = med
            print(f"repair_square_device k=128, {name} (P={med['phases']}): median wall "
                  f"{med['wall_ms']:.3f} ms over {REPAIR_RUNS} warm calls; schedule "
                  f"{med['schedule_ms']:.3f}, upload+compute {med['upload_compute_ms']:.3f}, verdict "
                  f"fetch {med['verdict_fetch_ms']:.3f}, kernels (CUDA events) "
                  f"{med['kernels_ms']:.3f} | {smi}")
        results["repair_k128_medians"] = repair_medians

        # byzantine and insufficient cases: the card against the plain path at k = 32
        sq32 = rng.integers(0, 256, (32, 32, 512), dtype=np.uint8)
        sq32[..., :29] = 0
        eds32, dah32 = dah.extend_and_header(sq32)
        host32 = eds32.tensor.cpu()
        r32, c32 = roots_np(dah32)
        n32 = 64
        cases = []
        avail = np.ones((n32, n32), dtype=bool)
        avail[0, :31] = False  # row 0 keeps k + 1 cells: its last one is decoded over
        cases.append(("provided shares", avail, (0, n32 - 1), {}))
        avail = np.ones((n32, n32), dtype=bool)
        avail[0, :32] = False
        cases.append(("inconsistent erasure coding", avail, (0, 32), {}))
        avail = np.ones((n32, n32), dtype=bool)
        avail[1, 0] = False
        cases.append(("committed NMT roots", avail, None, {"row_roots": np.zeros((n32, 90), np.uint8)}))
        avail = np.zeros((n32, n32), dtype=bool)
        avail[0, 0] = True
        cases.append(("stalled", avail, None, {}))
        for want, avail, flip, kw in cases:
            raised = []
            for tensor in (eds32.tensor, host32):
                bad = tensor.clone()
                if flip is not None:
                    bad[flip[0], flip[1], 7] ^= 0x04
                try:
                    rs.repair_square_device(bad, avail, return_device=True, **kw)
                except ValueError as e:
                    raised.append((type(e).__name__, str(e)))
                else:
                    raised.append(None)
            check(raised[0] is not None and want in raised[0][1],
                  f"the card did not raise '{want}': {raised[0]}")
            check(raised[0] == raised[1], f"card and plain path raise differently: {raised}")
        # a k = 32 repair on the card equals the plain path's
        for name, avail in masks(32):
            bad = damaged(eds32.tensor, avail)
            card = rs.repair_square_device(bad, avail, r32, c32, return_device=True)
            plain = rs.repair_square_device(bad.cpu(), avail, r32, c32, return_device=True)
            check(torch.equal(card.cpu(), plain) and torch.equal(card, eds32.tensor),
                  f"k=32 repair ({name}): card and plain path differ")
        print("repair byzantine cases raise on the card as on the plain path (provided shares, "
              "inconsistent erasure coding, committed NMT roots, stalled); k=32 repairs equal")

        # --- 4d. fraud -------------------------------------------------------------
        full, hdr = repair_inputs[-1]
        check(full.shape[0] == 256, "the last block is not k = 128")
        bad = full.clone()
        bad[2, 128 + 2, 100] ^= 0x5A  # a Q1 cell (tests/test_fraud.py:31-38)
        bad_hdr = dah.new_data_availability_header(dah.ExtendedDataSquare(bad))
        kernels.reset_launch_counts()
        found = fraud.detect_bad_encoding(bad)
        befp = fraud.build_befp(bad, *found)
        torch.cuda.synchronize()
        fraud_launches = kernels.launch_counts()
        check(found == (fraud.AXIS_ROW, 2), f"detect_bad_encoding found {found}, not row 2")
        check(befp.verify(bad_hdr), "the BEFP built on the card does not verify against the bad DAH")
        check(not befp.verify(hdr), "the BEFP verifies against the honest DAH")
        check(fraud.detect_bad_encoding(full) is None, "fraud detected in an honest block")
        for name in FRAUD_KERNELS:
            check(fraud_launches[name] > 0, f"kernel {name} was not launched on the fraud path")
        for name in (*OFF_PATH_KERNELS, *LAGRANGE_ONLY_KERNELS):
            check(fraud_launches[name] == 0, f"kernel {name} was launched on the fraud path")
        detect_ms, build_ms = [], []
        for _ in range(REPAIR_RUNS):
            t0 = time.perf_counter()
            fraud.detect_bad_encoding(bad)
            t1 = time.perf_counter()
            fraud.build_befp(bad, *found)
            t2 = time.perf_counter()
            detect_ms.append((t1 - t0) * 1e3)
            build_ms.append((t2 - t1) * 1e3)
        # at k = 32 the card's BEFP equals the plain path's
        bad32 = eds32.tensor.clone()
        bad32[1, 32 + 3, 100] ^= 0x5A
        found32 = fraud.detect_bad_encoding(bad32)
        check(found32 == fraud.detect_bad_encoding(bad32.cpu()) == (fraud.AXIS_ROW, 1),
              f"k=32 detection: card {found32}")
        check(fraud.build_befp(bad32, *found32).to_dict()
              == fraud.build_befp(bad32.cpu(), *found32).to_dict(),
              "k=32 BEFP: card and plain path differ")
        fraud_medians = {"detect_ms": statistics.median(detect_ms),
                         "build_befp_ms": statistics.median(build_ms)}
        results["fraud_k128_medians"] = fraud_medians
        print(f"fraud path: corrupted k=128 block detected at {found}, BEFP built on the card "
              f"verifies against the bad DAH and not the honest one (k=32: equal to the plain "
              f"path's); median detect {fraud_medians['detect_ms']:.3f} ms, build_befp "
              f"{fraud_medians['build_befp_ms']:.3f} ms over {REPAIR_RUNS} calls; launches "
              f"{fraud_launches} | {smi}")

        # --- 4e. catch-up (BASELINE config 5) ---------------------------------------
        by_size = {}
        for _, sq_p, _, _, _, dah_p, _ in main_out:
            by_size.setdefault(sq_p.size, []).append((sq_p, dah_p))
        kernels.reset_launch_counts()
        for size, items in by_size.items():
            stacked = np.stack([sq_p.to_array().reshape(size, size, 512) for sq_p, _ in items])
            _, data_roots = dah.data_roots_batched(stacked)
            for (sq_p, hdr), got in zip(items, data_roots):
                check(got == hdr.hash, f"catch-up data root differs from the DAH at k={size}")
        torch.cuda.synchronize()
        catchup_launches = kernels.launch_counts()
        for name in CATCHUP_KERNELS:
            check(catchup_launches[name] > 0, f"kernel {name} was not launched on the catch-up path")
        check(catchup_launches == block_launches(len(by_size), batched=True),
              f"catch-up launches {catchup_launches} != {block_launches(len(by_size), batched=True)}")
        more = [square_mod.build(tx_stream(128 * 128 * 478), max_square_size=128)[0] for _ in range(4)]
        batch8 = np.stack([sq_p.to_array().reshape(128, 128, 512)
                           for sq_p in [it[0] for it in by_size[128]] + more])
        _, roots8 = dah.data_roots_batched(batch8)
        for sq_p, got in zip(more, roots8[4:]):
            check(got == dah.extend_block(sq_p)[1].hash, "catch-up data root of a new block differs")
        batch8_dev = upload(batch8)
        walls, kms = [], []
        for _ in range(REPAIR_RUNS + 1):
            t0 = time.perf_counter()
            dah.data_roots_batched(batch8)
            walls.append((time.perf_counter() - t0) * 1e3)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            e = rs.extend_squares_batched(batch8_dev)
            r = nmt.eds_nmt_roots(e)
            nmt.rfc6962_root_pow2(r.reshape(8, 512, 90))
            ev[1].record()
            ev[1].synchronize()
            kms.append(ev[0].elapsed_time(ev[1]))
        catchup = {"wall_ms": statistics.median(walls[1:]), "kernels_ms": statistics.median(kms[1:])}
        results["catch_up_8_blocks_k128"] = catchup
        print(f"catch-up path: {len(main_out)} blocks in {len(by_size)} batches, every data root equal "
              f"to its DAH; launches {catchup_launches}")
        print(f"data_roots_batched, 8 blocks at k=128: median wall {catchup['wall_ms']:.3f} ms "
              f"(upload, kernels, one fetch), kernels {catchup['kernels_ms']:.3f} ms (CUDA events) over "
              f"{REPAIR_RUNS} warm calls | {smi}")
        del repair_inputs, batch8_dev, e, r

        # --- 4f. the sharded extension (K9) ------------------------------------------
        # R shards on one card: a mesh that repeats the card, every kernel and
        # every collective of the R-shard program on it
        from celestia_tpu_torch.parallel import collectives, sharded
        from celestia_tpu_torch.parallel import mesh as provider

        def provided_mesh(spec: str, n: int, kk: int, batch: int = 0):
            """The mesh provider's mesh for a k-square (or a batch of them) under
            ``spec`` over n repeats of the card, as the block lifecycle asks."""
            provider.configure(spec, devices=[dev] * n)
            got = provider.mesh_for_batch(kk, batch) if batch else provider.mesh_for_square(kk)
            data, row = provider.parse_spec(spec)
            check(got is not None and got.shape == {"data": data, "row": row}
                  and all(d == dev for group in got.devices for d in group),
                  f"the provider gave no {spec} mesh for k={kk}")
            return got

        gold128 = golden.fixture_shares(128 * 128).reshape(128, 128, 512)
        cases4f = [(64, main_out[0][1].to_array().reshape(64, 64, 512), main_out[0][5].hash),
                   (128, gold128, golden.DAH_128_HASH)]
        extends0 = provider.stats()["sharded_extends"]
        meshes = {R: provided_mesh(f"1x{R}", R, 64) for R in (1, 2, 4, 8)}
        fallbacks0 = provider.stats()["fallback_squares"]
        check(provider.mesh_for_square(4) is None  # k < R: the single-device path
              and provider.stats()["fallback_squares"] == fallbacks0 + 1,
              "the provider's 1x8 mesh did not route a k=4 square to the single-device path")
        # the single-device references, before and outside the counted calls
        single4f = {kk: dah.extend_and_header(arr) for kk, arr, _ in cases4f}
        single8 = [dah.extend_and_header(batch8[i]) for i in range(8)]
        sharded_launches = {name: 0 for name in kernels.KERNELS}

        def counted(fn, arr, mesh_, kk):
            """One sharded call with the counts set to 0 just before it and read
            just after: exactly the launches of sharded_launches_per_call, and
            no byte staged between shards (one card: every slab read in place)."""
            kernels.reset_launch_counts()
            collectives.reset_staged_bytes()
            out = fn(arr, mesh_)
            got = kernels.launch_counts()
            staged = collectives.staged_bytes()
            want = sharded_launches_per_call(kk, mesh_.shape["row"], mesh_.shape["data"])
            check(got == want, f"sharded launches at k={kk}, mesh {mesh_.shape}: {got} != {want}")
            check(staged == 0, f"the reduce-scatter staged {staged} bytes on one card")
            for name, n in got.items():
                sharded_launches[name] += n
            return out

        t_sh = time.perf_counter()
        for R, mesh_R in meshes.items():
            for kk, arr, want in cases4f:
                eds_s, hdr_s = counted(sharded.extend_and_header_sharded, arr, mesh_R, kk)
                eds_1, hdr_1 = single4f[kk]
                check(hdr_s.hash == want, f"sharded data root at k={kk}, R={R} != the golden hash")
                check(hdr_s == hdr_1, f"sharded DAH at k={kk}, R={R} differs from extend_and_header")
                check(eds_s.tensor.device == dev and torch.equal(eds_s.tensor, eds_1.tensor),
                      f"sharded EDS at k={kk}, R={R} differs from extend_and_header's")
        for _, sq_p, _, _, eds_p, dah_p, _ in main_out:
            eds_s, hdr_s = counted(sharded.extend_block_sharded, sq_p, meshes[4], sq_p.size)
            check(hdr_s == dah_p, f"sharded DAH of a seeded block (k={sq_p.size}, R=4) differs")
            check(torch.equal(eds_s.tensor, eds_p.tensor), "sharded EDS of a seeded block differs")
        mesh_2x4 = provided_mesh("2x4", 8, batch8.shape[1], batch=8)
        batched = counted(sharded.extend_and_headers_sharded_batch, batch8, mesh_2x4,
                          batch8.shape[1])
        check(len(batched) == 8, "the batched sharded leg returned another count")
        for i, (eds_s, hdr_s) in enumerate(batched):
            eds_1, hdr_1 = single8[i]
            check(hdr_s == hdr_1 and hdr_s.hash == roots8[i],
                  f"batched sharded DAH of square {i} differs (data=2, row=4)")
            check(torch.equal(eds_s.tensor, eds_1.tensor), f"batched sharded EDS of square {i} differs")
        torch.cuda.synchronize()
        print(f"sharded path: R=1,2,4,8 at k=64 and 128 (golden DAH_128_HASH), the 8 seeded blocks "
              f"at R=4, 8 squares on a 2x4 mesh: every EDS and DAH equal to extend_and_header's, in "
              f"{time.perf_counter() - t_sh:.2f} s; launches of every call exactly as counted (K9b "
              f"once a group), 0 bytes staged by the reduce-scatter, in all {sharded_launches}")
        for name in SHARDED_KERNELS:
            check(sharded_launches[name] > 0, f"kernel {name} was not launched on the sharded path")
        check(provider.stats()["sharded_extends"] - extends0 == 2 * len(meshes) + len(main_out) + 8,
              f"the provider counted {provider.stats()['sharded_extends'] - extends0} sharded squares")
        provider.configure(None)
        del single4f, single8
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            R = 1 << (n_cards.bit_length() - 1)
            cards = sharded.make_mesh([torch.device("cuda", i) for i in range(R)])
            eds_s, hdr_s = sharded.extend_and_header_sharded(gold128, cards)
            check(hdr_s.hash == golden.DAH_128_HASH, f"sharded DAH over {R} cards differs")
            check(torch.equal(eds_s.tensor, eds128.tensor.to(eds_s.tensor.device)),
                  f"sharded EDS over {R} cards differs")
            print(f"sharded path over {R} distinct cards: golden DAH_128_HASH reproduced")
        else:
            print(f"sharded path over distinct cards: not run, {n_cards} card visible "
                  "(a mesh over distinct cards needs two)")
        # medians of warm calls per (k, R): wall (host clock) and span (CUDA
        # events) of extend_and_header_sharded, then its phases (events between
        # them) in separate calls; the single-device call beside them
        sharded_ms = {}
        for kk, arr, _ in cases4f:
            single = []
            for _ in range(SHARDED_RUNS + 1):
                t0 = time.perf_counter()
                dah.extend_and_header(arr)
                single.append((time.perf_counter() - t0) * 1e3)
            for R, mesh_R in meshes.items():
                sharded.extend_and_header_sharded(arr, mesh_R)
                walls, spans, bds = [], [], []
                for _ in range(SHARDED_RUNS):
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    t0 = time.perf_counter()
                    ev[0].record()
                    sharded.extend_and_header_sharded(arr, mesh_R)
                    ev[1].record()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    ev[1].synchronize()
                    spans.append(ev[0].elapsed_time(ev[1]))
                    bd = {}
                    sharded._extend_and_roots_sharded_device(arr, mesh_R, record_stats=False,
                                                             breakdown=bd)
                    bds.append(bd)
                med = {"wall_ms": statistics.median(walls), "events_ms": statistics.median(spans),
                       "single_device_wall_ms": statistics.median(single[1:])}
                for key in bds[0]:
                    med[key] = statistics.median(b[key] for b in bds)
                sharded_ms[f"k={kk},R={R}"] = med
                print(f"extend_and_header_sharded k={kk} R={R} (one card): median wall "
                      f"{med['wall_ms']:.3f} ms, events {med['events_ms']:.3f} ms over {SHARDED_RUNS} "
                      f"warm calls (extend_and_header {med['single_device_wall_ms']:.3f} ms); phases "
                      + ", ".join(f"{n[:-3]} {v:.3f}" for n, v in med.items() if n not in (
                          "wall_ms", "events_ms", "single_device_wall_ms"))
                      + f" | {smi}")
        results["extend_and_header_sharded_ms"] = sharded_ms
        del meshes, batched, eds_s, eds_1

    if "4g" in selected:
        # --- 4g. the App on the card ---------------------------------------------
        t_app = time.perf_counter()
        app_sizes = [DEFAULT_GOV_MAX_SQUARE_SIZE] * 2 + [128] * 2
        app_out = app_phase(dev, app_sizes, args.seed + 7, counted=True)
        app_launches, app_mesh_launches = app_out["launches"], app_out["mesh_launches"]
        for name in EXTEND_KERNELS:
            check(app_launches[name] > 0, f"kernel {name} was not launched on the App path")
        for name in SHARDED_KERNELS:
            check(app_mesh_launches[name] > 0, f"kernel {name} was not launched on the App's mesh leg")
        print(f"App path: {len(app_sizes)} heights (k={app_sizes}), proposer and validator on the "
              f"card, every honest block accepted, app hashes equal, data roots equal to the plain "
              f"path's, 0 panic rejects, proposer process = EDS-cache hit each height; launches "
              f"{app_launches} (5 a cold extension); the 1x4 mesh replay: process_proposal sharded and "
              f"validate_blocks_batched batched, every verdict accept, launches {app_mesh_launches}; "
              f"in {time.perf_counter() - t_app:.2f} s")
        app_ms = {}
        for kk in sorted(set(app_sizes)):
            bds = app_out["prepare"][kk]
            med = {name: statistics.median(b[name] for b in bds) for name in bds[0]}
            for name in ("prepare_wall_ms", "process_hit_ms", "process_cold_ms", "key_ms"):
                med[name] = statistics.median(app_out[name][kk])
            app_ms[kk] = med
            print(f"App k={kk} (median of {len(bds)} heights): prepare wall "
                  f"{med['prepare_wall_ms']:.3f} ms = filter {med['filter_ms']:.3f}, build "
                  f"{med['build_ms']:.3f}, extend {med['extend_ms']:.3f} (its EDS-cache key "
                  f"{med['key_ms']:.3f}); process_proposal wall "
                  f"{med['process_cold_ms']:.3f} ms cold (validator), {med['process_hit_ms']:.3f} ms "
                  f"EDS-cache hit (proposer) | {smi}")
        results["app_ms"] = app_ms
        results["app_hashes"] = app_out["app_hashes"]
        results["app_data_roots"] = app_out["data_roots"]

    # --- 4h. the devnet on the card -------------------------------------------
    if "4h" in selected:
        t_dev = time.perf_counter()
        devnet_sizes = [DEFAULT_GOV_MAX_SQUARE_SIZE] * 3 + [128]
        dn = devnet_phase(dev, devnet_sizes, DEVNET_NET_HEIGHTS, args.seed + 11, counted=True)
        dl = dn["launches"]
        for leg, names in (("produce", EXTEND_KERNELS), ("serve", DEVNET_SERVE_KERNELS),
                           ("rebuild", EXTEND_KERNELS + SERVE_KERNELS),
                           ("network", EXTEND_KERNELS), ("join", CATCHUP_KERNELS)):
            for name in names:
                check(dl[leg][name] > 0, f"kernel {name} was not launched on the devnet's "
                      f"{leg} leg")
        for name in OFF_PATH_KERNELS:
            check(dl["serve"][name] == 0, f"kernel {name} was launched on the devnet's queries")
        devnet_launches = sum_counts(dl.values())
        med = {k: statistics.median(v) for k, v in dn["produce_ms"].items()}
        prep = {k: {name: statistics.median(b[name] for b in bds) for name in bds[0]}
                for k, bds in dn["prepare"].items()}
        qmed = {q: statistics.median(v) for q, v in dn["query_ms"].items()}
        print(f"devnet: TestNode on the card, {len(devnet_sizes)} heights (k={devnet_sizes}) "
              f"through the Signer and produce_block, process an EDS-cache hit, data roots equal "
              f"to the plain path's, every served proof verified, answers equal to the plain "
              f"functions' at one height a k; ValidatorNetwork of 4 on the card, "
              f"{DEVNET_NET_HEIGHTS} heights, validator 1's out-of-order block rejected 3 to 1 at "
              f"height {dn['network']['byzantine_height']} and the next proposer's committed, "
              f"app hashes equal; join_validator on the network's app hash; in "
              f"{time.perf_counter() - t_dev:.2f} s")
        print("devnet walls (ms, medians): produce_block "
              + ", ".join(f"k={k} {v:.3f} (its prepare's filter {prep[k]['filter_ms']:.3f}, "
                          f"build {prep[k]['build_ms']:.3f}, extend {prep[k]['extend_ms']:.3f})"
                          for k, v in sorted(med.items()))
              + "; queries " + ", ".join(f"{q} {v:.3f}" for q, v in qmed.items())
              + f"; rebuild + sample_batch {dn['rebuild_ms']:.3f}; network heights "
              + ", ".join(f"{v:.3f}" for v in dn["net_height_ms"])
              + f"; join_validator {dn['join_ms']:.3f} | {smi}")
        print(f"devnet launches: {json.dumps(dl)}")
        results["devnet"] = {"produce_ms": med, "prepare_ms": prep, "query_ms": qmed,
                             "rebuild_ms": dn["rebuild_ms"],
                             "net_height_ms": dn["net_height_ms"], "join_ms": dn["join_ms"],
                             "launches": dl, "node": dn["node"], "network": dn["network"]}

    if "4i" in selected:
        t_svc = time.perf_counter()
        kernels.reset_launch_counts()
        sv = service_phase(dev, args.seed + 12)
        service_launches = kernels.launch_counts()
        for name in EXTEND_KERNELS + SERVE_KERNELS:
            check(service_launches[name] > 0, f"kernel {name} was not launched by the node service")
        med = {k: statistics.median(v) for k, v in sv["produce_ms"].items()}
        qmed = {q: statistics.median(v) for q, v in sv["query_ms"].items()}
        busy = [b for b in sv["busy_pct"] if b is not None]
        print(f"node service: NodeService(TestNode) on the card, {len(SERVICE_PLAN)} heights "
              f"({', '.join(f'k={k} {m}' for k, m in SERVICE_PLAN)}) signed by the Signer over "
              "the service's handlers, data roots equal to the plain path's, every served DAS, "
              "share and tx proof verified; /healthz ok and /metrics over 127.0.0.1 with the "
              "predicted dispatch counts (extend_levels = the traced heights' cold extensions, "
              "das_proof_gather = K7b's launches), busy ms, memory gauges and a cost-table row a "
              f"dispatch; TraceDump valid with {sv['trace']['device_spans']} device.extend_levels "
              f"spans under extend.device_plane; CLI keys add, init, validate-genesis, then "
              f"start on the card serving gRPC, tx pay-for-blob, query block, share-proof and "
              f"das-sample (verified), SIGTERM and exit 0 ({sv['cli_s']:.1f} s; boot, tx, queries "
              f"{', '.join(f'{v:.2f}' for v in sv['cli'].values())} s); in "
              f"{time.perf_counter() - t_svc:.2f} s")
        print("node service walls (ms, medians): produce_block "
              + ", ".join(f"k={k} {v:.3f}" for k, v in med.items())
              + "; queries " + ", ".join(f"{q} {v:.3f}" for q, v in qmed.items())
              + f" | {smi}")
        traced_ms, untraced_ms = sv["produce_ms"]["128 traced"], sv["produce_ms"]["128 untraced"]
        print(f"node service tracing's cost at k=128: produce_block traced {traced_ms}, untraced "
              f"{untraced_ms} ms (in plan order, alternating); median traced - median untraced "
              f"{med['128 traced'] - med['128 untraced']:.3f} ms; each untraced height against "
              f"the mean of its traced neighbours (a drift linear in the height cancels) "
              f"{[round(v, 3) for v in sv['tracing_cost_ms']]} ms | {smi}")
        print("node service device busy share of each traced produce_block (%, occupancy "
              f"probe): {busy}; idle {[round(100.0 - b, 2) for b in busy]} | {smi}")
        print(f"node service launches: {json.dumps(service_launches)}")
        print(f"node service dispatches: {json.dumps(sv['dispatches'])}; transfers: "
              f"{json.dumps(sv['transfers'])}")
        print(f"node service cost table: {json.dumps(sv['cost_table'])}")
        print("torch.profiler over one height, kernels' device ms: "
              + (json.dumps(sv["profiler_kernels_ms"]) if sv["profiler_kernels_ms"]
                 else "not measured (the capture held no CUDA kernel events)"))
        results["service"] = {key: sv[key] for key in (
            "query_ms", "busy_pct", "trace", "cost_table", "transfers", "dispatches", "mem",
            "profiler_kernels_ms", "cli", "cli_s", "tracing_cost_ms")}
        results["service"]["produce_ms"] = med

    if "4j" in selected:
        t_net = time.perf_counter()
        net = network_phase(dev, DEFAULT_GOV_MAX_SQUARE_SIZE, args.seed + 13)
        windows = net["windows"]
        relay = net["relay"]
        coord_launches = net["coord_launches"]
        network_launches = sum_counts([w["launches"] for w in windows.values()]
                                      + [relay["launches"], coord_launches])
        sw = net["swarm"]
        print(f"network stack: gossip mesh of {NET_VALIDATORS} cli start processes on the card, "
              f"{len(net['filled'])} heights filled to k={DEFAULT_GOV_MAX_SQUARE_SIZE} "
              f"({net['filled']}) among {net['heights']} heights, one data root and app hash "
              f"on every process, each the plain path's; validator 3 stopped at "
              f"{net['stopped_at']}, restarted and caught up {net['caught_up_heights']} heights "
              f"on the mesh's app hash; cluster-health {net['health']}; cluster-trace "
              f"{net['trace']}; txsim {net['txsim']['succeeded']}/{net['txsim']['submitted']}; "
              f"swarm rounds {sw['rounds_run']}, {sw['verified']} served cells verified; "
              f"cli bft-relay drove heights {relay['driven']} of an in-process mesh on the card "
              f"and was killed, the mesh went on to {relay['mesh_to']} (filled at "
              f"{relay['filled']}); coordinator {COORD_HEIGHTS} heights at "
              f"k={DEFAULT_GOV_MAX_SQUARE_SIZE} on the plain path's roots; in "
              f"{time.perf_counter() - t_net:.2f} s")
        print(f"network walls: boot per process (s) "
              f"{[round(v, 2) for v in net['boot_s'].values()]}, restart boot "
              f"{net['restart_boot_s']:.2f} s, catch-up {net['catchup_s']:.3f} s for "
              f"{net['caught_up_heights']} heights; filled heights' submit-to-commit (ms) "
              f"{[round(v, 1) for v in net['commit_ms']]}; mesh to the catch-up in "
              f"{net['mesh_s']:.2f} s, {net['idle_ms_per_height']:.1f} ms a height beside the "
              f"observability and txsim legs (block gap {NET_BLOCK_GAP_S} s); txsim "
              f"{net['txsim']['seconds']:.2f} s; relay {relay['relay_s']:.2f} s for "
              f"{len(relay['driven'])} heights (block interval {RELAY_GAP_S} s); "
              f"coordinator heights (ms) {[round(v, 1) for v in net['coord_ms']]} | {smi}")
        print(f"network swarm (SwarmConfig defaults): latency {json.dumps(sw['latency'])}, "
              f"{sw['samples_per_s']} cells/s, shed rate {sw['shed_rate']} (groups "
              f"{json.dumps(sw['groups'])}), Jain index {sw['fairness_index']}, "
              f"{sw['requests']} requests, {sw['answered']} answered, {sw['cells_served']} cells, "
              f"{sw['chunks']} chunks streamed, K7b launches {sw['k7b_launches']} | {smi}")
        for name, w in windows.items():
            print(f"network launches, {name} (heights {w['heights'][0]}-{w['heights'][1]}): "
                  f"{json.dumps({n: c for n, c in w['launches'].items() if c})}; "
                  f"{w['misses']} cold extensions ({w['new_contents']} new block contents, "
                  f"{w['adopted']} blocks adopted, {w['validated']} proposals validated), "
                  f"{w['rebuilt']} rebuilt, {w['chunks']} DAS chunks; predicted "
                  f"{json.dumps({n: c for n, c in w['want'].items() if c})}")
        print(f"network launches, relay leg ({relay['contents']} block contents, "
              f"{relay['misses']} cold extensions, one process): "
              f"{json.dumps({n: c for n, c in relay['launches'].items() if c})}")
        print(f"network launches, coordinator ({COORD_HEIGHTS} heights, one process): "
              f"{json.dumps({n: c for n, c in coord_launches.items() if c})}, predicted "
              f"{json.dumps({n: c for n, c in block_launches(COORD_HEIGHTS).items() if c})}")
        results["network"] = {key: net[key] for key in (
            "boot_s", "restart_boot_s", "catchup_s", "caught_up_heights", "commit_ms", "filled",
            "stopped_at", "heights", "mesh_s", "idle_ms_per_height", "health", "trace", "txsim",
            "swarm", "relay", "coord_ms", "coord_launches", "heights_at_read", "windows",
            "build_seconds")}
        for i, built in net["build_seconds"].items():
            check(built == 0.0, f"mesh validator {i} built the kernel library ({built} s) "
                  "instead of loading phase 1's")
        # every window: exactly one extension for each cold extension and
        # rebuilt block and one K7b gather for each DAS chunk; the cold
        # extensions within the bounds the window's block contents give
        for name, w in windows.items():
            check(w["launches"] == w["want"], f"network {name} launched "
                  f"{w['launches']}, predicted {w['want']}")
            lo, hi = w["bounds"]
            check(lo <= w["misses"] <= hi, f"network {name} made {w['misses']} cold "
                  f"extensions over heights {w['heights']}, which hold {w['new_contents']} "
                  f"block contents new to it ({w['adopted']} adopted, {w['validated']} "
                  f"proposals validated): outside [{lo}, {hi}]")
        for i in range(NET_VALIDATORS):
            check(windows[f"validator {i}"]["misses"] > 0, f"mesh validator {i} extended "
                  "no block on the card")
        check(sw["k7b_launches"] > 0, "the swarm's node launched no K7b gather")
        # one process: the proposer's prepare extends, the validators hit
        # the device's content cache
        check(coord_launches == block_launches(COORD_HEIGHTS), f"the coordinator's heights "
              f"launched {coord_launches}, predicted {block_launches(COORD_HEIGHTS)}")

    if "4k" in selected:
        # --- 4k. the host regime against the card ------------------------------
        t_host = time.perf_counter()
        hr = host_phase(dev, [DEFAULT_GOV_MAX_SQUARE_SIZE, 128], DEFAULT_GOV_MAX_SQUARE_SIZE,
                        args.seed + 14, counted=True)
        host_launches = sum_counts(hr["launches"].values())
        for name in EXTEND_KERNELS:
            check(hr["launches"]["extend"][name] > 0,
                  f"kernel {name} was not launched by phase 4k's card extensions")
        for name in REPAIR_KERNELS:
            check(hr["launches"]["repair"][name] > 0,
                  f"kernel {name} was not launched by phase 4k's card repairs")
        for name in LAGRANGE_ONLY_KERNELS:
            check(hr["launches"]["repair"][name] == 0,
                  f"kernel {name} was launched by phase 4k's card repairs")
        check(set(hr["launches"]["testnode_host"].values()) == {0},
              "the host TestNode's height launched a kernel")
        med = {side: {k: statistics.median(v) for k, v in hr[f"{side}_ms"].items()}
               for side in ("host", "card")}
        print(f"host regime: dah.extend_and_header(device='cpu') at k="
              f"{sorted(hr['host_ms'])}, {HOST_SQUARES} seeded squares each, EDS bytes, 4k "
              "axis roots and data roots equal to the card's, no launch on the host calls; "
              f"host repair at k={hr['repair_ms']['k']} ({hr['repair_ms']['withheld']} cells "
              "withheld, the DAH's roots) equal to repair_square_device on the card; the row "
              f"memo under {hr['memo']['codec']} at k={hr['memo']['k']} in a child: "
              f"{json.dumps(hr['memo']['memo'])}, bytes equal to the card's; TestNode(cpu) and "
              f"TestNode(card) at k={DEFAULT_GOV_MAX_SQUARE_SIZE} on one data root "
              f"{hr['testnode_root']}; in {time.perf_counter() - t_host:.2f} s")
        print(f"host regime CPU: {hr['threads']} (the memo child: {hr['memo']['threads']})")
        print("host regime walls (ms, medians): extend_and_header host "
              + ", ".join(f"k={k} {v:.3f}" for k, v in med["host"].items())
              + "; card " + ", ".join(f"k={k} {v:.3f}" for k, v in med["card"].items())
              + "; host breakdown " + json.dumps(hr["host_breakdown"])
              + f"; repair host {statistics.median(hr['repair_ms']['host']):.3f}, card "
              f"{statistics.median(hr['repair_ms']['card']):.3f}; memo child square 1 "
              f"{hr['memo']['walls_ms'][0]:.3f}, square 2 (memo) {hr['memo']['walls_ms'][1]:.3f}, "
              f"square 2 fused {hr['memo']['fused_ms']:.3f}; produce_block host "
              f"{hr['testnode_ms']['host']:.3f}, card {hr['testnode_ms']['card']:.3f} | {smi}")
        print("host regime card breakdown (ms, medians of "
              f"{HOST_RUNS}): {json.dumps(hr['breakdown'])} | {smi}")
        print(f"host regime launches (card legs only): {json.dumps(hr['launches'])}")
        results["host_regime"] = {key: hr[key] for key in (
            "threads", "host_ms", "card_ms", "breakdown", "host_breakdown", "repair_ms",
            "memo", "testnode_ms", "testnode_root", "launches")}

    if "4l" in selected:
        # --- 4l. the tool gates' twins on the card -----------------------------
        t_tools = time.perf_counter()
        tp = tools_phase(dev, counted=True)
        tools_launches = tp["launches"]
        for name, t in tp["twins"].items():
            legs = ", ".join(f"{k}: ok" for k in t["summaries"])
            print(f"tool twin {name}: {legs}; wall {t['wall_s']:.2f} s | {smi}")
            for what, got, want in t["predictions"]:
                print(f"tool twin {name} launches, {what}: "
                      f"{json.dumps({n: c for n, c in got.items() if c})}, predicted "
                      f"{json.dumps({n: c for n, c in want.items() if c})}")
        print(f"tool twins: {len(tp['twins'])} on the card, {TOOL_PARALLEL} at a time, in "
              f"{time.perf_counter() - t_tools:.2f} s, every node's launches as predicted | {smi}")
        results["tools"] = {name: {"wall_s": t["wall_s"], "summaries": t["summaries"]}
                            for name, t in tp["twins"].items()}

    # every K5, K8b and K9a launch of the paths in this process went to the
    # Leopard kernels
    path_entries = entries_since(entries_before)
    bit_gemm_launches = {name: sum(path_entries.get(e, 0) for e in es)
                         for name, (_, es, _) in BIT_GEMM_FORMS.items()}
    check(not any(bit_gemm_launches.values()),
          f"a path launched a bit-GEMM kernel under leopard-ff8: {path_entries}")
    print(f"K5's, K8b's and K9a's launches by C entry over the paths in this process: "
          f"{json.dumps({e: path_entries.get(e, 0) for e in LEOPARD_ENTRIES})} (the Leopard "
          f"kernels), {json.dumps(bit_gemm_launches)} (the bit-GEMM kernels)")
    paths = (extend_launches, serve_launches, repair_launches, fraud_launches, catchup_launches,
             sharded_launches, app_launches, app_mesh_launches, devnet_launches, service_launches,
             network_launches, host_launches, tools_launches)
    launches = {name: sum(p.get(name, 0) for p in paths) for name in kernels.KERNELS}
    launches.update(bit_gemm_launches)

    # --- 5. kernels line, device, result -------------------------------------
    if "2" in selected:
        line = {"kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": errs[name],
                **perf[name],
            }
            for name in (*kernels.KERNELS, *BIT_GEMM_FORMS)
        ]}
        results.update(line)
    else:
        line = {"kernels": "not measured: phase 2 was not selected", "launches": launches}
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"chip_smoke: phases {','.join(sorted(selected))} in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
