#!/usr/bin/env python3
"""Drive the celestia_tpu_torch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

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
   k/R = 8/8, 32/4, 128/8; the tensor-core bit-GEMM kernels K5 and K8b at
   every k = 1..128 and K5's row pass and K9a (n_in = k/R down to 1) for
   both codecs; each kernel's
   time as the host issues it and its GPU time (queued behind a sleep)
   beside its bound, plain and library times, the bit-GEMM kernels' share
   of their tensor-core floor; K4's per-level latency, the slope of its GPU
   time at batch 1 over n = 2..1024 leaves and over n = 2..32 (warp 0
   alone: half of it is one compression's latency in the kernel), and K3's
   and K4's dependency floor (their levels' chain of compressions at that
   latency), beside the same chain at K1's time per block on one long
   message (a compression fed from L2); the SASS opcode mix of K4; K7b's
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
   blob namespace and a share proof for every blob, equal to the plain
   path's; the same cells after the card's entry is dropped, served from
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
   the plane's EDS, with no repair on the host.  Medians of 5 warm calls per
   mask at k = 128 (wall, breakdown, kernels by CUDA events).  The
   byzantine cases (a provided cell the decode overwrites, a Q1 cell off
   the codeword, zeroed roots, too few cells) raise on the card with the
   messages of the ``device="cpu"`` path at k = 32;
4d. fraud: a Q1 cell of a k = 128 block flipped and its DAH recommitted on
   the card; ``fraud.detect_bad_encoding`` finds the row, the BEFP built on
   the card verifies against the bad DAH and not the honest one; at k = 32
   the card's BEFP equals the ``device="cpu"`` path's;
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
5. the kernels line (JSON: time, bound, plain time, library time, launches
   summed over every path) and, last, ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port; nothing of JAX or of ``celestia_tpu``.
It exits non-zero without a result when no CUDA device is present or the
port is not beside it.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks: HBM3 bandwidth from NVIDIA's data sheet; the int32 rate is
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# dense int8 tensor-core peak (NVIDIA's data sheet): the floor of the
# bit-GEMM form that K5, K5b, K8b and K9a compute
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer operations of one SHA-256 compression, counted from
# csrc/sha256.cuh as sm_90 issues them: a rotate is one funnel shift, 3-input
# logic one LOP3, and up to three addends (an immediate among them) one
# IADD3.  A schedule word is sigma0 and sigma1 (2 SHF + SHR + LOP3 each) and
# 2 IADD3 = 10; a round is Sigma1 4 + ch 1 + t1 2 + Sigma0 4 + maj 1 + e 1 +
# a 1 = 14; then 8 final adds.
SHA_OPS_PER_COMPRESSION = 48 * 10 + 64 * 14 + 8

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
    "rs_extend": "celestia_tpu_torch/csrc/rs_extend.cu",
    "das_proof_gather": "celestia_tpu_torch/csrc/das_gather.cu",
    "rs_extend_batched": "celestia_tpu_torch/csrc/rs_extend.cu",
    "rs_decode_matrices": "celestia_tpu_torch/csrc/rs_decode.cu",
    "rs_decode_axes": "celestia_tpu_torch/csrc/rs_decode.cu",
    "rs_repair_verdicts": "celestia_tpu_torch/csrc/rs_decode.cu",
    "rs_col_parity_partial": "celestia_tpu_torch/csrc/rs_extend.cu",
    "xor_reduce_slabs": "celestia_tpu_torch/csrc/rs_sharded.cu",
}
# the kernels each path must launch
EXTEND_KERNELS = ("nmt_leaf_digests", "nmt_combine_level", "rfc6962_root", "rs_extend")
SERVE_KERNELS = ("das_proof_gather",)
# a block on the card with no cached entry (da/device_plane.py sample_proofs_from_eds)
MISS_KERNELS = ("nmt_leaf_digests", "nmt_combine_level", "rfc6962_root", "das_proof_gather")
# repair: decode, re-extension, verdicts, axis roots
REPAIR_KERNELS = ("rs_decode_matrices", "rs_decode_axes", "rs_extend", "rs_repair_verdicts",
                  "nmt_leaf_digests", "nmt_combine_level")
# fraud: detection (decode + verdicts), then the BEFP's orthogonal trees and gather
FRAUD_KERNELS = ("rs_decode_matrices", "rs_decode_axes", "rs_repair_verdicts",
                 "nmt_leaf_digests", "nmt_combine_level", "das_proof_gather")
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compressions(msg_len: int) -> int:
    return (msg_len + 9 + 63) // 64


def leopard_extend_ops(k: int) -> int:
    """32-bit operations of the least-work form of the Leopard (leopard-ff8)
    extension, counted low: per codeword of k shares an IFFT and an FFT of
    (k/2)*log2(k) butterflies ``x ^= y*w; y ^= x`` each, on 512-byte shares,
    at 3 operations per 4-byte word (the multiply counted as one, two XORs),
    for the 3k codewords of Q1, Q2 and Q3.  The JAX package's bit-lift
    matrix form, 2*(8k)^2*3k*512 int8 operations, does far more work."""
    butterflies = 2 * (k // 2) * (k.bit_length() - 1)
    return 3 * k * butterflies * (512 // 4) * 3


def leopard_decode_ops(k: int, axes: int) -> int:
    """32-bit operations of the least-work Leopard erasure decode of
    ``axes`` codewords, counted low as ``leopard_extend_ops`` counts the
    extension: an IFFT and an FFT over the 2k positions,
    (2k/2)*log2(2k) butterflies each, at 3 operations per 4-byte word."""
    butterflies = 2 * k * ((2 * k).bit_length() - 1)
    return axes * butterflies * (512 // 4) * 3


def decode_matrix_ops(k: int, axes: int) -> int:
    """Operations of building ``axes`` Lagrange decode matrices (K8a), each
    term an XOR, a table lookup and an add: k^2 for the denominators, and
    per output row k for its numerator sum and k for its entries."""
    return axes * (k * k + 2 * (2 * k) * k) * 3


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


def bit_gemm_ops(rows: int, depth: int, cols: int) -> int:
    """int8 operations of a GF(2) bit-GEMM: G (rows x depth) times the
    inputs' bit planes (depth x cols), a multiply and an add each."""
    return 2 * rows * depth * cols


def kernel_sass_mix(kernel: str) -> dict:
    """Opcode counts of the built library's SASS for the kernel whose mangled
    name holds ``kernel`` (``cuobjdump -sass``, beside nvcc): how its rounds
    compile (SHF / LOP3 / IADD3), how many loads it holds and whether any
    spill (LDL / STL), and its longest runs of instructions with no load
    between them (in code order, with their SHF counts): a run that holds
    the rounds of two compressions took every message word from registers."""
    import os
    import re
    from collections import Counter

    from celestia_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernels.build())], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass):
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
                    "longest_load_free_runs": runs[:3]}
    raise AssertionError(f"no kernel {kernel} in the built library's SASS")


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()

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

    errs = {name: 0 for name in kernels.KERNELS}
    perf = {}

    def compare(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} differs from its plain version ({what}): max_abs_err {err}")

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
            compare("rs_extend", rs.extend_cuda(s, codec), rs.extend_plain(s, codec),
                    f"k={kk} codec={codec}")
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
            n_ax = min(2 * kk, kk + 3)
            known_np = known_sets(kk, n_ax)
            known_np[0] = np.arange(kk)  # the first k positions, as fraud detection asks
            known = upload(known_np)
            Dk = rs.decode_matrices_cuda(known, kk, codec)
            ek = rs.extend_cuda(upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8)), codec)
            for cols in (False, True):
                axes = upload(np.sort(rng.permutation(2 * kk)[:n_ax]).astype(np.int32))
                compare("rs_decode_axes",
                        rs.decode_axes_cuda(ek.clone(), Dk, known, axes, cols, codec),
                        rs.decode_axes_plain(ek.clone(), Dk, known, axes, cols, codec),
                        f"k={kk} {'columns' if cols else 'rows'} codec={codec}")
            if kk == 32:
                e32 = ek
        # K5's row pass and K9a on every shard, down to one input a shard
        for kk, R in ((8, 8), (32, 4), (128, 8)):
            rows_r = kk // R
            ek = rs.extend_cuda(upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8)), codec)
            Gk = rs.encode_matrix_bits_tensor(kk, codec, str(dev))
            parts = []
            for d in range(R):
                mine = ek[d * rows_r : (d + 1) * rows_r]
                compare("rs_extend", rs.extend_rows_cuda(mine[:, :kk].contiguous(), codec), mine,
                        f"row pass of shard {d} of {R} at k={kk} codec={codec}")
                top = mine[None]
                parts.append(rs.col_parity_partial_cuda(
                    top, *rs.partial_coefficients(kk, d * rows_r, rows_r, codec, dev)))
                compare("rs_col_parity_partial", parts[-1], rs.col_parity_partial_plain(
                    top, Gk[:, 8 * d * rows_r : 8 * (d + 1) * rows_r].contiguous()),
                    f"shard {d} of {R} (n_in={rows_r}) at k={kk} codec={codec}")
            compare("rs_col_parity_partial", rs.xor_reduce_slabs_plain(torch.stack(parts))[0],
                    ek[kk:], f"the {R} partials' XOR against the parity rows, k={kk} codec={codec}")
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
        compare("rs_extend_batched", e2, rs.extend_batched_plain(sq2, codec),
                f"n=2 k={kk} codec={codec}")
    compare("nmt_leaf_digests", nmt.eds_leaf_digests(e2), nmt.eds_leaf_digests_plain(e2),
            "batch of 2 EDSs at k=32")
    compare("nmt_combine_level", nmt.eds_nmt_roots(e2), nmt.eds_nmt_roots_plain(e2),
            "batched roots of 2 EDSs at k=32")
    del Dk, e32, rec, prov, av, sq2, e2
    print("kernels: byte-equal to their plain versions "
          f"(K5 and K8b at k=1..128 x {len(gf256.CODECS)} codecs, the row pass, K9a and K3's "
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
    scratch_plain = scratch.clone()
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
    tops, coeffs9, g_cols9, partials9 = [], [], [], []
    for d in range(R9):
        got = rs.extend_rows_cuda(sq[d * rows9 : (d + 1) * rows9], codec)
        compare("rs_extend", got, rs.extend_rows_plain(sq[d * rows9 : (d + 1) * rows9], codec),
                f"row pass of shard {d} of {R9} at k=128 against its plain version")
        compare("rs_extend", got, eds[d * rows9 : (d + 1) * rows9],
                f"row pass of shard {d} of {R9} at k=128 against the EDS's rows")
        top = eds[d * rows9 : (d + 1) * rows9][None]  # (1, k/R, 2k, 512): Q0 | Q1 rows
        tops.append(top)
        coeffs9.append(rs.partial_coefficients(k, d * rows9, rows9, codec, dev))
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
        "rs_decode_matrices": (
            lambda: rs.decode_matrices_cuda(known25, k, codec),
            lambda: rs._decode_matrices_dev(known25, k, codec),
            None,
            bound(N25 * k + N25 * n2 * k, decode_matrix_ops(k, N25), INT32_OPS_PER_S),
        ),
        "rs_decode_axes": (
            lambda: rs.decode_axes_cuda(scratch, D25, known25, axes25, False, codec),
            lambda: rs.decode_axes_plain(scratch_plain, D25, known25, axes25, False, codec),
            lambda: torch.bmm(Dh, Xh),
            # the k known cells read and the k unknown ones written per axis, D and
            # the index tables read once
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
        "rs_col_parity_partial": (
            lambda: [rs.col_parity_partial_cuda(t, *c) for t, c in zip(tops, coeffs9)],
            lambda: [rs.col_parity_partial_plain(t, g) for t, g in zip(tops, g_cols9)],
            lambda: [torch._int_mm(g, b) for g, b in zip(g_cols9, bits9)],
            # the top rows read once (16 MiB), R partials written (128 MiB); the
            # column codewords' share (2k of 3k) of the Leopard least-work form
            bound(k * n2 * 512 + R9 * k * n2 * 512, leopard_extend_ops(k) * 2 // 3,
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
    # the bit-GEMM kernels against the tensor-core floor of their form: K5 the
    # three quadrants' 8k x 8k GEMMs over k axes of 512 bytes, K5b 8 squares of
    # it, K8b the 25 % mask's 2k rows (8k unknown bit rows, 8k deep each), K9a
    # the 8 shards' 8k x 8(k/R) GEMMs over 2k columns
    floors = {
        "rs_extend": bit_gemm_ops(8 * k, 8 * k, 3 * k * 512),
        "rs_extend_batched": 8 * bit_gemm_ops(8 * k, 8 * k, 3 * k * 512),
        "rs_decode_axes": N25 * bit_gemm_ops(8 * k, 8 * k, 512),
        "rs_col_parity_partial": R9 * bit_gemm_ops(8 * k, 8 * rows9, n2 * 512),
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
    del scratch, scratch_plain, Dh, Xh, rec25, prov25, sq8, bits8, e8, D25, unknown_cells
    del tops, coeffs9, g_cols9, partials9, slabs9, outs9, bits9

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
        for ns in sorted({r[0] for r in ranges}):
            got = namespace_data.get_shares_by_namespace(eds_g, dah_g, ns)
            check(got.verify(dah_g), "namespace data does not verify")
            want = namespace_data.get_shares_by_namespace(eds_plain, dah_plain, ns)
            check(got.to_dict() == want.to_dict(), "namespace data differs from the plain path")
            n_ns += 1
        for _, start, end in ranges:
            got = proof.new_share_inclusion_proof(eds_g, dah_g, start, end)
            check(got.verify(dah_g.hash), "share proof does not verify")
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
              f"{len({r[0] for r in ranges})} namespaces proven and equal to the plain path")
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
    for name in OFF_PATH_KERNELS:
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

    paths = (extend_launches, serve_launches, repair_launches, fraud_launches, catchup_launches,
             sharded_launches)
    launches = {name: sum(p[name] for p in paths) for name in kernels.KERNELS}

    # --- 5. kernels line, device, result -------------------------------------
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
        for name in kernels.KERNELS
    ]}
    results.update(line)
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
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
