#!/usr/bin/env python3
"""Drive the celestia_tpu_torch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit, and the nvcc build of
   ``celestia_tpu_torch/csrc/*.cu``;
2. every CUDA kernel against its plain PyTorch twin on the card, at the
   main path's shapes, byte for byte (K4 with its levels output at 512
   leaves, K7b ``das_proof_gather`` on 1,024 cells of a k = 128 block);
3. the Go-pinned DAH hashes (``da/golden.py``) through the port's entry
   points on the card;
4. the extension path: seeded BlobTx streams, proposer ``square.build`` ->
   ``dah.extend_block`` on the card (through the device-resident plane),
   validator ``square.construct`` -> ``extend_block`` again, 4 blocks at
   max square size 64 and 4 at 128; the two data roots must agree with each
   other and with the port's plain path (``device="cpu"``);
4b. the serving path on the same 8 blocks, each extended through the plane
   on the card: 64 seeded light clients x 16 samples as one
   ``das.sample_proofs_batch`` of 1,024 cells served by the K7b gather,
   every proof verified against the data root; namespace data for every
   blob namespace and a share proof for every blob, equal to the plain
   path's; the same cells after the card's entry is dropped, served from
   the EDS on the card (K1 + K3 over the touched rows, K1 + K4 for the root
   tree, one K7b gather: each launched), and by the host prover from the
   plain path's EDS, all with equal bytes.  Serving a block on the card
   must make no host-prover call and no whole-EDS fetch.  Each path's
   launch counts are reset just before it and read just after; each kernel
   of the path must be > 0;
5. the kernels line (JSON: time, bound, plain time, library time, launches
   summed over both paths) and, last, ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port; nothing of JAX or of ``celestia_tpu``.
It exits non-zero without a result when no CUDA device is present or the
port is not beside it.
"""

from __future__ import annotations

import argparse
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
}
SOURCES = {
    "sha256_batch": "celestia_tpu_torch/csrc/sha256.cu",
    "nmt_leaf_digests": "celestia_tpu_torch/csrc/nmt.cu",
    "nmt_combine_level": "celestia_tpu_torch/csrc/nmt.cu",
    "rfc6962_root": "celestia_tpu_torch/csrc/rfc6962.cu",
    "rs_extend": "celestia_tpu_torch/csrc/rs_extend.cu",
    "das_proof_gather": "celestia_tpu_torch/csrc/das_gather.cu",
}
# the kernels each path must launch
EXTEND_KERNELS = ("sha256_batch", "nmt_leaf_digests", "nmt_combine_level", "rfc6962_root",
                  "rs_extend")
SERVE_KERNELS = ("das_proof_gather",)
# a block on the card with no cached entry (da/device_plane.py sample_proofs_from_eds)
MISS_KERNELS = ("sha256_batch", "nmt_combine_level", "rfc6962_root", "das_proof_gather")
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
    from celestia_tpu_torch.da import dah, das, device_plane, eds_cache, golden
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

    def time_ms(fn, reps: int = 20) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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

    k = 128
    n2 = 2 * k
    sq = upload(rng.integers(0, 256, (k, k, 512), dtype=np.uint8))
    # the main path's shapes at k = 128: the EDS, the leaf grid, the roots
    eds = rs.extend_cuda(sq, gf256.active_codec())
    grid = nmt.eds_leaf_digests(eds)
    compare("nmt_leaf_digests", grid, nmt.eds_leaf_digests_plain(eds), "k=128 EDS")
    lvl = nmt.combine_grid(grid)
    compare("nmt_combine_level", lvl, nmt.combine_grid_plain(grid), "k=128 first level")
    nodes = lvl
    while nodes.shape[-2] > 1:
        nxt = nmt.combine_level(nodes)
        compare("nmt_combine_level", nxt, nmt.combine_level_plain(nodes),
                f"k=128 level m={nodes.shape[-2]}")
        nodes = nxt
    roots = nodes[:, 0].reshape(2, n2, 90)
    compare("nmt_combine_level", roots, nmt.eds_nmt_roots_plain(eds), "k=128 roots")

    rand_roots = upload(rng.integers(0, 256, (4 * k, 90), dtype=np.uint8))
    leaf_hashes = nmt.rfc6962_leaf_hashes(rand_roots)
    compare("sha256_batch", leaf_hashes, nmt.rfc6962_leaf_hashes_plain(rand_roots),
            "RFC-6962 leaf hashes of 512 roots")
    data_root = nmt.rfc6962_tree(leaf_hashes)
    compare("rfc6962_root", data_root, nmt.rfc6962_tree_plain(leaf_hashes), "512 leaves")
    host_root = nmt.rfc6962_root_np(list(rand_roots.cpu().numpy()))
    check(data_root.cpu().numpy().tobytes() == host_root.tobytes(),
          "rfc6962_root != rfc6962_root_np (hashlib)")
    root_tree = nmt.rfc6962_tree_levels(leaf_hashes)
    compare("rfc6962_root", root_tree, nmt.rfc6962_tree_levels_plain(leaf_hashes),
            "levels output, 512 leaves")
    for got, want in zip(nmt.rfc6962_level_stack(rand_roots),
                         nmt.rfc6962_level_stack_plain(rand_roots)):
        compare("rfc6962_root", got, want, f"rfc6962_level_stack level of {want.shape[0]}")
    check(root_tree[-1].cpu().numpy().tobytes() == host_root.tobytes(),
          "rfc6962_root levels output: root != rfc6962_root_np (hashlib)")

    # K7b on a k = 128 block's plane entry, 1,024 cells (edges included)
    eds_k, grid_k, levels_k, tree_k = device_plane._extend_levels(sq)
    entry = device_plane.DevicePlaneEntry(k, bytes(32), eds_k, grid_k, levels_k, tree_k)
    cells = [(0, 0), (0, n2 - 1), (n2 - 1, 0), (n2 - 1, n2 - 1)] + [
        (int(r), int(c)) for r, c in rng.integers(0, n2, (CLIENTS * SAMPLES - 4, 2))
    ]
    g_sources = entry.gather_sources()
    g_items = device_plane.proof_items(k, cells)
    g_bytes = len(cells) * device_plane._cell_layout(k)[2]
    compare("das_proof_gather", gather.das_proof_gather(g_sources, g_items, g_bytes),
            gather.das_proof_gather_plain(g_sources, g_items, g_bytes), "1,024 cells at k=128")
    g_items_dev = torch.from_numpy(g_items).to(dev)
    g_out = torch.empty(g_bytes, dtype=torch.uint8, device=dev)
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

    lib_out = torch.cat([t.reshape(-1) for t in library_gather()])
    check(lib_out.numel() == g_bytes, "index_select yardstick gathers another byte count")

    for codec in gf256.CODECS:
        for kk in (1, 2, 4, 8, 16, 32, 64, 128):
            s = upload(rng.integers(0, 256, (kk, kk, 512), dtype=np.uint8))
            compare("rs_extend", rs.extend_cuda(s, codec), rs.extend_plain(s, codec),
                    f"k={kk} codec={codec}")
    print("kernels: byte-equal to their plain versions "
          f"(K5 at k=1..128 x {len(gf256.CODECS)} codecs, K2/K3 at k=128, K4 at n=512)")

    # times at the main path's k = 128 shapes (per block)
    codec = gf256.active_codec()
    check(codec == gf256.CODEC_LEOPARD, f"K5's bound counts the Leopard codec, active: {codec}")
    G = rs.encode_matrix_bits_tensor(k, codec, str(dev))
    # the bit-GEMM's B operand for the three quadrants: Q0's bit planes as
    # (8k, k*512), three times over
    q0_bits = rs.unpack_bits(sq).permute(1, 0, 2).reshape(8 * k, k * 512)
    bits = torch.cat([q0_bits] * 3, dim=1).contiguous()

    def k3_all_levels(first, level):
        nodes = first(grid)
        while nodes.shape[-2] > 1:
            nodes = level(nodes)
        return nodes

    parents = 4 * k * (n2 - 1)
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
            lambda: k3_all_levels(nmt.combine_grid, nmt.combine_level),
            lambda: k3_all_levels(nmt.combine_grid_plain, nmt.combine_level_plain),
            None,
            bound(n2 * n2 * 90 + 2 * n2 * 90,
                  parents * compressions(181) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
        ),
        "rfc6962_root": (
            lambda: nmt.rfc6962_tree_levels(leaf_hashes),
            lambda: nmt.rfc6962_tree_levels_plain(leaf_hashes),
            None,
            bound(4 * k * 32 + (8 * k - 1) * 32,
                  (4 * k - 1) * compressions(65) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
        ),
        "rs_extend": (
            lambda: rs.extend_cuda(sq, codec),
            lambda: rs.extend_plain(sq, codec),
            # the GEMM part only: G int8[8k, 8k] @ bits int8[8k, 3k*512]
            lambda: torch._int_mm(G, bits),
            bound(k * k * 512 + n2 * n2 * 512, leopard_extend_ops(k), INT32_OPS_PER_S),
        ),
        "das_proof_gather": (
            lambda: gather.launch_gather(g_sources, g_items_dev, g_out),
            lambda: gather.das_proof_gather_plain(g_sources, g_items, g_bytes),
            library_gather,
            # each gathered byte read once and written once, and the index table
            bound(2 * g_bytes + g_items.nbytes, 0, INT32_OPS_PER_S),
        ),
    }
    for name, (fast, plain, lib, (b_ms, b_by)) in timings.items():
        perf[name] = {
            "ms": time_ms(fast),
            "plain_ms": time_ms(plain, reps=3),
            "library_ms": time_ms(lib) if lib is not None else None,
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        lib_ms = perf[name]["library_ms"]
        print(f"{name}: {perf[name]['ms']:.4f} ms, plain {perf[name]['plain_ms']:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} | {smi}")
    # K1 + K3 over the rows of a proof (da/proof.py row_range_proofs): a
    # namespace or blob spanning 5 rows of a k = 128 block
    row_leaves = nmt.eds_row_leaves(eds, range(5))
    for got, want in zip(nmt.nmt_level_stack(row_leaves), nmt.nmt_level_stack_plain(row_leaves)):
        compare("nmt_combine_level", got, want, f"5-row level stack, level of {want.shape[-2]}")
    rows_ms = time_ms(lambda: nmt.nmt_level_stack(row_leaves))
    rows_plain_ms = time_ms(lambda: nmt.nmt_level_stack_plain(row_leaves), reps=3)
    rows_bound, rows_by = bound(
        row_leaves.numel() + 5 * (2 * n2 - 1) * 90,
        5 * (n2 * compressions(542) + (n2 - 1) * compressions(181)) * SHA_OPS_PER_COMPRESSION,
        INT32_OPS_PER_S,
    )
    print(f"nmt_level_stack, 5 rows at k=128 (K1 + {n2.bit_length() - 1} x K3): {rows_ms:.4f} ms, "
          f"plain {rows_plain_ms:.3f} ms, bound {rows_bound:.4f} ms ({rows_by}), library none "
          f"| {smi}")
    results["row_level_stack_5_rows"] = {"ms": rows_ms, "plain_ms": rows_plain_ms,
                                         "bound_ms": rows_bound, "bound_by": rows_by}
    del bits, q0_bits, G, entry, eds_k, grid_k, levels_k, tree_k, lib_select, g_out, row_leaves

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
    # the warm k = 128 calls again, phase by phase (outside the counted run)
    split_ms = []
    for entry, dah_g, coords, warm in split_inputs:
        ph = [time.perf_counter()]
        sources = entry.gather_sources()
        items = device_plane.proof_items(entry.k, coords)
        nbytes = len(coords) * device_plane._cell_layout(entry.k)[2]
        gather.check_items(sources, items, nbytes)
        ph.append(time.perf_counter())
        items_dev = torch.from_numpy(items).to(dev)
        out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        ph.append(time.perf_counter())
        gather.launch_gather(sources, items_dev, out)
        torch.cuda.synchronize()
        ph.append(time.perf_counter())
        host = out.cpu().numpy()
        ph.append(time.perf_counter())
        again = device_plane.assemble_proofs(entry.k, dah_g, coords, host)
        ph.append(time.perf_counter())
        check(again == warm, "phase-by-phase gather differs")
        split_ms.append([(ph[i + 1] - ph[i]) * 1e3 for i in range(5)])
    del split_inputs
    serve_medians = {
        kk: {"gather_ms": statistics.median(w for w, _, _ in v),
             "card_miss_ms": statistics.median(c for _, c, _ in v),
             "host_prover_ms": statistics.median(h for _, _, h in v)}
        for kk, v in serve_ms.items()
    }
    split = dict(zip(("index_build_ms", "upload_ms", "gather_ms", "fetch_ms", "assembly_ms"),
                     (statistics.median(s[i] for s in split_ms) for i in range(5))))
    for kk, m in serve_medians.items():
        print(f"sample_proofs_batch k={kk}, {CLIENTS * SAMPLES} cells: median "
              f"{m['gather_ms']:.3f} ms warm (gather), {m['card_miss_ms']:.3f} ms from the EDS on "
              f"the card (no entry), {m['host_prover_ms']:.3f} ms host prover "
              f"| {smi}")
    print(f"sample_proofs_batch k=128 phases (median of {len(split_ms)}): "
          + ", ".join(f"{n} {v:.3f}" for n, v in split.items()) + f" | {smi}")
    results["sample_proofs_batch_ms"] = serve_medians
    results["sample_proofs_batch_phases_ms"] = split
    launches = {name: extend_launches[name] + serve_launches[name] for name in kernels.KERNELS}

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
