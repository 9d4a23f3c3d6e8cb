#!/usr/bin/env python3
"""Drive the celestia_tpu_torch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit, and the nvcc build of
   ``celestia_tpu_torch/csrc/*.cu``;
2. every CUDA kernel against its plain PyTorch twin on the card, at the
   main path's shapes, byte for byte;
3. the Go-pinned DAH hashes (``da/golden.py``) through the port's entry
   points on the card;
4. the main path: seeded BlobTx streams, proposer ``square.build`` ->
   ``dah.extend_block`` on the card, validator ``square.construct`` ->
   ``extend_block`` again, 4 blocks at max square size 64 and 4 at 128; the
   two data roots must agree with each other and with the port's plain
   path (``device="cpu"``).  Every kernel's launch count is reset just
   before this phase and read just after; each must be > 0;
5. the kernels line (JSON: time, bound, plain time, library time, launches)
   and, last, ``{"ok": true, "device": {...}}``.

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
}
SOURCES = {
    "sha256_batch": "celestia_tpu_torch/csrc/sha256.cu",
    "nmt_leaf_digests": "celestia_tpu_torch/csrc/nmt.cu",
    "nmt_combine_level": "celestia_tpu_torch/csrc/nmt.cu",
    "rfc6962_root": "celestia_tpu_torch/csrc/rfc6962.cu",
    "rs_extend": "celestia_tpu_torch/csrc/rs_extend.cu",
}


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
    from celestia_tpu_torch.da import dah, golden
    from celestia_tpu_torch.da import square as square_mod
    from celestia_tpu_torch.da.blob import Blob, BlobTx
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.ops import gf256, nmt, rs
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
            lambda: nmt.rfc6962_tree(leaf_hashes),
            lambda: nmt.rfc6962_tree_plain(leaf_hashes),
            None,
            bound(4 * k * 32 + 32,
                  (4 * k - 1) * compressions(65) * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S),
        ),
        "rs_extend": (
            lambda: rs.extend_cuda(sq, codec),
            lambda: rs.extend_plain(sq, codec),
            # the GEMM part only: G int8[8k, 8k] @ bits int8[8k, 3k*512]
            lambda: torch._int_mm(G, bits),
            bound(k * k * 512 + n2 * n2 * 512, leopard_extend_ops(k), INT32_OPS_PER_S),
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
    del bits, q0_bits, G

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

    # --- 4. main path --------------------------------------------------------
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
    launches = kernels.launch_counts()
    print(f"main path: {len(blocks)} blocks (proposer + validator) in {main_s:.2f} s; "
          f"launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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
        _, dah_plain = dah.extend_block(sq_p, device="cpu")
        check(dah_plain.hash == dah_p.hash, f"card and plain data roots differ at k={kk}")
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
            _, roots_dev, root_dev = dah.extend_and_roots(sq_dev)
            ev[2].record()
            torch.cat([roots_dev.reshape(-1), root_dev]).cpu()
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
