"""ctypes bindings for the native C++ host library (native/celestia_native.cpp).

Builds the shared object on demand with g++ (cached by source mtime) and
exposes the same operations as the device kernels — used as the CPU
comparison leg in bench.py and as a host fallback.  If no compiler is
available the module degrades gracefully (``available()`` returns False).

Copy of ``celestia_tpu/utils/native.py`` for the port.  One change: the
port builds its own copy of the library, ``build/torch_native/
celestia_native.so``, to a temporary name that ``os.replace`` moves into
place, so a process of either package never loads a library the other is
still writing.  The port's host legs (commitments, secp256k1, and the
host regime's extension, roots and repair in da/dah.py, ops/nmt.py and
ops/rs.py, which :func:`require` the library) are the JAX package's; no
device leg of the port calls this library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "celestia_native.cpp"
# CELESTIA_TPU_TORCH_NATIVE_SO points the loader at an alternative build of the
# same source — the sanitizer harness (make native-sanitize) rebuilds the
# library under TSan/ASan at a side path and re-runs the thread-scaling
# byte-identity tests against it without disturbing the pristine .so.
# An overridden .so is never rebuilt here: the override owns its build.
_SO_OVERRIDE = os.environ.get("CELESTIA_TPU_TORCH_NATIVE_SO", "")
_SO = (
    Path(_SO_OVERRIDE)
    if _SO_OVERRIDE
    else _REPO_ROOT / "build" / "torch_native" / "celestia_native.so"
)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_has_glv = False
_has_glv_pre = False

# One-way degradation pin (specs/robustness.md "degradation ladder"): a
# native fault mid-run poisons the library for the REST OF THE PROCESS,
# so every caller falls back to the byte-identical table-GF/jax legs.
# The pin is deliberately one-way — a library that faulted once under
# load cannot be trusted to silently come back, and a mid-chain flap
# between legs would make perf numbers and telemetry unreadable.  Only
# clear_poison(force=True) (tests, operator intervention) clears it.
_poison_lock = threading.Lock()
_poison_reason: Optional[str] = None  # celint: guarded-by(_poison_lock)


def poison(reason: str) -> None:
    """Pin the native library OFF after a fault (loud, one-way)."""
    global _poison_reason
    from celestia_tpu_torch.utils import faults
    from celestia_tpu_torch.utils.logging import Logger

    with _poison_lock:
        if _poison_reason is not None:
            return  # already degraded; first reason wins
        _poison_reason = reason
    faults.record_degradation("native", reason)
    Logger(level="warn").warn(
        "native DA pipeline poisoned: falling back to the pure table-GF "
        "path for the rest of the process (byte-identical, slower)",
        reason=reason[:200],
    )


def poisoned() -> Optional[str]:
    """The poison reason, or None when the native leg is trusted."""
    with _poison_lock:
        return _poison_reason


def clear_poison(force: bool = False) -> None:
    """Un-pin the degradation.  Refuses without ``force=True``: the pin
    exists precisely so nothing switches back silently."""
    global _poison_reason
    with _poison_lock:
        if _poison_reason is None:
            return
        if not force:
            raise RuntimeError(
                "the native pipeline was poisoned "
                f"({_poison_reason!r}) and the degradation pin is one-way; "
                "pass force=True only if you KNOW the fault is resolved"
            )
        _poison_reason = None


def _build() -> bool:
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
                str(_SRC), "-o", str(tmp),
            ],
            check=True,
            capture_output=True,
            timeout=300,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    if _SO_OVERRIDE:
        if not _SO.exists():
            return None  # sanitizer harness must have built it already
    elif not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rs_extend_square.argtypes = [u8p, u8p, u8p, ctypes.c_int, ctypes.c_int]
    lib.sha256_batch.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.nmt_root.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.create_commitment.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, u8p,
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    try:
        lib.create_commitments_batch.argtypes = [
            u8p, ctypes.c_int, i32p, i32p, i32p, ctypes.c_int, u8p,
            ctypes.c_int,
        ]
    except AttributeError:
        return None  # stale .so predating this round: see codec guard below
    lib.eds_nmt_roots.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    try:
        lib.eds_nmt_roots_mt.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ]
        lib.sha256_batch_mt.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ]
    except AttributeError:
        return None  # stale .so predating the threaded hashing entry points
    lib.gf_matmul_axes.argtypes = [
        u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.extend_block_cpu.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p,
    ]
    try:
        lib.gf_load_mul.argtypes = [u8p]
        lib.leo_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.leo_extend_square_cpu.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.extend_block_leopard_cpu.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p,
        ]
        lib.leo_decode_axes.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_int,
        ]
    except AttributeError:
        # stale .so without the codec symbols: the GF legs would compute
        # in the WRONG field for the leopard codec (gf_load_mul missing),
        # so the lib is unusable as a coherent unit — degrade to the
        # pure-Python/device paths entirely rather than risk wrong parity
        return None
    lib.secp256k1_ecmul_double.argtypes = [u8p, u8p, u8p, u8p, u8p]
    lib.secp256k1_ecmul_double.restype = ctypes.c_int
    lib.secp256k1_ecmul_double_batch.argtypes = [
        u8p, u8p, u8p, ctypes.c_int, u8p, u8p, ctypes.c_int,
    ]
    global _has_glv, _has_glv_pre
    try:
        lib.secp256k1_ecmul_double_glv_batch.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, u8p, u8p, ctypes.c_int,
        ]
        _has_glv = True
    except AttributeError:
        # stale .so without the GLV symbol: degrade to the plain path
        _has_glv = False
    try:
        lib.secp256k1_ecmul_double_glv_batch_pre.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, u8p, u8p, ctypes.c_int,
        ]
        _has_glv_pre = True
    except AttributeError:
        # stale .so without the precomputed-table symbol: the legacy GLV
        # batch still works, ingress just loses the per-batch amortization
        _has_glv_pre = False
    _lib = lib
    return _lib


def available() -> bool:
    with _poison_lock:
        if _poison_reason is not None:
            return False
    return _load() is not None


def require() -> None:
    """Raise ``RuntimeError`` naming why when the library is not
    :func:`available` (poisoned, or it did not build or load).  The port's
    host regime (da/dah.py, ``ops/rs.py`` ``repair_square``) runs only on
    this library: it has no plain fallback."""
    if available():
        return
    reason = poisoned() or (
        f"{_SO} could not be loaded"
        if _SO_OVERRIDE
        else f"g++ could not build {_SRC} into {_SO}, or it did not load"
    )
    raise RuntimeError(f"host regime: the native library is unavailable: {reason}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_loaded_codec: Optional[str] = None

# Serializes gf_load_mul against every in-flight table-method call
# (ADVICE r5): the native MUL table is process-global, so a codec switch
# racing an rs_extend_square / extend_block_cpu / gf_matmul_axes call on
# another thread would compute in a mixed field and return silently
# wrong parity.  Each table-method wrapper holds this lock across BOTH
# _ensure_field and the native call; re-entrant so nested helpers work.
_field_lock = threading.RLock()


def _ensure_field(lib) -> None:
    """Keep the native MUL table in the active codec's representation so
    table-method GF legs here stay bit-identical to the device path.
    Callers must hold ``_field_lock`` across this AND the native call."""
    global _loaded_codec
    # celint: allow(layering) — native is the C twin of ops/gf256: both sides must share ONE codec pin and ONE mul table or the byte-identity contract breaks; the import is lazy and utils/ has no module-level dependency on ops/
    from celestia_tpu_torch.ops import gf256

    codec = gf256.active_codec()
    if codec == _loaded_codec:
        return
    table = np.ascontiguousarray(gf256.mul_table(codec))
    lib.gf_load_mul(_ptr(table))
    _loaded_codec = codec
    # first native use of the codec's field: from here on set_active_codec
    # refuses to SWITCH codecs outside tests (pin-once-at-genesis)
    gf256.mark_codec_used()


def _resolve_threads(nthreads: Optional[int]) -> int:
    """None -> the process-wide pool size (``--cpu-threads`` /
    CELESTIA_TPU_TORCH_CPU_THREADS / os.cpu_count); ints pass through (0 keeps
    the C side's hardware_concurrency fallback)."""
    if nthreads is None:
        from celestia_tpu_torch.utils import hostpool

        return hostpool.cpu_threads()
    return nthreads


def rs_extend_square(square: np.ndarray) -> np.ndarray:
    """uint8[k, k, B] -> uint8[2k, 2k, B] (bit-identical to the device)."""
    # celint: allow(layering) — byte-identity twin: the native leg must use the SAME encode matrix as the device path (ops/gf256 owns it); lazy import, no module-level edge
    from celestia_tpu_torch.ops.gf256 import encode_matrix

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    square = np.ascontiguousarray(square, dtype=np.uint8)
    k, B = square.shape[0], square.shape[2]
    E = np.ascontiguousarray(encode_matrix(k))
    out = np.zeros((2 * k, 2 * k, B), dtype=np.uint8)
    with _field_lock:
        _ensure_field(lib)
        lib.rs_extend_square(_ptr(square), _ptr(E), _ptr(out), k, B)
    return out


def sha256_batch(msgs: np.ndarray, nthreads: Optional[int] = None) -> np.ndarray:
    """SHA-256 over n equal-length rows, striped across the host pool."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, length = msgs.shape
    out = np.zeros((n, 32), dtype=np.uint8)
    lib.sha256_batch_mt(_ptr(msgs), n, length, _ptr(out),
                        _resolve_threads(nthreads))
    return out


def eds_nmt_roots(eds: np.ndarray, nthreads: Optional[int] = None) -> np.ndarray:
    """uint8[2k, 2k, B] -> uint8[4k, 90] (rows then columns), the 4k
    independent trees sharded across the host pool."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    eds = np.ascontiguousarray(eds, dtype=np.uint8)
    n = eds.shape[0]
    k = n // 2
    out = np.zeros((2 * n, 90), dtype=np.uint8)
    lib.eds_nmt_roots_mt(_ptr(eds), k, eds.shape[2], _ptr(out),
                         _resolve_threads(nthreads))
    return out


def extend_block_cpu(square: np.ndarray, nthreads: Optional[int] = None):
    """Full CPU ExtendBlock: square -> (eds, axis roots, data root).

    Threaded native pipeline with the extend->roots overlap — the honest
    CPU comparison leg for bench.py (role of Leopard-RS + crypto/sha256
    in the reference, SURVEY.md §2.2).
    """
    from celestia_tpu_torch.utils import faults

    faults.fire("native.extend")
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    # celint: allow(layering) — byte-identity twin: same encode matrix as the device path (see rs_extend_square)
    from celestia_tpu_torch.ops.gf256 import encode_matrix

    square = np.ascontiguousarray(square, dtype=np.uint8)
    k, B = square.shape[0], square.shape[2]
    E = np.ascontiguousarray(encode_matrix(k))
    eds = np.zeros((2 * k, 2 * k, B), dtype=np.uint8)
    roots = np.zeros((4 * k, 90), dtype=np.uint8)
    data_root = np.zeros(32, dtype=np.uint8)
    with _field_lock:
        _ensure_field(lib)
        lib.extend_block_cpu(
            _ptr(square), _ptr(E), k, B, _resolve_threads(nthreads),
            _ptr(eds), _ptr(roots), _ptr(data_root),
        )
    return eds, roots, data_root


def leo_encode(data: np.ndarray) -> np.ndarray:
    """Leopard FFT encode of one axis: data uint8[k, B] -> parity
    uint8[k, B] (O(k log k); codec-independent — always the leopard
    code, used for cross-validation and the bench leg)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    k, B = data.shape
    parity = np.zeros((k, B), dtype=np.uint8)
    lib.leo_encode(_ptr(data), k, B, _ptr(parity))
    return parity


def leo_extend_square(
    square: np.ndarray, nthreads: Optional[int] = None
) -> np.ndarray:
    """Leopard-codec square extension (FFT per axis): uint8[k, k, B] ->
    uint8[2k, 2k, B], quadrant layout as rs_extend_square."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    square = np.ascontiguousarray(square, dtype=np.uint8)
    k, B = square.shape[0], square.shape[2]
    eds = np.zeros((2 * k, 2 * k, B), dtype=np.uint8)
    lib.leo_extend_square_cpu(
        _ptr(square), _ptr(eds), k, B, _resolve_threads(nthreads)
    )
    return eds


def leo_decode_axes(
    data: np.ndarray, present: np.ndarray, nthreads: Optional[int] = None
) -> np.ndarray:
    """Leopard O(n log n) erasure decode, IN PLACE, threaded across axes.

    data uint8[n_axes, 2k, B]: axis rows in EDS position order with
    erased rows zeroed; present uint8[n_axes, 2k] marks received rows.
    Returns ok uint8[n_axes] (0 = fewer than k rows present).  Leopard
    codec only — the caller must hold the leopard-ff8 codec active."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not data.flags.c_contiguous or data.dtype != np.uint8:
        raise ValueError("data must be C-contiguous uint8 (decoded in place)")
    present = np.ascontiguousarray(present, dtype=np.uint8)
    n_axes, n, B = data.shape
    if present.shape != (n_axes, n):
        raise ValueError(f"present must be ({n_axes}, {n})")
    # the C side uses fixed 256-entry domain buffers (the field has 256
    # points); an oversized axis must fail HERE, not smash the stack
    if not (1 <= n <= 256) or n & (n - 1):
        raise ValueError(f"axis length must be a power of two <= 256, got {n}")
    ok = np.zeros(n_axes, dtype=np.uint8)
    lib.leo_decode_axes(
        _ptr(data), _ptr(present), n_axes, n, B, _ptr(ok),
        _resolve_threads(nthreads),
    )
    return ok


def extend_block_leopard_cpu(
    square: np.ndarray, nthreads: Optional[int] = None
):
    """Full CPU ExtendBlock via the Leopard O(n log n) FFT codec:
    square -> (eds, axis roots, data root).  The honest vs_leopard_cpu
    comparison leg for bench.py (the reference's codec class at full
    size, same SHA/NMT stage as extend_block_cpu)."""
    from celestia_tpu_torch.utils import faults

    faults.fire("native.extend")
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    square = np.ascontiguousarray(square, dtype=np.uint8)
    k, B = square.shape[0], square.shape[2]
    eds = np.zeros((2 * k, 2 * k, B), dtype=np.uint8)
    roots = np.zeros((4 * k, 90), dtype=np.uint8)
    data_root = np.zeros(32, dtype=np.uint8)
    lib.extend_block_leopard_cpu(
        _ptr(square), k, B, _resolve_threads(nthreads), _ptr(eds),
        _ptr(roots), _ptr(data_root),
    )
    return eds, roots, data_root


def nmt_root(leaves: np.ndarray) -> np.ndarray:
    """Root of one NMT whose leaves are ns-prefixed payloads.

    leaves: uint8[n, leaf_len] with n a power of two -> uint8[90].
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    n, leaf_len = leaves.shape
    out = np.zeros(90, dtype=np.uint8)
    lib.nmt_root(_ptr(leaves), n, leaf_len, _ptr(out))
    return out


def create_commitment(leaves: np.ndarray, sizes) -> bytes:
    """Blob share commitment in ONE native call: NMT roots of the
    mountain-range subtrees + the RFC-6962 root over them.

    leaves: uint8[n, leaf_len] ns-prefixed shares; sizes: mountain widths
    summing to n.  Replaces ~one ctypes crossing per subtree."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    n, leaf_len = leaves.shape
    sizes_arr = np.ascontiguousarray(sizes, dtype=np.int32)
    out = np.zeros(32, dtype=np.uint8)
    lib.create_commitment(
        _ptr(leaves), n, leaf_len,
        sizes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sizes_arr), _ptr(out),
    )
    return out.tobytes()


def create_commitments_batch(
    leaves: np.ndarray, blob_off: np.ndarray, sizes: np.ndarray,
    size_off: np.ndarray, nthreads: Optional[int] = None,
) -> np.ndarray:
    """Commitments for MANY blobs in one call: leaves uint8[total, leaf_len]
    (all blobs' ns-prefixed shares concatenated), blob_off int32[n+1] row
    offsets, sizes int32[...] mountain widths (concatenated), size_off
    int32[n+1] offsets into sizes.  Returns uint8[n, 32]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    blob_off = np.ascontiguousarray(blob_off, dtype=np.int32)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    size_off = np.ascontiguousarray(size_off, dtype=np.int32)
    n = len(blob_off) - 1
    out = np.zeros((n, 32), dtype=np.uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.create_commitments_batch(
        _ptr(leaves), leaves.shape[1],
        blob_off.ctypes.data_as(i32), sizes.ctypes.data_as(i32),
        size_off.ctypes.data_as(i32), n, _ptr(out),
        _resolve_threads(nthreads),
    )
    return out


def gf_matmul_axes(
    D: np.ndarray, X: np.ndarray, nthreads: Optional[int] = None
) -> np.ndarray:
    """Per-axis GF(256) matmul: D uint8[n, R, k] x X uint8[n, k, B] ->
    uint8[n, R, B] (the repair decode step, threaded)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    D = np.ascontiguousarray(D, dtype=np.uint8)
    X = np.ascontiguousarray(X, dtype=np.uint8)
    n, R, k = D.shape
    B = X.shape[2]
    if X.shape != (n, k, B):
        raise ValueError(f"X must be ({n}, {k}, B), got {X.shape}")
    out = np.zeros((n, R, B), dtype=np.uint8)
    with _field_lock:
        _ensure_field(lib)
        lib.gf_matmul_axes(
            _ptr(D), _ptr(X), _ptr(out), n, R, k, B,
            _resolve_threads(nthreads),
        )
    return out


def ecmul_double(u1_be: bytes, u2_be: bytes, pub33: bytes):
    """(u1*G + u2*Q) affine coords, or None on infinity/invalid pubkey.

    The expensive inner op of ECDSA verification (reference relies on the
    decred C secp256k1 for this — SURVEY.md §2.2); scalar math mod the group
    order stays in Python where CPython's pow() is already C.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    u1 = np.frombuffer(u1_be, dtype=np.uint8)
    u2 = np.frombuffer(u2_be, dtype=np.uint8)
    pub = np.frombuffer(pub33, dtype=np.uint8)
    out_x = np.zeros(32, dtype=np.uint8)
    out_y = np.zeros(32, dtype=np.uint8)
    ok = lib.secp256k1_ecmul_double(
        _ptr(u1), _ptr(u2), _ptr(pub), _ptr(out_x), _ptr(out_y)
    )
    if not ok:
        return None
    return out_x.tobytes(), out_y.tobytes()


def ecmul_double_batch(
    u1s: np.ndarray, u2s: np.ndarray, pubs: np.ndarray,
    nthreads: Optional[int] = None,
):
    """Threaded batch of ecmul_double.

    u1s/u2s: uint8[n, 32] big-endian scalars; pubs: uint8[n, 33] compressed
    keys. Returns (ok uint8[n], x uint8[n, 32]).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    u1s = np.ascontiguousarray(u1s, dtype=np.uint8)
    u2s = np.ascontiguousarray(u2s, dtype=np.uint8)
    pubs = np.ascontiguousarray(pubs, dtype=np.uint8)
    n = u1s.shape[0]
    out_x = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    lib.secp256k1_ecmul_double_batch(
        _ptr(u1s), _ptr(u2s), _ptr(pubs), n, _ptr(out_x), _ptr(ok),
        _resolve_threads(nthreads),
    )
    return ok, out_x


def has_glv() -> bool:
    return _load() is not None and _has_glv


def has_glv_pre() -> bool:
    return _load() is not None and _has_glv_pre


# below this many live verifies the _pre symbol's per-stripe table
# normalization costs more than the mixed-affine digit loop saves
_GLV_PRE_MIN_BATCH = 4


def ecmul_double_glv_batch(
    ks: np.ndarray, signs: np.ndarray, pubs: np.ndarray,
    nthreads: Optional[int] = None,
    precomp: Optional[bool] = None,
):
    """Threaded batch of GLV-split double multiplications.

    ks: uint8[n, 128] — four 32-byte big-endian scalar magnitudes per
    verify (|k1_G|, |k2_G|, |k1_Q|, |k2_Q| from utils.secp256k1._glv_split);
    signs: uint8[n, 4] (1 = negative component); pubs: uint8[n, 64]
    UNCOMPRESSED affine keys (x||y big-endian).
    Returns (ok uint8[n], x uint8[n, 32]).

    precomp — route to secp256k1_ecmul_double_glv_batch_pre, which
    normalizes every verify's Q-tables to affine with one shared
    Montgomery inversion per stripe so the digit loops run all-mixed-
    affine.  None = auto (use it when available and the batch is big
    enough to amortize the table normalization); True = force when the
    symbol exists; False = legacy Jacobian-table symbol.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ks = np.ascontiguousarray(ks, dtype=np.uint8)
    signs = np.ascontiguousarray(signs, dtype=np.uint8)
    pubs = np.ascontiguousarray(pubs, dtype=np.uint8)
    n = ks.shape[0]
    out_x = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    if precomp is None:
        precomp = _has_glv_pre and n >= _GLV_PRE_MIN_BATCH
    fn = (
        lib.secp256k1_ecmul_double_glv_batch_pre
        if (precomp and _has_glv_pre)
        else lib.secp256k1_ecmul_double_glv_batch
    )
    fn(
        _ptr(ks), _ptr(signs), _ptr(pubs), n, _ptr(out_x), _ptr(ok),
        _resolve_threads(nthreads),
    )
    return ok, out_x
