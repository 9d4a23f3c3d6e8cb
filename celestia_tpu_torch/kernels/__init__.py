"""Build and bind the port's CUDA kernels (``celestia_tpu_torch/csrc/*.cu``).

At first use every ``.cu`` source is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c <src>.cu
    nvcc -shared <objects> -o build/celestia_tpu_torch/libcelestia_tpu_torch-<digest>.so

The library's name carries a digest of the sources and flags, so a
changed source rebuilds and an unchanged one loads the library already
built.  A failed build raises; nothing falls back.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.  A host
entry (``ctt_rs_leopard_tables``, K5's skew tables,
``ctt_rs_leopard_decode_tables``, K8b's, and
``ctt_rs_leopard_partial_tables``, K9a's) runs on the CPU and launches
nothing: :func:`host_call`.  Each
kernel keeps a plain integer count of its launches (:func:`launch_counts`),
which ``chip_smoke.py`` reads to show that the main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "celestia_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "ctt_sha256_batch": (_P, _P, _LL, _I, _I, _P),
    "ctt_nmt_leaf_digests": (_P, _P, _I, _I, _I, _I, _P),
    "ctt_nmt_leaf_digests_rows": (_P, _P, _I, _I, _P, _I, _P),
    "ctt_nmt_reduce_levels": (_P, _P, _LL, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P),
    "ctt_rfc6962_root": (_P, _P, _I, _I, _I, _I, _P),
    "ctt_rs_extend": (_P, _P, _P, _P, _P, _I, _P),
    "ctt_das_proof_gather": (_P, _I, _P, _I, _P, _P),
    "ctt_rs_extend_batched": (_P, _P, _P, _P, _P, _I, _I, _P),
    "ctt_rs_decode_matrices": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ctt_rs_decode_axes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ctt_rs_repair_verdicts": (_P, _P, _P, _P, _P, _P, _I, _P),
    "ctt_rs_extend_rows": (_P, _P, _P, _P, _P, _I, _I, _P),
    "ctt_rs_col_parity_partial": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ctt_xor_reduce_scatter": (_P, _I, _P, _P, _I, _LL, _I, _LL, _P),
    "ctt_das_cell_gather": (_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P),
    "ctt_dependent_load_probe": (_P, _P, _I, _P),
    "ctt_rs_leopard_extend": (_P, _P, _P, _I, _P),
    "ctt_rs_leopard_extend_batched": (_P, _P, _P, _I, _I, _P),
    "ctt_rs_leopard_extend_rows": (_P, _P, _P, _I, _I, _P),
    "ctt_rs_leopard_decode_axes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ctt_rs_leopard_col_parity_partial": (_P, _P, _P, _I, _I, _I, _I, _P),
    # host entries (no stream; :func:`host_call`)
    "ctt_rs_leopard_tables": (_P, _P, _I, _P, _LL),
    "ctt_rs_leopard_decode_tables": (_P, _P, _I, _P, _LL),
    "ctt_rs_leopard_partial_tables": (_P, _P, _I, _I, _I, _P, _LL),
}

# kernel name -> C entry; the names chip_smoke.py and PERF.md report.  K5
# and K5b launch ``ctt_rs_leopard_extend*``, K8b
# ``ctt_rs_leopard_decode_axes`` and K9a ``ctt_rs_leopard_col_parity_partial``
# under leopard-ff8 (ops/rs.py picks the entry by codec); their launches
# count under these names.
KERNELS = {
    "sha256_batch": "ctt_sha256_batch",
    "nmt_leaf_digests": "ctt_nmt_leaf_digests",
    "nmt_combine_level": "ctt_nmt_reduce_levels",
    "rfc6962_root": "ctt_rfc6962_root",
    "rs_extend": "ctt_rs_extend",
    "das_proof_gather": "ctt_das_proof_gather",
    "rs_extend_batched": "ctt_rs_extend_batched",
    "rs_decode_matrices": "ctt_rs_decode_matrices",
    "rs_decode_axes": "ctt_rs_decode_axes",
    "rs_repair_verdicts": "ctt_rs_repair_verdicts",
    "rs_col_parity_partial": "ctt_rs_col_parity_partial",
    "xor_reduce_slabs": "ctt_xor_reduce_scatter",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_entry_launches: Dict[str, int] = {}  # C entry -> kernel launches, never reset
build_seconds: Optional[float] = None  # wall time of this process's build (0.0: reused)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the port's "
            "CUDA kernels cannot be built"
        )
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source digest)."""
    global build_seconds
    cu = sorted(CSRC_DIR.glob("*.cu"))
    lib = BUILD_DIR / f"libcelestia_tpu_torch-{_digest(cu + sorted(CSRC_DIR.glob('*.cuh')))}.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in cu]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for src, obj in zip(cu, objs)
    ]
    failures = []
    for src, proc in zip(cu, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib)  # atomic: a concurrent build of the same digest is harmless
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def call(entry: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` followed by the current
    stream of ``device``; raise on a CUDA error.  Counts nothing: use it
    alone only for a measurement probe, never for a kernel of a path."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA entry {entry} failed to launch: cudaError {rc}")


def launch(kernel: str, device: torch.device, *args, launches: int = 1,
           entry: Optional[str] = None) -> None:
    """Call ``kernel``'s C entry (or ``entry``, another entry launching the
    same kernel, e.g. K5's row pass ``ctt_rs_extend_rows``) with ``args``
    followed by the current stream of ``device``; count ``launches`` kernel
    launches of ``kernel``; raise on a CUDA error."""
    entry = entry or KERNELS[kernel]
    call(entry, device, *args)
    with _lock:
        _launches[kernel] += launches
        _entry_launches[entry] = _entry_launches.get(entry, 0) + launches


def host_call(entry: str, *args) -> None:
    """Call the host C entry ``entry`` (it runs on the CPU and launches
    nothing, e.g. ``ctt_rs_leopard_tables``) with ``args``; raise when it
    refuses them."""
    rc = getattr(library(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"C entry {entry} refused its arguments: {rc}")


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def entry_launch_counts() -> Dict[str, int]:
    """Kernel launches by C entry since the process started (never reset):
    which of a kernel's entries -- K5's or K8b's Leopard form or its
    bit-GEMM -- a window launched, read as the difference of two
    snapshots."""
    with _lock:
        return dict(_entry_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def check_cuda_tensor(t: torch.Tensor, name: str, shape=None) -> None:
    """Raise unless ``t`` is a contiguous uint8 CUDA tensor (of ``shape``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.uint8:
        raise ValueError(f"{name} must be uint8, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
