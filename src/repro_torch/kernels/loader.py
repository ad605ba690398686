"""Build and load the hand-written CUDA kernels in ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of
their source and flags, so an edited source is rebuilt and an unchanged one
is reused. A failed build raises; nothing falls back to the plain versions.

Every exported C function takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the Python
wrappers in the kernel packages check devices, dtypes, shapes and
contiguity, allocate outputs and raise on a non-zero return.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> {C function: argtypes}
EXPORTS = {
    "weightings": {
        # H, beta, fold_idx, hx, out, scratch, tickets, L, Q, K1, K2, tq,
        # tr, stream
        "weightings_launch": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    },
    "flat_hist": {
        # a, b, w, out, P, N, KA, KB, wdouble, stream
        "flat_hist_launch": [P, P, P, P, I, I, I, I, I, P],
    },
    "hist2d": {
        # max_smem*, sms*
        "hist2d_device": [P, P],
        # cy, smem, blocks*
        "hist2d_resident": [I, I64, P],
        # bi, bj, w, out, N, KI, KJ, n_slabs, slab_rows, n_chunks, cy,
        # stream
        "hist2d_launch": [P, P, P, P, I64, I, I, I, I, I, I, P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> tuple[float, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    spent and nvcc's output per kernel (``-Xptxas -v``: registers, shared
    memory, spills); raises ``RuntimeError`` with it on failure."""
    names = list(EXPORTS) if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    logs: dict[str, str] = {}
    if not todo:
        return 0.0, logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu:\n{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in EXPORTS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
