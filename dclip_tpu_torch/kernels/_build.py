"""Build-on-first-use for the CUDA kernels in `csrc/`, loaded with ctypes.

Counterpart of `dclip_tpu/native/__init__.py`'s build-on-demand pattern,
with nvcc in place of g++. All `csrc/*.cu` compile into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libdclip_torch_kernels.so csrc/*.cu

The library is rebuilt when the SHA-256 of the sources (`*.cu`, `*.cuh`)
differs from the stamp written beside it. A missing nvcc or a failed
compile raises with nvcc's output; there is no fallback. nvcc is taken
from `$CUDA_HOME/bin`, `/usr/local/cuda/bin` or `PATH`, in that order.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdclip_torch_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
_STAMP_PATH = LIB_PATH + ".sha256"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes of every extern "C" entry point; all return cudaError_t.
_SIGNATURES = {
    # x, scale, bias, y, rows, d, eps, stream
    "dclip_layernorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    # a, w, bias, residual (nullable), c, m, n, k, gelu, stream
    "dclip_gemm_bias_act_residual_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # qkv, out, b, s, heads, stream
    "dclip_attention_bf16": [_P, _P, _I, _I, _I, _P],
}


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels of dclip_tpu_torch are built from source at first use"
    )


def build(force: bool = False) -> float:
    """Compile `csrc/*.cu` into LIB_PATH unless the stamp matches the
    sources. Returns the seconds spent compiling (0.0 when up to date).
    nvcc's output, with `-Xptxas -v` register / shared-memory / spill
    lines, is kept in LOG_PATH."""
    digest = source_digest()
    if not force and os.path.exists(LIB_PATH) and os.path.exists(_STAMP_PATH):
        with open(_STAMP_PATH) as f:
            if f.read().strip() == digest:
                return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    cmd = [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    with open(LOG_PATH, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    # Atomic publish: a concurrent loader only ever sees a complete library.
    os.replace(tmp, LIB_PATH)
    with open(f"{_STAMP_PATH}.tmp.{os.getpid()}", "w") as f:
        f.write(digest)
    os.replace(f"{_STAMP_PATH}.tmp.{os.getpid()}", _STAMP_PATH)
    return seconds


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dclip_error_string.argtypes = [ctypes.c_int]
            lib.dclip_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dclip_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
