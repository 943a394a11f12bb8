"""Build-on-first-use for the CUDA kernels in `csrc/`, loaded with ctypes.

Counterpart of `dclip_tpu/native/__init__.py`'s build-on-demand pattern,
with nvcc in place of g++. Every `csrc/*.cu` compiles to an object file,
one nvcc process per source, all started together; one more nvcc call
links them into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o _build/obj/<name>.o csrc/<name>.cu   # each
    nvcc -shared -o _build/libdclip_torch_kernels.so _build/obj/*.o

The library is rebuilt when the SHA-256 of the sources (`*.cu`, `*.cuh`)
differs from the stamp written beside it. A missing nvcc or a failed
compile raises with nvcc's output; there is no fallback. nvcc is taken
from `$CUDA_HOME/bin`, `/usr/local/cuda/bin` or `PATH`, in that order.

Before the library is handed out, `load_library` runs its self-check
once per process (the counterpart of the JAX package's Pallas probe,
`dclip_tpu/kernels/__init__.py:32-46`, K13): one launch of
`csrc/status.cu`'s x2 kernel on an [8, 128] f32 buffer, compared exactly
with 2 x; a mismatch raises. There is no watchdog, memo or retry.
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
    # x, g, dh, scale, dx, rows, d, eps, stream
    "dclip_layernorm_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    # a, w, bias, residual, aux_in, aux_out (the last four nullable), c,
    # m, n, k, epilogue, out_f32, stream
    "dclip_gemm_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the same, w given as [n, k]
    "dclip_gemm_nt_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, y, c, m, n, k, k_tiles_per_split, splits, stream
    "dclip_gemm_tn_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, part, rows, n, rows_per_split, splits, stream
    "dclip_colsum_partial_bf16": [_P, _P, _I, _I, _I, _I, _P],
    # part, out, splits, n, stream
    "dclip_reduce_rows_f32": [_P, _P, _I, _I, _P],
    # x, g, dh, scale, dx (nullable), part, rows, d, eps, blocks, stream
    "dclip_layernorm_bwd_wgrad_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    # qkv, out, b, s, heads, stream
    "dclip_attention_bf16": [_P, _P, _I, _I, _I, _P],
    # q, k, v, ldq, ldk, ldv, out, pad, seg, m, rinv (the last four
    # nullable), b, s, heads, causal, stream
    "dclip_attention_fwd_bf16": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _P],
    # q, k, v, ldq, ldk, ldv, g, o, m, rinv, pad, seg (nullable), delta,
    # dq, dk, dv, lddq, lddk, lddv, b, s, heads, causal, stream
    "dclip_attention_bwd_bf16": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # si, st, ti, tt, part, out, b, d, temperature, weight, stream
    "dclip_distill_loss_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # si, st, ti, tt, part, cts, dsi, dst, b, d, temperature, stream
    "dclip_distill_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # qkv_t, qkv_i, text_mask, image_mask (nullable), out_t, out_i, b, t, p,
    # d, heads, stream
    "dclip_cross_attention_core": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x0, a0, s0, b0, y0, rows0, x1, a1, s1, b1, y1, rows1, d, eps, stream
    "dclip_add_layernorm_f32": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _F,
                                _P],
    # x, y, n, stream
    "dclip_probe_x2": [_P, _P, _I, _P],
}
LAUNCHES = {"loader_self_check": 0}
# The self-check's outcome in this process: device name and max |y - 2x|.
SELF_CHECK: dict = {}


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


def _run_all(cmds: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Start every command at once and wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    out = []
    for cmd, proc in zip(cmds, procs):
        try:
            text, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        out.append(subprocess.CompletedProcess(cmd, proc.returncode, text, ""))
    return out


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
    obj_dir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    objs, cmds = [], []
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        objs.append(obj)
        cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                     "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src])
    t0 = time.perf_counter()
    results = _run_all(cmds)
    if all(r.returncode == 0 for r in results):
        results += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                              "-o", tmp, *objs]])
    seconds = time.perf_counter() - t0
    with open(LOG_PATH, "w") as f:
        for r in results:
            f.write(" ".join(r.args) + "\n" + r.stdout)
    shutil.rmtree(obj_dir, ignore_errors=True)
    failed = [r for r in results if r.returncode != 0]
    if failed:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"(exit {r.returncode}) {' '.join(r.args)}\n{r.stdout}" for r in failed))
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
            _self_check(lib)
            _lib = lib
        return _lib


def reset_launches() -> None:
    LAUNCHES["loader_self_check"] = 0


def probe_x2_reference(x):
    return 2.0 * x


def probe_x2(x, lib: Optional[ctypes.CDLL] = None):
    """y = 2 x (the self-check's kernel). CUDA: x f32, contiguous."""
    import torch

    if x.device.type == "cpu":
        return probe_x2_reference(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_x2: the CUDA kernel takes a contiguous f32 tensor")
    lib = lib or load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.dclip_probe_x2(x.data_ptr(), y.data_ptr(), x.numel(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "loader self-check (probe_x2)")
    LAUNCHES["loader_self_check"] += 1
    return y


def _self_check(lib: ctypes.CDLL) -> None:
    import torch

    device = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128) * 0.5 - 100.25
    err = (probe_x2(x, lib) - 2.0 * x).abs().max().item()
    SELF_CHECK.update(device=torch.cuda.get_device_name(device), max_abs_err=err)
    if err != 0.0:
        raise RuntimeError(f"kernel library self-check failed: max |y - 2x| = {err}")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dclip_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
