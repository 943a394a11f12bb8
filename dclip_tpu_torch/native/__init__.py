"""ctypes bindings for the host runtime: `dclip_native.cc` (the mmap KV
store `.dcs` and the host top-k) and `jpeg_decode.cc` (libjpeg decode +
resample + normalize of one image in one call).

Counterpart of `dclip_tpu/native/__init__.py`, with the port's own copies
of both C++ sources. Each library is compiled with g++ at first use into
`native/_build/` (git-ignored), never next to the JAX package's `.so`; the
JPEG decoder builds apart (it links libjpeg), so either can exist without
the other.

- The KV store and top-k are optional on the host, as in the JAX package:
  `available()` gates every use, the teacher cache then keeps its rows in
  memory and `topk_ip` takes numpy.
- The JPEG decoder is not: a caller that asks for it (`decode_preprocess`,
  `load_jpeg`) gets the library or a RuntimeError carrying g++'s or the
  loader's message (a missing `jpeglib.h` or `libjpeg`). The JAX package
  prints and degrades to PIL instead (`dclip_tpu/native/__init__.py:
  119-131`); the port builds from source or raises (ROADMAP Queue 3,
  differences by design). `jpeg_available()` asks without raising.
"""
from __future__ import annotations

import ctypes
import io
import os
import struct
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dclip_native.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libdclip_native.so")
_JPEG_SRC = os.path.join(_HERE, "jpeg_decode.cc")
_JPEG_LIB_PATH = os.path.join(BUILD_DIR, "libdclip_jpeg.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_jpeg_lib: Optional[ctypes.CDLL] = None
_jpeg_error: Optional[str] = None

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
_FP = ctypes.POINTER(ctypes.c_float)


def _stale(lib_path: str, src: str) -> bool:
    return not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src)


def _build_so(lib_path: str, args: List[str]) -> Optional[str]:
    """g++ to a per-process temp path, then an atomic rename: concurrent
    builders (spawned pipeline workers) never load a half-written library.
    None on success, else what went wrong, with g++'s stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, *args]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if out.returncode == 0:
            os.replace(tmp, lib_path)
            return None
        return f"{' '.join(cmd)} exited {out.returncode}: {out.stderr.strip()}"
    except (subprocess.SubprocessError, OSError) as e:
        return f"{' '.join(cmd)}: {e}"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _compile() -> bool:
    error = _build_so(_LIB_PATH, [_SRC, "-lpthread"])
    if error is not None:
        print(f"dclip_native build failed ({error}); using fallbacks")
    return error is None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale(_LIB_PATH, _SRC):
            if not _compile():
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        sigs = {
            "dcs_open": (_P, [ctypes.c_char_p, ctypes.c_int]),
            "dcs_count": (_I64, [_P]),
            "dcs_put": (ctypes.c_int, [_P, ctypes.c_char_p, _U64, ctypes.c_char_p, _U64]),
            "dcs_sync": (ctypes.c_int, [_P]),
            "dcs_get": (_I64, [_P, ctypes.c_char_p, _U64, ctypes.c_char_p, _U64]),
            "dcs_key_at": (_I64, [_P, _U64, ctypes.c_char_p, _U64]),
            "dcs_keys_dump": (_I64, [_P, ctypes.c_char_p, _U64]),
            "dcs_close": (None, [_P]),
            "dcs_topk_ip": (None, [_FP, _I64, _FP, _I64, _I64, _I64, _FP,
                                   ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_jpeg() -> ctypes.CDLL:
    """The JPEG decode library, built at first use; raises RuntimeError
    with the build's or the loader's message when it cannot be had (the
    verdict is kept for the process, so a failing build runs once)."""
    global _jpeg_lib, _jpeg_error
    with _lock:
        if _jpeg_lib is None and _jpeg_error is None:
            # The JAX package's flags: -march=native is safe because the
            # library is built on the machine that loads it, never shipped.
            _jpeg_error = _build_so(_JPEG_LIB_PATH, ["-march=native", "-funroll-loops",
                                                     _JPEG_SRC, "-ljpeg"]) \
                if _stale(_JPEG_LIB_PATH, _JPEG_SRC) else None
            if _jpeg_error is None:
                try:
                    lib = ctypes.CDLL(_JPEG_LIB_PATH)
                except OSError as e:  # e.g. the libjpeg runtime is missing
                    _jpeg_error = f"loading {_JPEG_LIB_PATH}: {e}"
                else:
                    lib.dcj_decode_preprocess.restype = ctypes.c_int
                    lib.dcj_decode_preprocess.argtypes = [
                        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _FP, _FP, _FP, _FP, ctypes.POINTER(ctypes.c_int)]
                    _jpeg_lib = lib
        if _jpeg_lib is None:
            raise RuntimeError(f"the native JPEG decoder (native/jpeg_decode.cc, needs "
                               f"jpeglib.h and libjpeg) is unavailable: {_jpeg_error}")
        return _jpeg_lib


def jpeg_available() -> bool:
    """Whether the JPEG decode library builds and loads here."""
    try:
        load_jpeg()
    except RuntimeError:
        return False
    return True


def decode_preprocess(data: bytes, student_size: int, teacher_size: int, fast: bool = False,
                      mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, Tuple[int, int]]]:
    """Decode a JPEG and make both pipeline tensors in one native call
    (`dclip_tpu/native/__init__.py:150-173`'s contract).

    Returns (student [S, S, 3] f32, normalized with `mean` / `std` when
    given, teacher [T, T, 3] f32 in [0, 1], (orig_w, orig_h)), or None
    when libjpeg cannot decode the bytes to RGB (not a JPEG, CMYK,
    truncated or corrupt): the pipeline then takes its PIL route. `fast`:
    libjpeg's scaled DCT, the largest 1/2^k shrink whose shortest side
    still covers both sizes. Raises RuntimeError when the library cannot
    be built or loaded. The GIL is released for the call (ctypes)."""
    lib = load_jpeg()
    student = np.empty((student_size, student_size, 3), np.float32)
    teacher = np.empty((teacher_size, teacher_size, 3), np.float32)
    wh = (ctypes.c_int * 2)()
    consts = [None if x is None else np.ascontiguousarray(x, np.float32) for x in (mean, std)]
    rc = lib.dcj_decode_preprocess(
        data, len(data), student_size, teacher_size, 1 if fast else 0,
        *(ctypes.cast(None, _FP) if c is None else c.ctypes.data_as(_FP) for c in consts),
        student.ctypes.data_as(_FP), teacher.ctypes.data_as(_FP), wh)
    if rc != 0:
        return None
    return student, teacher, (int(wh[0]), int(wh[1]))


class NativeKVStore:
    """dict-of-bytes over the mmap'd native store, with numpy helpers:
    single-writer appends, `sync()` publishes."""

    def __init__(self, path: str, writable: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("dclip_native unavailable (no g++?)")
        self._lib = lib
        self._h = lib.dcs_open(path.encode(), 1 if writable else 0)
        if not self._h:
            raise OSError(f"cannot open native store {path}")
        self.path = path
        self.writable = writable

    def __len__(self) -> int:
        return int(self._lib.dcs_count(self._h))

    def put(self, key: str, value: bytes) -> None:
        kb = key.encode()
        rc = self._lib.dcs_put(self._h, kb, len(kb), value, len(value))
        if rc != 0:
            raise OSError(f"dcs_put failed ({rc})")

    def get(self, key: str) -> Optional[bytes]:
        kb = key.encode()
        n = self._lib.dcs_get(self._h, kb, len(kb), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        self._lib.dcs_get(self._h, kb, len(kb), buf, n)
        return buf.raw

    def __contains__(self, key: str) -> bool:
        kb = key.encode()
        return self._lib.dcs_get(self._h, kb, len(kb), None, 0) >= 0

    def keys(self) -> List[str]:
        """All keys in one bulk native call."""
        size = self._lib.dcs_keys_dump(self._h, None, 0)
        if size <= 0:
            return []
        buf = ctypes.create_string_buffer(int(size))
        self._lib.dcs_keys_dump(self._h, buf, size)
        raw, out, off = buf.raw, [], 0
        while off + 4 <= size:
            (kl,) = struct.unpack_from("<I", raw, off)
            out.append(raw[off + 4:off + 4 + kl].decode())
            off += 4 + kl
        return out

    def sync(self) -> None:
        rc = self._lib.dcs_sync(self._h)
        if rc != 0:
            raise OSError(f"dcs_sync failed ({rc})")

    def close(self) -> None:
        if self._h:
            self._lib.dcs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.writable and self._h:
            self.sync()
        self.close()

    def put_array(self, key: str, arr: np.ndarray) -> None:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        self.put(key, buf.getvalue())

    def get_array(self, key: str) -> Optional[np.ndarray]:
        raw = self.get(key)
        if raw is None:
            return None
        return np.load(io.BytesIO(raw), allow_pickle=False)


def topk_ip(queries: np.ndarray, store: np.ndarray, k: int,
            n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host exact inner-product top-k (the FAISS IndexFlatIP contract);
    numpy when the library is unavailable."""
    queries = np.ascontiguousarray(queries, np.float32)
    store = np.ascontiguousarray(store, np.float32)
    q, d = queries.shape
    n = store.shape[0]
    k = min(k, n)
    lib = _load()
    if lib is None:
        scores = queries @ store.T
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, idx, 1), idx.astype(np.int32)
    out_scores = np.empty((q, k), np.float32)
    out_idx = np.empty((q, k), np.int32)
    lib.dcs_topk_ip(queries.ctypes.data_as(_FP), q, store.ctypes.data_as(_FP), n, d, k,
                    out_scores.ctypes.data_as(_FP),
                    out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    return out_scores, out_idx
