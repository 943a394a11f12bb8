"""ctypes bindings for the host runtime `dclip_native.cc`: the mmap KV store
(`.dcs`) and the host top-k.

The KV-store and top-k part of `dclip_tpu/native/__init__.py`, with the
port's own copy of the C++ source. The library is compiled with g++ at
first use into `native/_build/` (git-ignored), never next to the JAX
package's `.so`. As in the JAX package the library is optional on the
host: `available()` gates every use, the teacher cache then keeps its
rows in memory and `topk_ip` takes numpy.
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
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
_FP = ctypes.POINTER(ctypes.c_float)


def _compile() -> bool:
    """g++ to a per-process temp path, then an atomic rename: concurrent
    builders never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        print(f"dclip_native build failed ({e}); using fallbacks")
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or \
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
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
