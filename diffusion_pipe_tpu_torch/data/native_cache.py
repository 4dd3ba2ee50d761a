"""ctypes binding for the native shard-cache reader (native/cache_reader.cpp).

The port's copy of diffusion_pipe_tpu/data/native_cache.py. It builds the
same source with g++ on first use, into build/native/ at the repository
root (listed in .gitignore) rather than beside the source. Every entry
point degrades to None, so data/cache.py falls back to the Python read
path when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "cache_reader.cpp"
_LIB = _ROOT / "build" / "native" / "cache_reader.so"
_lib = None
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _LIB.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(_LIB), str(_SRC), "-lpthread"],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(_LIB))
        lib.cr_open.restype = ctypes.c_void_p
        lib.cr_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int,
        ]
        lib.cr_item_size.restype = ctypes.c_int64
        lib.cr_item_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.cr_read.restype = ctypes.c_int64
        lib.cr_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.cr_prefetch.restype = None
        lib.cr_prefetch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64
        ]
        lib.cr_close.restype = None
        lib.cr_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib_failed = True
    return _lib


MISSING = np.uint64(0xFFFFFFFFFFFFFFFF)


class NativeCacheReader:
    """mmap-backed reads + background page prefetch over cache shards."""

    def __init__(self, shard_paths: Sequence[str], items: np.ndarray,
                 n_threads: int = 2):
        """items: [n, 3] uint64 (shard, offset, size); size == MISSING for
        absent indices."""
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native cache reader unavailable")
        self._lib = lib
        self._items = np.ascontiguousarray(items, np.uint64)
        paths = [str(p).encode() for p in shard_paths]
        arr = (ctypes.c_char_p * len(paths))(*paths)
        self._h = lib.cr_open(
            arr, len(paths),
            self._items.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(self._items), n_threads,
        )
        if not self._h:
            raise RuntimeError("cr_open failed")

    def read(self, idx: int) -> Optional[bytes]:
        size = self._lib.cr_item_size(self._h, idx)
        if size < 0:
            return None
        buf = np.empty(size, np.uint8)
        got = self._lib.cr_read(
            self._h, idx, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if got != size:
            return None
        return buf.tobytes()

    def prefetch(self, indices) -> None:
        idxs = np.ascontiguousarray(indices, np.uint64)
        if idxs.size == 0:
            return
        self._lib.cr_prefetch(
            self._h, idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            idxs.size,
        )

    def close(self):
        if getattr(self, "_h", None):
            self._lib.cr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def available() -> bool:
    return _load_lib() is not None
