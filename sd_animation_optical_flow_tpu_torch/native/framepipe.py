"""ctypes binding of the native frame pipeline (``frameloader.cpp``).

Counterpart of ``sd_animation_optical_flow_tpu/native/framepipe.py``, with
its ``FramePipe`` API (``get``, ``put``, ``flush``, ``stats``, ``close``):
raw uint8 frame blobs ``<dir>/<idx:05d>.raw`` behind a read-ahead thread
and a write-behind thread. The library is built at first use by ``g++
-O2 -shared -fPIC -std=c++17 -pthread`` into ``build/native/`` beside the
package (git-ignored), named by a hash of the source and the flags, so an
edited source rebuilds. A failed build raises with the compiler's output:
there is no pure-Python stand-in.

Nothing here builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "frameloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Path of the built library for the current source (may not exist)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libframeloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``frameloader.cpp`` unless the library for this source
    exists. Returns its path; raises with g++'s output on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"tmp_{so.stem}_{os.getpid()}.so")
    out = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{out.stdout}")
    os.replace(tmp, so)             # atomic: concurrent builds agree
    return so


def library() -> ctypes.CDLL:
    """The loaded frame-pipe library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.fp_open.restype = ctypes.c_void_p
            lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_long, ctypes.c_int]
            lib.fp_get.restype = ctypes.c_int
            lib.fp_get.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p]
            lib.fp_put.restype = ctypes.c_int
            lib.fp_put.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p]
            lib.fp_flush.argtypes = [ctypes.c_void_p]
            lib.fp_stats.argtypes = [ctypes.c_void_p] + [
                ctypes.POINTER(ctypes.c_long)] * 3
            lib.fp_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class FramePipe:
    """Raw-frame streaming over ``<directory>/<idx:05d>.raw`` blobs of
    ``shape`` uint8: ``get`` serves read-ahead frames from the cache (a
    window of ``prefetch`` frames from the last one asked for) or reads
    the file; ``put`` queues a write and returns at once."""

    def __init__(self, directory: str, num_frames: int, shape,
                 prefetch: int = 8):
        self.dir = directory
        self.num_frames = num_frames
        self.shape = tuple(shape)
        self.nbytes = int(np.prod(self.shape))
        os.makedirs(directory, exist_ok=True)
        self._lib = library()
        self._handle = self._lib.fp_open(directory.encode(), num_frames,
                                         self.nbytes, prefetch)

    @staticmethod
    def _ptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def _open(self):
        if self._handle is None:
            raise ValueError(f"frame pipe on {self.dir} is closed")
        return self._handle

    def get(self, idx: int) -> np.ndarray:
        """Frame ``idx``; FileNotFoundError when its blob is missing."""
        out = np.empty(self.shape, np.uint8)
        rc = self._lib.fp_get(self._open(), idx, self._ptr(out))
        if rc != 0:
            raise FileNotFoundError(
                f"frame {idx} missing in {self.dir} (rc={rc})")
        return out

    def put(self, idx: int, frame: np.ndarray):
        """Queue frame ``idx`` for writing (the buffer is copied)."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.nbytes != self.nbytes:
            raise ValueError(f"frame of shape {frame.shape} into a pipe of "
                             f"{self.shape}")
        self._lib.fp_put(self._open(), idx, self._ptr(frame))

    def flush(self):
        """Wait until every queued frame is on disk."""
        self._lib.fp_flush(self._open())

    def stats(self):
        """{'reads', 'writes', 'cache_hits'}: frames read ahead, written,
        and gets served from the read-ahead cache."""
        r, w, h = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
        self._lib.fp_stats(self._open(), ctypes.byref(r), ctypes.byref(w),
                           ctypes.byref(h))
        return {"reads": r.value, "writes": w.value, "cache_hits": h.value}

    def close(self):
        """Stop both threads (the writer drains its queue first) and free
        the pipe."""
        if self._handle is not None:
            self._lib.fp_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
