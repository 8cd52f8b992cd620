"""ctypes binding for the native IO library (mirrors aladin_tpu/io/native.py).

The C++ fast path (``native/tsv_reader.cpp``, ``native/wordpiece.cpp``)
does seek + read + split + base64 -> float32 in one pass a row, and the
WordPiece tokenization of ASCII text, both without the GIL: ctypes releases
it for the length of a foreign call, so the loader's threads decode in
parallel.

The library is built at first use with ``g++`` from those two sources,
unchanged, into ``aladin_torch/_build/``, named by a hash of both sources
and the flags (as ``ops/kernels/build.py`` names the CUDA libraries), so an
edited source never loads a stale build. The compiler writes to a temporary
name that ``os.replace`` swaps in, so concurrent builds (several test
workers, several processes) never load a half-written file. Nothing is
written under ``native/`` and no library found there is loaded.
``available()`` is False when the build fails (no ``g++``); callers then
take the pure-Python path and say so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(ROOT, "native")
BUILD_DIR = os.path.join(ROOT, "aladin_torch", "_build")
SOURCES = ("tsv_reader.cpp", "wordpiece.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

logger = logging.getLogger("vlpretrain")


def library_path() -> str:
    """The library's path: a hash of both sources and the flags."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libaladin_io-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path. Raises when
    the sources or ``g++`` are missing or the compiler fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native IO library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(NATIVE_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCES} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return target


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as e:
        logger.warning("native IO library unavailable, the pure-Python reader and tokenizer "
                       "run instead: %s", e)
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.aladin_b64_decode.restype = i64
    lib.aladin_b64_decode.argtypes = [ctypes.c_char_p, i64, p, i64]
    lib.aladin_build_lineidx.restype = i64
    lib.aladin_build_lineidx.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.aladin_tsv_open.restype = p
    lib.aladin_tsv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.aladin_tsv_num_rows.restype = i64
    lib.aladin_tsv_num_rows.argtypes = [p]
    lib.aladin_tsv_close.argtypes = [p]
    lib.aladin_tsv_read_features.restype = i64
    lib.aladin_tsv_read_features.argtypes = [p, i64, p, i64, ctypes.POINTER(i64)]
    lib.aladin_wp_create.restype = p
    lib.aladin_wp_create.argtypes = [ctypes.c_char_p]
    lib.aladin_wp_destroy.argtypes = [p]
    lib.aladin_wp_encode.restype = i64
    lib.aladin_wp_encode.argtypes = [p, ctypes.c_char_p, i64, p, i64]
    return lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable (g++ could not build native/*.cpp)")
    return lib


class NativeFeatureReader:
    """Random-access region-feature reader over (features.tsv, .lineidx).

    Thread- and fork-safe: the C side reads with pread (no shared file
    position, thread-local scratch) and the float buffer here is
    thread-local, so one reader serves the loader's whole thread pool.
    """

    def __init__(self, tsv_path: str, max_floats: int = 200 * 2054):
        lib = _require()
        self._lib = lib
        idx_path = os.path.splitext(tsv_path)[0] + ".lineidx"
        if not os.path.exists(idx_path):
            if lib.aladin_build_lineidx(tsv_path.encode(), idx_path.encode()) < 0:
                raise IOError(f"failed to index {tsv_path}")
        self._h = lib.aladin_tsv_open(tsv_path.encode(), idx_path.encode())
        if not self._h:
            raise IOError(f"failed to open {tsv_path}")
        self._max_floats = max_floats
        self._tls = threading.local()

    def num_rows(self) -> int:
        return int(self._lib.aladin_tsv_num_rows(self._h))

    def read_features(self, idx: int) -> np.ndarray:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = np.empty(self._max_floats, np.float32)
        nb = ctypes.c_int64(0)
        n = self._lib.aladin_tsv_read_features(self._h, idx, buf.ctypes.data_as(ctypes.c_void_p),
                                               buf.size, ctypes.byref(nb))
        if n < 0:
            raise IOError(f"row {idx}: decode failed")
        return buf[:n].reshape(nb.value, -1).copy()

    def close(self) -> None:
        if self._h:
            self._lib.aladin_tsv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWordPiece:
    """ctypes handle on the C++ WordPiece tokenizer.

    ``encode(text, cap)`` returns the first ``cap`` ids of the exact
    sequence the Python tokenizer gives, or None when the text holds
    non-ASCII bytes: the caller then takes the Python tokenizer, so the ids
    are the same either way. Read-only after construction: one instance
    serves the loader's whole thread pool (each thread has its own buffer).
    """

    def __init__(self, vocab_path: str):
        lib = _require()
        self._lib = lib
        self._h = lib.aladin_wp_create(os.fsencode(vocab_path))
        if not self._h:
            raise IOError(f"failed to load vocab {vocab_path}")
        self._tls = threading.local()

    def encode(self, text: str, cap: int = 512) -> Optional[list]:
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.size < cap:
            buf = self._tls.buf = np.empty(max(cap, 512), np.int32)
        n = self._lib.aladin_wp_encode(self._h, raw, len(raw),
                                       buf.ctypes.data_as(ctypes.c_void_p), cap)
        if n < 0:
            return None
        return buf[:n].tolist()

    def close(self) -> None:
        if self._h:
            self._lib.aladin_wp_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def b64_decode_floats(b64: bytes) -> Optional[np.ndarray]:
    """float32 values of a base64 string, or None without the library or on
    invalid input."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(b64) * 3) // 4 // 4 + 4, np.float32)
    n = lib.aladin_b64_decode(b64, len(b64), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if n < 0:
        return None
    return out[: n // 4].copy()
