"""ctypes bindings for the native TSV count-matrix loader.

A copy of multimodalmusig_tpu/utils/fast_tsv.py that compiles
native/tsv_loader.cpp (g++ -O3 -shared) into this package's own git-ignored
build directory (native_build.py) on first use, leaving the JAX package's
library untouched, and falls back to a pure-Python parser when no C++
toolchain is available. The returned layout matches the reference's input
convention (README.md:7): rows = vocabulary terms, columns = samples.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

from ..native_build import build_shared_library

__all__ = ["read_counts_tsv", "native_available"]

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native", "tsv_loader.cpp"
)
_lock = threading.Lock()
_lib = None
_tried = False


def _build_and_load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(
                build_shared_library(
                    "tsv_loader", [_SRC], ["g++", "-O3", "-shared", "-fPIC"]
                )
            )
        except (OSError, RuntimeError):
            return None
        lib.tsv_parse.restype = ctypes.c_void_p
        lib.tsv_parse.argtypes = [ctypes.c_char_p]
        for fn in ("tsv_num_terms", "tsv_num_samples", "tsv_terms_bytes", "tsv_header_bytes"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.tsv_copy_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.tsv_copy_terms.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tsv_copy_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tsv_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def _read_native(path: str):
    lib = _build_and_load()
    h = lib.tsv_parse(path.encode())
    if not h:
        raise OSError(f"failed to parse {path!r}")
    try:
        V = lib.tsv_num_terms(h)
        D = lib.tsv_num_samples(h)
        counts = np.empty((V, D), dtype=np.float64)
        lib.tsv_copy_counts(h, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        tbytes = lib.tsv_terms_bytes(h)
        tbuf = ctypes.create_string_buffer(tbytes)
        lib.tsv_copy_terms(h, tbuf)
        terms = tbuf.raw[:tbytes].decode().split("\n") if tbytes else []
        hbytes = lib.tsv_header_bytes(h)
        hbuf = ctypes.create_string_buffer(hbytes)
        lib.tsv_copy_header(h, hbuf)
        samples = hbuf.raw[:hbytes].decode().split("\n") if hbytes else []
        return counts, terms, samples
    finally:
        lib.tsv_free(h)


def _read_python(path: str):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        samples = header[1:]
        terms: List[str] = []
        rows: List[np.ndarray] = []
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            terms.append(fields[0])
            rows.append(np.asarray(fields[1:], dtype=np.float64))
    counts = np.stack(rows) if rows else np.zeros((0, len(samples)))
    return counts, terms, samples


def read_counts_tsv(path: str, prefer_native: bool = True) -> Tuple[np.ndarray, List[str], List[str]]:
    """Parse a counts TSV -> (counts (V, D) float64, terms, sample ids).

    Uses the C++ loader when available; pure-Python fallback otherwise.
    """
    if prefer_native and native_available():
        return _read_native(path)
    return _read_python(path)
